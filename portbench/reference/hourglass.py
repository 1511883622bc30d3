"""The stacked hourglass in plain PyTorch, float32 (reference
model/hourglass.py), NCHW: ``arch`` "hourglass" of a configuration file.

Its identity residuals hold no ``skip_layer`` (the reference builds one
and never runs it).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.models import batch_norm, conv2d


class ConvBlock(nn.Module):
    """Conv (with bias) (+BN) (+ReLU) (reference hourglass.py:6-25)."""

    def __init__(self, in_ch, out_ch, kernel=3, stride=1, bn=False,
                 relu=True):
        super().__init__()
        self.conv = conv2d(in_ch, out_ch, kernel, stride)
        self.bn = batch_norm(out_ch) if bn else None
        self.relu = relu

    def forward(self, x):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return torch.relu(x) if self.relu else x


class Residual(nn.Module):
    """Pre-activation bottleneck (reference hourglass.py:28-59)."""

    def __init__(self, in_ch, out_ch):
        super().__init__()
        half = out_ch // 2
        self.bn1 = batch_norm(in_ch)
        self.conv1 = ConvBlock(in_ch, half, 1, relu=False)
        self.bn2 = batch_norm(half)
        self.conv2 = ConvBlock(half, half, 3, relu=False)
        self.bn3 = batch_norm(half)
        self.conv3 = ConvBlock(half, out_ch, 1, relu=False)
        self.skip_layer = (ConvBlock(in_ch, out_ch, 1, relu=False)
                           if in_ch != out_ch else None)

    def forward(self, x):
        out = self.conv1(torch.relu(self.bn1(x)))
        out = self.conv2(torch.relu(self.bn2(out)))
        out = self.conv3(torch.relu(self.bn3(out)))
        skip = x if self.skip_layer is None else self.skip_layer(x)
        return out + skip


class HourglassBlock(nn.Module):
    """Recursive encoder-decoder of depth ``n`` (reference
    hourglass.py:62-88)."""

    def __init__(self, n, f):
        super().__init__()
        self.up1 = Residual(f, f)
        self.low1 = Residual(f, f)
        self.low2 = HourglassBlock(n - 1, f) if n > 1 else Residual(f, f)
        self.low3 = Residual(f, f)

    def forward(self, x):
        low = self.low3(self.low2(self.low1(F.max_pool2d(x, 2, 2))))
        return self.up1(x) + F.interpolate(low, scale_factor=2,
                                           mode="nearest")


class Merge(nn.Module):
    def __init__(self, in_ch, out_ch):
        super().__init__()
        self.conv = ConvBlock(in_ch, out_ch, 1, relu=False)

    def forward(self, x):
        return self.conv(x)


class PoseNet(nn.Module):
    """(B, 1, H, W) depth -> (S, B, 4J, H/2, W/2) per-stack dense maps
    (reference hourglass.py:105-165)."""

    def __init__(self, nstack=1, joint_num=14, inp_dim=256, depth=4):
        super().__init__()
        self.nstack = nstack
        self.pre = nn.Sequential(
            ConvBlock(1, 64, 5, 1, bn=True, relu=True),
            Residual(64, 128),
            nn.MaxPool2d(2, 2),
            Residual(128, 256),
            Residual(256, inp_dim))
        self.hgs = nn.ModuleList(
            nn.Sequential(HourglassBlock(depth, inp_dim))
            for _ in range(nstack))
        self.features = nn.ModuleList(
            nn.Sequential(Residual(inp_dim, inp_dim),
                          ConvBlock(inp_dim, inp_dim, 1, bn=True, relu=True))
            for _ in range(nstack))
        self.outs_1 = nn.ModuleList(conv2d(inp_dim, joint_num * 3, 1)
                                    for _ in range(nstack))
        self.outs_2 = nn.ModuleList(conv2d(inp_dim, joint_num, 1)
                                    for _ in range(nstack))
        self.merge_preds = nn.ModuleList(Merge(joint_num * 4, inp_dim)
                                         for _ in range(nstack - 1))
        self.merge_features = nn.ModuleList(Merge(inp_dim, inp_dim)
                                            for _ in range(nstack - 1))

    def forward(self, imgs):
        x = self.pre(imgs)
        preds = []
        for i in range(self.nstack):
            feature = self.features[i](self.hgs[i](x))
            pred = torch.cat([self.outs_1[i](feature),
                              self.outs_2[i](feature)], dim=1)
            preds.append(pred)
            if i < self.nstack - 1:
                x = (x + self.merge_preds[i](pred)
                     + self.merge_features[i](feature))
        return torch.stack(preds, dim=0)


def build(config: dict) -> PoseNet:
    return PoseNet(config["nstack"], config["joint_num"], config["inp_dim"],
                   config["hourglass_depth"])


def heads(model: PoseNet):
    """The (offset, heatmap) head convs of the last stack."""
    return model.outs_1[-1], model.outs_2[-1]
