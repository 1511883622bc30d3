"""Stacked Hourglass backbone (reference model/hourglass.py), NCHW.

Stem with overall stride 2 (Conv5 s1 + BN + ReLU, Residual(64,128),
Pool2, Residual(128,256), Residual(256,256)); per stack a recursive
depth-4 hourglass, a feature head (Residual + 1x1 Conv+BN+ReLU), the
3J offset and J heatmap 1x1 heads concatenated to 4J channels, and
between stacks the re-injection ``x + merge_preds(pred) +
merge_features(feature)``.  Residual blocks are pre-activation
(BN->ReLU->conv, three times) with a 1x1 skip only on a channel change.

Submodule names give ``state_dict()`` the reference's key layout
(``pre.0.conv.weight``, ``hgs.0.0.up1.bn1.weight``, ``outs_1.0.weight``,
``merge_preds.0.conv.conv.weight``, ...), so a reference ``.pth`` loads
directly (:func:`awr_tpu_torch.models.weights.load_reference_state_dict`).
"""

from __future__ import annotations

import torch
from torch import nn

from awr_tpu_torch.models.common import (batch_norm, conv2d, max_pool,
                                         rematerialized, torch_default_init_,
                                         upsample_nearest_2x)


class ConvBlock(nn.Module):
    """Conv (bias always on) (+BN) (+ReLU) (reference hourglass.py:6-25)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 stride: int = 1, bn: bool = False, relu: bool = True):
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
    """Pre-activation bottleneck residual (reference hourglass.py:28-59)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        half = out_ch // 2
        self.bn1 = batch_norm(in_ch)
        self.conv1 = ConvBlock(in_ch, half, 1, relu=False)
        self.bn2 = batch_norm(half)
        self.conv2 = ConvBlock(half, half, 3, relu=False)
        self.bn3 = batch_norm(half)
        self.conv3 = ConvBlock(half, out_ch, 1, relu=False)
        # the reference also builds a skip conv on identity residuals but
        # never runs it; it is left out here
        self.skip_layer = (ConvBlock(in_ch, out_ch, 1, relu=False)
                           if in_ch != out_ch else None)

    def forward(self, x):
        out = self.conv1(torch.relu(self.bn1(x)))
        out = self.conv2(torch.relu(self.bn2(out)))
        out = self.conv3(torch.relu(self.bn3(out)))
        skip = x if self.skip_layer is None else self.skip_layer(x)
        return out + skip


class HourglassBlock(nn.Module):
    """Recursive encoder-decoder of depth ``n`` (reference hourglass.py:62-88)."""

    def __init__(self, n: int, features: int, increase: int = 0):
        super().__init__()
        f, nf = features, features + increase
        self.up1 = Residual(f, f)
        self.pool1 = max_pool()
        self.low1 = Residual(f, nf)
        self.low2 = (HourglassBlock(n - 1, nf) if n > 1
                     else Residual(nf, nf))
        self.low3 = Residual(nf, f)

    def forward(self, x):
        low = self.low3(self.low2(self.low1(self.pool1(x))))
        return self.up1(x) + upsample_nearest_2x(low)


class PoseNet(nn.Module):
    """(B, 1, H, W) depth -> (S, B, 4J, H/2, W/2) per-stack dense maps."""

    def __init__(self, nstack: int = 1, joint_num: int = 14,
                 inp_dim: int = 256, increase: int = 0, remat: bool = False):
        super().__init__()
        self.nstack = nstack
        # recompute each stack's hourglass in the backward pass
        self.remat = remat
        self.pre = nn.Sequential(
            ConvBlock(1, 64, 5, 1, bn=True, relu=True),
            Residual(64, 128),
            max_pool(),
            Residual(128, 256),
            Residual(256, inp_dim),
        )
        self.hgs = nn.ModuleList(
            nn.Sequential(HourglassBlock(4, inp_dim, increase))
            for _ in range(nstack))
        self.features = nn.ModuleList(
            nn.Sequential(Residual(inp_dim, inp_dim),
                          ConvBlock(inp_dim, inp_dim, 1, bn=True, relu=True))
            for _ in range(nstack))
        self.outs_1 = nn.ModuleList(
            conv2d(inp_dim, joint_num * 3, 1) for _ in range(nstack))
        self.outs_2 = nn.ModuleList(
            conv2d(inp_dim, joint_num, 1) for _ in range(nstack))
        self.merge_preds = nn.ModuleList(
            Merge(joint_num * 4, inp_dim) for _ in range(nstack - 1))
        self.merge_features = nn.ModuleList(
            Merge(inp_dim, inp_dim) for _ in range(nstack - 1))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """PyTorch's default init (the reference's) from ``generator``."""
        torch_default_init_(self, generator)

    def forward(self, imgs):
        x = self.pre(imgs)
        preds = []
        for i in range(self.nstack):
            hg = (rematerialized(self.hgs[i], x) if self.remat
                  else self.hgs[i](x))
            feature = self.features[i](hg)
            pred = torch.cat([self.outs_1[i](feature),
                              self.outs_2[i](feature)], dim=1)
            preds.append(pred)
            if i < self.nstack - 1:
                x = (x + self.merge_preds[i](pred)
                     + self.merge_features[i](feature))
        return torch.stack(preds, dim=0)


class Merge(nn.Module):
    """1x1 conv of the inter-stack re-injection (the reference's ``Merge``)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = ConvBlock(in_ch, out_ch, 1, relu=False)

    def forward(self, x):
        return self.conv(x)
