"""The ResNet-deconv in plain PyTorch, float32 (reference
model/resnet_deconv.py), NCHW: ``arch`` "resnet_deconv" of a
configuration file, with BasicBlock stages (``block`` "basic") of the
file's ``blocks`` and ``stage_channels`` and its ``deconv_channels``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from portbench.reference.models import batch_norm, conv2d


class BasicBlock(nn.Module):
    """3x3 + 3x3 residual block (reference resnet_deconv.py:145-174)."""

    def __init__(self, in_ch, planes, stride=1):
        super().__init__()
        self.conv1 = conv2d(in_ch, planes, 3, stride, bias=False)
        self.bn1 = batch_norm(planes)
        self.conv2 = conv2d(planes, planes, 3, bias=False)
        self.bn2 = batch_norm(planes)
        self.downsample = None
        if stride != 1 or in_ch != planes:
            self.downsample = nn.Sequential(
                conv2d(in_ch, planes, 1, stride, bias=False),
                batch_norm(planes))

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + residual)


class ResNetDeconv(nn.Module):
    """(B, 1, H, W) depth -> (B, 4J, H/ds, W/ds) dense map, BasicBlock
    stages (reference resnet_deconv.py:8-136)."""

    def __init__(self, joint_num=14, layers=(2, 2, 2, 2), downsample=2,
                 stage_channels=(64, 128, 256, 512), deconv_channels=256):
        super().__init__()
        # the stem is as wide as the first stage
        in_ch = stage_channels[0]
        self.pre = nn.Sequential(conv2d(1, in_ch, 5, bias=False),
                                 batch_norm(in_ch), nn.ReLU(),
                                 nn.MaxPool2d(3, 2, 1))
        for stage, (planes, blocks, stride) in enumerate(
                zip(stage_channels, layers, (1, 2, 2, 2)), start=1):
            stack = []
            for i in range(blocks):
                stack.append(BasicBlock(in_ch, planes, stride if i == 0
                                        else 1))
                in_ch = planes
            setattr(self, f"layer{stage}", nn.Sequential(*stack))
        deconv = []
        for _ in range(4 - int(math.log2(downsample))):
            deconv += [nn.ConvTranspose2d(in_ch, deconv_channels, 4, 2, 1,
                                          bias=False),
                       batch_norm(deconv_channels), nn.ReLU()]
            in_ch = deconv_channels
        self.deconv_layers = nn.Sequential(*deconv)
        self.final1 = nn.Conv2d(in_ch, joint_num * 3, 1)
        self.final2 = nn.Conv2d(in_ch, joint_num, 1)

    def forward(self, x):
        x = self.pre(x)
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = stage(x)
        x = self.deconv_layers(x)
        return torch.cat([self.final1(x), self.final2(x)], dim=1)


def build(config: dict) -> ResNetDeconv:
    if config["block"] != "basic":
        raise ValueError(f"no reference for block {config['block']!r}")
    return ResNetDeconv(config["joint_num"], tuple(config["blocks"]),
                        config["downsample"], tuple(config["stage_channels"]),
                        config["deconv_channels"])


def heads(model: ResNetDeconv):
    """The (offset, heatmap) head convs."""
    return model.final1, model.final2
