"""ResNet encoder + deconv decoder emitting dense 4J-channel AWR maps
(reference model/resnet_deconv.py; the JAX package's ``models/resnet.py``),
NCHW.

A depth-1-channel ResNet {18: Basic [2, 2, 2, 2], 50/101/152:
Bottleneck}: a 5x5 stride-1 stem + BN + ReLU + 3x3 stride-2 maxpool,
stages at strides (1, 2, 2, 2) to /32, then ``4 - log2(downsample)`` x
[ConvTranspose2d(k4, s2, p1, 256 ch, no bias), BN, ReLU] back to
/downsample, and two 1x1 heads (3J offset vectors, J heatmaps)
concatenated to 4J channels.  The encoder convs and the deconvs are
:class:`~awr_tpu_torch.models.quant.QuantConv` /
:class:`~awr_tpu_torch.models.quant.QuantConvTranspose` (float layers
until a Predictor is quantized); the heads stay float.  Under a compute
dtype every layer runs in it and the map leaves as float32.

Submodule names give ``state_dict()`` the reference's key layout
(``pre.0``, ``layer1.0.conv1``, ``layer2.0.downsample.0``,
``deconv_layers.3``, ``final1``, ...).  Inits as the reference's: He
fan-out normal for the encoder convs, N(0, 0.001) for the deconvs and
heads, zero head bias.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from awr_tpu_torch.models.common import (ComputeDtype, Conv2d, batch_norm,
                                         he_fanout_normal_, map_out,
                                         max_pool_torch, normal_001_,
                                         rematerialized)
from awr_tpu_torch.models.quant import QuantConv, QuantConvTranspose

# depth -> (block kind, blocks per stage) (reference resnet_deconv.py:9-13)
RESNET_SPECS = {
    18: ("basic", (2, 2, 2, 2)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}


def _conv(in_ch: int, out_ch: int, kernel: int, stride: int = 1) -> QuantConv:
    return QuantConv(in_ch, out_ch, kernel, stride, (kernel - 1) // 2,
                     bias=False)


def _downsample(in_ch: int, out_ch: int, stride: int):
    if stride == 1 and in_ch == out_ch:
        return None
    return nn.Sequential(_conv(in_ch, out_ch, 1, stride), batch_norm(out_ch))


class BasicBlock(nn.Module):
    """3x3 + 3x3 residual block (reference resnet_deconv.py:145-174)."""

    expansion = 1

    def __init__(self, in_ch: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(in_ch, planes, 3, stride)
        self.bn1 = batch_norm(planes)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = batch_norm(planes)
        self.downsample = _downsample(in_ch, planes, stride)

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + residual)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 (x4) residual block (reference
    resnet_deconv.py:177-215)."""

    expansion = 4

    def __init__(self, in_ch: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(in_ch, planes, 1)
        self.bn1 = batch_norm(planes)
        self.conv2 = _conv(planes, planes, 3, stride)
        self.bn2 = batch_norm(planes)
        self.conv3 = _conv(planes, planes * 4, 1)
        self.bn3 = batch_norm(planes * 4)
        self.downsample = _downsample(in_ch, planes * 4, stride)

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + residual)


class ResNetDeconv(ComputeDtype, nn.Module):
    """(B, 1, H, W) depth -> (B, 4J, H/ds, W/ds) dense map."""

    def __init__(self, joint_num: int = 14, block: str = "basic",
                 layers: Sequence[int] = (2, 2, 2, 2), downsample: int = 2,
                 generator: Optional[torch.Generator] = None,
                 remat: bool = False):
        super().__init__()
        if downsample not in (1, 2, 4):
            raise ValueError(f"downsample must be 1, 2 or 4, got {downsample}")
        block_cls = BasicBlock if block == "basic" else Bottleneck
        self.downsample = downsample
        # recompute each residual block in the backward pass
        self.remat = remat
        self.pre = nn.Sequential(_conv(1, 64, 5), batch_norm(64), nn.ReLU(),
                                 max_pool_torch(3, 2, 1))
        in_ch = 64
        for stage, (planes, blocks, stride) in enumerate(
                zip((64, 128, 256, 512), layers, (1, 2, 2, 2)), start=1):
            stack = []
            for i in range(blocks):
                stack.append(block_cls(in_ch, planes, stride if i == 0 else 1))
                in_ch = planes * block_cls.expansion
            setattr(self, f"layer{stage}", nn.Sequential(*stack))
        deconv = []
        for _ in range(4 - int(math.log2(downsample))):
            deconv += [QuantConvTranspose(in_ch, 256, 4, 2, 1, bias=False),
                       batch_norm(256), nn.ReLU()]
            in_ch = 256
        self.deconv_layers = nn.Sequential(*deconv)
        self.final1 = Conv2d(in_ch, joint_num * 3, 1)
        self.final2 = Conv2d(in_ch, joint_num, 1)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The reference's inits (resnet_deconv.py:93-115) from
        ``generator`` (the global generator if None)."""
        heads = (self.final1, self.final2)
        for m in self.modules():
            if isinstance(m, QuantConv):
                he_fanout_normal_(m.weight, generator)
            elif isinstance(m, QuantConvTranspose) or m in heads:
                normal_001_(m.weight, generator)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
        with torch.no_grad():
            for m in heads:
                m.bias.zero_()

    def forward(self, x):
        (x,) = self._cast(x)
        x = self.pre(x)
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            for block in stage:
                x = rematerialized(block, x) if self.remat else block(x)
        x = self.deconv_layers(x)
        return map_out(torch.cat([self.final1(x), self.final2(x)], dim=1),
                       self.compute_dtype)


def get_deconv_net(layers: int, joint_num: int, downsample: int,
                   generator: Optional[torch.Generator] = None,
                   remat: bool = False) -> ResNetDeconv:
    """Factory matching reference resnet_deconv.py:8-16."""
    if layers not in RESNET_SPECS:
        raise ValueError(f"resnet depth must be one of {sorted(RESNET_SPECS)},"
                         f" got {layers}")
    block, sizes = RESNET_SPECS[layers]
    return ResNetDeconv(joint_num, block, sizes, downsample, generator, remat)
