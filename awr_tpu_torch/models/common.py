"""Shared model building blocks and the reference's initializers.

Convs use symmetric padding ``(k-1)//2``, as the reference's; BatchNorm
is ``BatchNorm2d(eps=1e-5, momentum=0.1)``, whose eval rule and
running-stat update are the reference's.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5
BN_MOMENTUM = 0.1


def conv2d(in_ch: int, out_ch: int, kernel: int, stride: int = 1,
           bias: bool = True) -> nn.Conv2d:
    return nn.Conv2d(in_ch, out_ch, kernel, stride, (kernel - 1) // 2,
                     bias=bias)


def batch_norm(ch: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(ch, eps=BN_EPS, momentum=BN_MOMENTUM)


def max_pool() -> nn.MaxPool2d:
    return nn.MaxPool2d(2, 2)


def max_pool_torch(kernel: int, stride: int, padding: int) -> nn.MaxPool2d:
    """``MaxPool2d(kernel, stride, padding)``: the padding is -inf, as the
    JAX package's ``max_pool_torch`` pads."""
    return nn.MaxPool2d(kernel, stride, padding)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """``nn.Upsample(scale_factor=2, mode='nearest')`` on NCHW."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def torch_default_init_(module: nn.Module,
                        generator: torch.Generator) -> nn.Module:
    """Re-draw every conv and transposed conv with PyTorch's default rule
    from ``generator``: weight and bias U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    (kaiming-uniform, a=sqrt(5)), ``fan_in = weight[0].numel()`` (out *
    kh * kw for a transposed conv, as its own ``reset_parameters``
    computes); BatchNorm to identity with fresh running stats."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                fan_in = m.weight[0].numel()
                bound = 1.0 / math.sqrt(fan_in)
                m.weight.uniform_(-bound, bound, generator=generator)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=generator)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
    return module


def he_fanout_normal_(weight: torch.Tensor,
                      generator: torch.Generator) -> torch.Tensor:
    """N(0, sqrt(2/n)), n = kh*kw*out_channels: the reference's encoder
    conv init (resnet_deconv.py:93-97); fan-OUT, not fan-in."""
    out_ch, _, kh, kw = weight.shape
    with torch.no_grad():
        return weight.normal_(0.0, math.sqrt(2.0 / (kh * kw * out_ch)),
                              generator=generator)


def normal_001_(weight: torch.Tensor,
                generator: torch.Generator) -> torch.Tensor:
    """N(0, 0.001): the reference's deconvs and prediction heads
    (resnet_deconv.py:103-115)."""
    with torch.no_grad():
        return weight.normal_(0.0, 0.001, generator=generator)
