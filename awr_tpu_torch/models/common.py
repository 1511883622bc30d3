"""Shared model building blocks and the reference's initializers.

Convs use symmetric padding ``(k-1)//2``, as the reference's; BatchNorm
is ``BatchNorm2d(eps=1e-5, momentum=0.1)``, whose eval rule and
running-stat update are the reference's.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

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


@contextlib.contextmanager
def _batch_stats_frozen(module: nn.Module):
    """Train-mode BatchNorm inside ``module`` normalizes with the batch's
    statistics and leaves ``running_mean``, ``running_var`` and
    ``num_batches_tracked`` as they were.  The BatchNorm calls stay the
    same calls (momentum 0 makes the running update ``1 * old + 0 * new``,
    exact), so they save the same tensors for the backward as the forward
    that the checkpoint recomputes."""
    bns = [m for m in module.modules()
           if isinstance(m, nn.BatchNorm2d) and m.track_running_stats]
    momenta = [m.momentum for m in bns]
    for m in bns:
        m.momentum = 0.0
    try:
        yield
    finally:
        for m, momentum in zip(bns, momenta):
            m.momentum = momentum
            m.num_batches_tracked.sub_(1)


def rematerialized(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``module(x)`` whose inner activations are recomputed in the
    backward pass instead of stored (the JAX package's ``nn.remat``).

    The recompute reruns train-mode BatchNorm; it runs with the running
    statistics frozen, so they update once a step, as without remat (the
    JAX package's functional ``batch_stats`` update once by
    construction).  Outside training, or without autograd, this is
    ``module(x)``."""
    if not (module.training and torch.is_grad_enabled()):
        return module(x)
    return checkpoint(module, x, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          _batch_stats_frozen(module)))


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
