"""Shared model building blocks and the reference's initializers.

Convs use symmetric padding ``(k-1)//2``, as the reference's; BatchNorm
is ``BatchNorm2d(eps=1e-5, momentum=0.1)``, whose eval rule and
running-stat update are the reference's.

Compute dtype (the JAX package's module ``dtype``): every conv and
transposed conv is a :class:`Conv2d` / :class:`ConvTranspose2d` whose
``compute_dtype`` (None: its weight's dtype) its input, weight and bias
are cast to; the parameters stay as they are (float32).  BatchNorm
takes the conv's output as it comes and returns it in that dtype, its
statistics and affine parameters float32 (under bfloat16 it normalizes
in float32, as the JAX package's ``TorchBatchNorm``).
:func:`set_compute_dtype` sets the dtype of a whole model.
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


class ComputeDtype:
    """A module that runs in ``compute_dtype`` (None: its parameters')."""

    compute_dtype = None

    def _cast(self, *ts):
        dt = self.compute_dtype
        return [t if t is None or dt is None else t.to(dt) for t in ts]


class Conv2d(ComputeDtype, nn.Conv2d):
    """``nn.Conv2d`` in ``compute_dtype``; the same parameters."""

    def forward(self, x):
        return self._conv_forward(*self._cast(x, self.weight, self.bias))


class ConvTranspose2d(ComputeDtype, nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` in ``compute_dtype``; the same parameters."""

    def forward(self, x, output_size=None):
        x, weight, bias = self._cast(x, self.weight, self.bias)
        output_padding = self._output_padding(
            x, output_size, self.stride, self.padding, self.kernel_size, 2,
            self.dilation)
        return F.conv_transpose2d(x, weight, bias, self.stride, self.padding,
                                  output_padding, self.groups, self.dilation)


def set_compute_dtype(model: nn.Module, dtype) -> nn.Module:
    """Run every conv, transposed conv and backbone of ``model`` in
    ``dtype`` (a ``torch.dtype``, or None for the parameters' dtype)."""
    for m in model.modules():
        if isinstance(m, ComputeDtype):
            m.compute_dtype = dtype
    return model


def map_out(x: torch.Tensor, dtype) -> torch.Tensor:
    """A backbone's dense map as it leaves the model: float32 under a
    compute dtype (the JAX package's ``pred.astype(jnp.float32)``), so
    the decode and the loss take float32; else as computed.  Contiguous
    either way: an int8 conv returns an NCHW view of channels-last
    memory, the heads after it keep that layout, and the CUDA decode
    takes a contiguous map only."""
    return (x if dtype is None else x.float()).contiguous()


def conv2d(in_ch: int, out_ch: int, kernel: int, stride: int = 1,
           bias: bool = True) -> Conv2d:
    return Conv2d(in_ch, out_ch, kernel, stride, (kernel - 1) // 2,
                  bias=bias)


def batch_norm(ch: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(ch, eps=BN_EPS, momentum=BN_MOMENTUM)


class GlobalBatchNorm2d(nn.BatchNorm2d):
    """``BatchNorm2d`` whose train-mode statistics are those of the
    global batch over the ``torch.distributed`` process group: what the
    JAX package's ``TorchBatchNorm`` computes on a batch sharded over a
    mesh.

    The two-pass mean and biased variance over the global N*H*W, in the
    input's dtype promoted to at least float32 (float64 in the parity
    tests); the running statistics updated with ``momentum`` and the
    running variance with Bessel's factor n/(n-1) on the global n, so
    they stay equal on every rank.  The sums cross the ranks through
    ``torch.distributed.nn.functional.all_reduce``, which is
    differentiable: the statistics' share of the input gradient comes
    back from every rank (the in-place ``torch.distributed.all_reduce``
    would drop it).  Two collectives forward, two backward.  Eval mode
    is ``BatchNorm2d``'s, pointwise, with no collective.

    ``nn.SyncBatchNorm`` computes the same on CUDA tensors only, with a
    one-pass variance; this one runs under gloo on the CPU too."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        from torch.distributed.nn.functional import all_reduce

        self._check_input_dim(x)
        ch = x.shape[1]
        xs = x.to(torch.promote_types(x.dtype, torch.float32))
        # the local sums and the local count, summed over the ranks
        total = all_reduce(torch.cat([xs.sum((0, 2, 3)),
                                      xs.new_full((1,), x.numel() // ch)]))
        n = total[ch]
        mean = total[:ch] / n
        centered = xs - mean[None, :, None, None]
        var = all_reduce((centered * centered).sum((0, 2, 3))) / n
        with torch.no_grad():
            self.num_batches_tracked.add_(1)
            m = self.momentum
            unbiased = var * (n / torch.clamp(n - 1, min=1))
            for buf, new in ((self.running_mean, mean),
                             (self.running_var, unbiased)):
                buf.copy_(m * new.to(buf.dtype) + (1 - m) * buf)
        y = centered * torch.rsqrt(var + self.eps)[None, :, None, None]
        y = y * self.weight[None, :, None, None] + self.bias[
            None, :, None, None]
        return y.to(x.dtype)


def global_batch_norm(module: nn.Module) -> nn.Module:
    """Replace every ``BatchNorm2d`` inside ``module`` by a
    :class:`GlobalBatchNorm2d` that holds the same parameters and
    buffers (the same tensors, so an optimizer built before keeps them).
    Returns ``module``."""
    for name, child in module.named_children():
        if type(child) is nn.BatchNorm2d:
            bn = GlobalBatchNorm2d(child.num_features, child.eps,
                                   child.momentum)
            for key in ("weight", "bias", "running_mean", "running_var",
                        "num_batches_tracked"):
                setattr(bn, key, getattr(child, key))
            bn.train(child.training)
            setattr(module, name, bn)
        else:
            global_batch_norm(child)
    return module


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
