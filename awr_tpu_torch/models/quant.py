"""Post-training int8 quantization of the serving path (the JAX package's
``models/quant.py``).

- **Weights**: symmetric per-output-channel int8, scales derived from the
  float32 weights at every forward (no separate weight checkpoint).
- **Activations**: symmetric per-tensor int8 with a static scale that a
  calibration pass records (running max over batches of the |x| maximum
  or |x| percentile, over 127).
- **Math**: exact int8 x int8 -> int32 products, dequantized by
  ``s_in * s_w[oc]`` (the product formed first, as the JAX package does).
  An int8 conv is im2col (``F.unfold`` on the float codes, which float32
  holds exactly) plus the int8 GEMM; an int8 transposed conv is the
  polyphase int8 deconv.  On a CUDA tensor both are the hand-written
  kernels (``ops/int8_cuda.py``), on a CPU tensor their plain versions
  (``ops/int8.py``).  BatchNorm, ReLU, pooling, residual adds and the
  prediction heads stay in float32.

:class:`QuantConv` and :class:`QuantConvTranspose` are ``nn.Conv2d`` and
``nn.ConvTranspose2d`` with a ``mode``: "off" (the float layer), "calib"
(the float layer, recording the input's amplitude) or "int8".  The
activation scale is a non-persistent buffer, so the ``state_dict`` keys
are the same in every mode and a reference checkpoint loads unchanged.
"""

from __future__ import annotations

from typing import Dict, Iterable

import torch
import torch.nn.functional as F
from torch import nn

from awr_tpu_torch.ops import int8 as int8_plain
from awr_tpu_torch.ops import int8_cuda

_QMAX = 127.0
MODES = ("off", "calib", "int8")


def _quantize_weights(weight: torch.Tensor, dims):
    """Symmetric per-output-channel int8 codes of ``weight``, reducing
    over ``dims`` (every dim but the output channel's).  Returns (float32
    codes, float32 scales with ``dims`` kept)."""
    w32 = weight.float()
    amax = w32.abs().amax(dim=dims, keepdim=True)
    scale = torch.clamp(amax / _QMAX, min=1e-12)
    return torch.clamp(torch.round(w32 / scale), -_QMAX, _QMAX), scale


def _quantize_acts(x: torch.Tensor, scale: torch.Tensor):
    """Symmetric per-tensor int8 codes of ``x`` with a calibrated scale.
    Returns (float32 codes, float32 scale)."""
    s = torch.clamp(scale, min=1e-12).float()
    return torch.clamp(torch.round(x.float() / s), -_QMAX, _QMAX), s


def _calib_amax(x: torch.Tensor, percentile: float) -> torch.Tensor:
    """|x| amplitude for calibration: the max, or with ``percentile`` <
    100 that percentile of |x| by linear interpolation, with the rank
    ``q * (n - 1)`` and the weights in float32 as ``jnp.percentile``
    forms them.  (A sort: ``torch.quantile`` refuses inputs above 2**24
    elements.)"""
    ax = x.detach().float().abs().reshape(-1)
    if percentile >= 100.0:
        return ax.max()
    q = torch.tensor(percentile, dtype=torch.float32) / 100.0
    n1 = torch.tensor(ax.numel() - 1, dtype=torch.float32)
    rank = q * n1
    low, high = torch.floor(rank), torch.ceil(rank)
    w_high = rank - low
    w_low = 1.0 - w_high
    s = torch.sort(ax).values
    lo = s[int(torch.clamp(low, 0, n1))]
    hi = s[int(torch.clamp(high, 0, n1))]
    return lo * w_low.to(ax.device) + hi * w_high.to(ax.device)


def _int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.device.type == "cuda":
        return int8_cuda.int8_matmul_cuda(a, b)
    return int8_plain.int8_matmul(a, b)


def _int8_deconv(xq, wq, scale) -> torch.Tensor:
    if xq.device.type == "cuda":
        return int8_cuda.deconv4x4s2_int8_cuda(xq, wq, scale)
    return int8_plain.deconv4x4s2_int8(xq, wq, scale)


def _to_int8(codes: torch.Tensor) -> torch.Tensor:
    """``codes`` (a view of float codes) as a new contiguous int8 tensor:
    the layout change and the narrowing in one pass."""
    return codes.to(torch.int8, memory_format=torch.contiguous_format)


class _QuantMixin:
    def _init_quant(self):
        self.mode = "off"
        self.calib_percentile = 100.0
        self.register_buffer("act_scale", torch.zeros(()), persistent=False)

    def _record(self, x: torch.Tensor) -> None:
        with torch.no_grad():
            amax = _calib_amax(x, self.calib_percentile)
            self.act_scale.copy_(torch.maximum(self.act_scale, amax / _QMAX))


class QuantConv(_QuantMixin, nn.Conv2d):
    """``nn.Conv2d`` with an int8 mode (the JAX ``QuantConv``)."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._init_quant()

    def forward(self, x):
        if self.mode == "calib":
            self._record(x)
        if self.mode != "int8":
            return super().forward(x)
        if self.groups != 1 or self.dilation != (1, 1) or \
                self.padding_mode != "zeros":
            raise NotImplementedError("int8 conv: groups, dilation and "
                                      "padding modes are not supported")
        B, _, H, W = x.shape
        kh, kw = self.kernel_size
        (sh, sw), (ph, pw) = self.stride, self.padding
        oh, ow = (H + 2 * ph - kh) // sh + 1, (W + 2 * pw - kw) // sw + 1
        N = self.out_channels
        xq, s_in = _quantize_acts(x, self.act_scale)
        wq, s_w = _quantize_weights(self.weight, (1, 2, 3))
        cols = F.unfold(xq, (kh, kw), padding=(ph, pw), stride=(sh, sw))
        a = _to_int8(cols.transpose(1, 2))  # (B, oh*ow, K)
        w8 = wq.to(torch.int8).reshape(N, -1)
        acc = _int8_matmul(a.view(B * oh * ow, -1), w8.t())
        y = acc.float() * (s_in * s_w.view(-1))
        # NCHW view of NHWC memory (channels_last): no transpose pass
        y = y.view(B, oh, ow, N).permute(0, 3, 1, 2)
        if self.bias is not None:
            y = y + self.bias.view(1, -1, 1, 1)
        return y


class QuantConvTranspose(_QuantMixin, nn.ConvTranspose2d):
    """``nn.ConvTranspose2d(k4, s2, p1)`` with an int8 mode (the JAX
    ``QuantConvTranspose``)."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._init_quant()

    def forward(self, x, output_size=None):
        if self.mode == "calib":
            self._record(x)
        if self.mode != "int8":
            return super().forward(x, output_size)
        if (self.kernel_size != (4, 4) or self.stride != (2, 2)
                or self.padding != (1, 1) or self.output_padding != (0, 0)
                or self.groups != 1 or self.dilation != (1, 1)
                or self.bias is not None or output_size is not None):
            raise NotImplementedError("int8 transposed conv: only "
                                      "ConvTranspose2d(k4, s2, p1, "
                                      "bias=False)")
        xq, s_in = _quantize_acts(x, self.act_scale)
        wq, s_w = _quantize_weights(self.weight, (0, 2, 3))
        x8 = _to_int8(xq.permute(0, 2, 3, 1))  # NHWC
        return _int8_deconv(x8, wq.to(torch.int8), s_in * s_w.view(-1))


def quant_layers(model: nn.Module) -> Dict[str, nn.Module]:
    """Every quantizable layer of ``model`` by its module name."""
    return {n: m for n, m in model.named_modules()
            if isinstance(m, (QuantConv, QuantConvTranspose))}


def set_quant_mode(model: nn.Module, mode: str) -> nn.Module:
    if mode not in MODES:
        raise ValueError(f"unknown quant mode {mode!r}; one of {MODES}")
    for m in quant_layers(model).values():
        m.mode = mode
    return model


def set_int8(model: nn.Module, scales: Dict[str, torch.Tensor]) -> nn.Module:
    """Load ``scales`` (one for every quantizable layer, by module name)
    and switch every layer to int8."""
    layers = quant_layers(model)
    if set(scales) != set(layers):
        raise KeyError(f"scales do not fit the model: missing "
                       f"{sorted(set(layers) - set(scales))[:5]}, "
                       f"unexpected {sorted(set(scales) - set(layers))[:5]}")
    with torch.no_grad():
        for name, m in layers.items():
            m.act_scale.copy_(torch.as_tensor(scales[name]))
    return set_quant_mode(model, "int8")


@torch.no_grad()
def calibrate(model: nn.Module, batches: Iterable[torch.Tensor],
              percentile: float = 100.0) -> Dict[str, torch.Tensor]:
    """Run (B, S, S) normalized depth batches through ``model`` (eval
    mode, float forward) and return each layer's activation scale: the
    running max over batches of the |x| amplitude / 127, the amplitude
    being the batch max or, with ``percentile`` < 100, that |x|
    percentile of the batch.  The model is left in mode "off", its
    buffers holding the scales."""
    layers = quant_layers(model)
    if not layers:
        raise ValueError(f"{type(model).__name__} has no quantizable layer")
    was_training = model.training
    model.eval()
    for m in layers.values():
        m.act_scale.zero_()
        m.calib_percentile = float(percentile)
    set_quant_mode(model, "calib")
    try:
        for img in batches:
            model(img[:, None])
    finally:
        set_quant_mode(model, "off")
        model.train(was_training)
    return {n: m.act_scale.clone() for n, m in layers.items()}
