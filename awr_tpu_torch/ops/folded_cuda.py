"""Wrappers of the bf16 inference form's hand-written CUDA kernels
(``csrc/folded.cu``): the passes between the convs of
:mod:`awr_tpu_torch.models.inference`.

The kernels' library is built and loaded at the first call
(:mod:`awr_tpu_torch.kernels`), so this module imports without a GPU or
``nvcc``.  Their plain versions are in :mod:`awr_tpu_torch.ops.folded`;
every path reaches both through the ops of
:mod:`awr_tpu_torch.ops.library`.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from awr_tpu_torch import kernels
from awr_tpu_torch.kernels import I64, INT, PTR

# channels a thread of bias_relu takes at once (kVec of csrc/folded.cu);
# kTile + 1 floats a channel of head_out's tile in 48 KB of shared memory
VEC = 8
HEAD_MAX_CHANNELS = 184
# the stem the kernel computes: 5x5 taps (pad 2) into 64 channels
STEM_SHAPE = (64, 1, 5, 5)

# y, bias, z (or NULL), numel, C, SMs, stream
_BIAS_RELU = (PTR,) * 3 + (I64, INT, INT, PTR)
# x, w, bias, out, B, H, W, stream
_STEM_POOL = (PTR,) * 4 + (INT,) * 3 + (PTR,)
# y, bias, out, B, P, C, stream
_HEAD_OUT = (PTR,) * 3 + (INT,) * 3 + (PTR,)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(y: torch.Tensor, bias: torch.Tensor) -> None:
    if y.dtype != torch.bfloat16 or bias.dtype != torch.float32:
        raise TypeError(f"epilogue kernel takes a bfloat16 tensor and a "
                        f"float32 bias, got {y.dtype} and {bias.dtype}")
    if (y.dim() != 4 or y.numel() == 0
            or tuple(bias.shape) != (y.shape[1],)):
        raise ValueError(f"epilogue kernel takes a non-empty (B, C, H, W) "
                         f"tensor and a (C,) bias, got {tuple(y.shape)} "
                         f"and {tuple(bias.shape)}")
    if not (y.is_contiguous(memory_format=torch.channels_last)
            and bias.is_contiguous() and y.data_ptr() % 16 == 0):
        raise ValueError("epilogue kernel takes a 16-byte aligned "
                         "channels-last tensor and a contiguous bias")
    if y.device.type != "cuda" or bias.device != y.device:
        raise ValueError(f"epilogue kernel needs both tensors on one CUDA "
                         f"device, got {y.device} and {bias.device}")


def bias_relu_cuda(y: torch.Tensor, bias: torch.Tensor,
                   residual: Optional[torch.Tensor] = None) -> None:
    """relu(y + bias + residual) in place on a channels-last bfloat16
    (B, C, H, W) ``y``, C % 8 == 0, with a float32 (C,) ``bias`` and a
    ``residual`` of ``y``'s shape, dtype and strides, or none: float32
    sums, one rounding."""
    _check(y, bias)
    if y.shape[1] % VEC:
        raise ValueError(f"bias_relu kernel takes C % {VEC} == 0, got "
                         f"C = {y.shape[1]}")
    if residual is not None and (
            residual.shape != y.shape or residual.dtype != y.dtype
            or residual.device != y.device or residual.stride() != y.stride()
            or residual.data_ptr() % 16):
        raise ValueError("bias_relu kernel takes a residual of y's shape, "
                         "dtype, device and strides, 16-byte aligned")
    kernels.launch(
        "bias_relu", kernels.bind("folded", "awr_bias_relu_bf16", _BIAS_RELU),
        y.device, y.data_ptr(), bias.data_ptr(),
        None if residual is None else residual.data_ptr(), y.numel(),
        y.shape[1], _sms(y.device.index))


def head_out_cuda(y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """A channels-last bfloat16 (B, C, H, W) ``y``, C <= 184, + a float32
    (C,) ``bias`` -> a new contiguous float32 (B, C, H, W) tensor."""
    _check(y, bias)
    B, C, H, W = y.shape
    if C > HEAD_MAX_CHANNELS:
        raise ValueError(f"head_out kernel takes at most "
                         f"{HEAD_MAX_CHANNELS} channels, got {C}")
    out = torch.empty(y.shape, dtype=bias.dtype, device=y.device)
    kernels.launch(
        "head_out", kernels.bind("folded", "awr_head_out_bf16", _HEAD_OUT),
        y.device, y.data_ptr(), bias.data_ptr(), out.data_ptr(), B, H * W,
        C)
    return out


def stem_pool_cuda(x: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor) -> torch.Tensor:
    """Contiguous float32 (B, 1, H, W) depth, bfloat16 (64, 1, 5, 5)
    ``weight``, float32 (64,) ``bias`` -> max_pool(relu(conv(x, weight,
    pad 2) + bias), 3, stride 2, pad 1), (B, 64, ceil(H/2), ceil(W/2))
    bfloat16 channels-last."""
    if (x.dtype != torch.float32 or weight.dtype != torch.bfloat16
            or bias.dtype != torch.float32):
        raise TypeError(f"stem_pool kernel takes float32 depth, bfloat16 "
                        f"weights and a float32 bias, got {x.dtype}, "
                        f"{weight.dtype} and {bias.dtype}")
    if (x.dim() != 4 or x.shape[1] != 1 or x.numel() == 0
            or tuple(weight.shape) != STEM_SHAPE
            or tuple(bias.shape) != STEM_SHAPE[:1]):
        raise ValueError(f"stem_pool kernel takes non-empty (B, 1, H, W) "
                         f"depth, {STEM_SHAPE} weights and a (64,) bias, "
                         f"got {tuple(x.shape)}, {tuple(weight.shape)} and "
                         f"{tuple(bias.shape)}")
    if not (x.is_contiguous() and weight.is_contiguous()
            and bias.is_contiguous()):
        raise ValueError("stem_pool kernel takes contiguous tensors")
    if x.device.type != "cuda" or {weight.device, bias.device} != {x.device}:
        raise ValueError(f"stem_pool kernel needs its tensors on one CUDA "
                         f"device, got {x.device}, {weight.device} and "
                         f"{bias.device}")
    B, _, H, W = x.shape
    C = STEM_SHAPE[0]
    out = torch.empty((B, (H + 1) // 2, (W + 1) // 2, C),
                      dtype=weight.dtype, device=x.device)
    kernels.launch(
        "stem_pool", kernels.bind("folded", "awr_stem_pool_bf16", _STEM_POOL),
        x.device, x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        out.data_ptr(), B, H, W)
    return out.permute(0, 3, 1, 2)
