"""Wrapper of the hand-written CUDA encode kernel (``csrc/encode.cu``).

The kernel's library is built and loaded at the first call
(:mod:`awr_tpu_torch.kernels`), so this module imports without a GPU or
``nvcc``.  Its plain version is
:func:`awr_tpu_torch.ops.functional.joint2offset`.
"""

from __future__ import annotations

import torch

from awr_tpu_torch import kernels
from awr_tpu_torch.kernels import FLOAT, INT, PTR

# jt, img, out, B, J, F, H, W, kernel_size, stream
_ENCODE = (PTR,) * 3 + (INT,) * 5 + (FLOAT, PTR)


def joint2offset_cuda(jt_uvd: torch.Tensor, img: torch.Tensor,
                      kernel_size: float, feature_size: int) -> torch.Tensor:
    """(B, J, 3) float32 joints + (B, H, W) float32 depth, both contiguous
    on one CUDA device -> (B, 4J, F, F) float32 GT field."""
    if jt_uvd.dtype != torch.float32 or img.dtype != torch.float32:
        raise TypeError(f"encode kernel takes float32 joints and depth, got "
                        f"{jt_uvd.dtype} and {img.dtype}")
    if (jt_uvd.dim() != 3 or jt_uvd.shape[2] != 3 or jt_uvd.numel() == 0
            or img.dim() != 3 or img.shape[0] != jt_uvd.shape[0]
            or img.numel() == 0 or feature_size < 1):
        raise ValueError(f"encode kernel takes non-empty (B, J, 3) and "
                         f"(B, H, W) and F >= 1, got {tuple(jt_uvd.shape)}, "
                         f"{tuple(img.shape)} and F = {feature_size}")
    if not (jt_uvd.is_contiguous() and img.is_contiguous()):
        raise ValueError("encode kernel takes contiguous tensors")
    if jt_uvd.device.type != "cuda" or img.device != jt_uvd.device:
        raise ValueError(f"encode kernel needs both tensors on one CUDA "
                         f"device, got {jt_uvd.device} and {img.device}")
    B, J, _ = jt_uvd.shape
    H, W = img.shape[1:]
    F = int(feature_size)
    out = torch.empty((B, 4 * J, F, F), dtype=torch.float32,
                      device=jt_uvd.device)
    kernels.launch("encode", kernels.bind("encode", "awr_encode_f32", _ENCODE),
                   jt_uvd.device, jt_uvd.data_ptr(), img.data_ptr(),
                   out.data_ptr(), B, J, F, H, W, float(kernel_size))
    return out
