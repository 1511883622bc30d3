"""Plain PyTorch versions of the int8 kernels (``csrc/int8.cu``): exact
integer math spelled in float64.

CPU torch has no int8 conv or int8 matmul.  A sum of int8 products is an
integer far below 2**53 at these shapes (at most 4608 * 127**2 for the
GEMM, 4 * C_in * 127**2 for the deconv), so float64 holds every partial
sum exactly and these functions give the int32 results bit for bit.

Layouts are the port's: the deconv takes NHWC int8 activations (the
order the quantizer writes them in) and the ``ConvTranspose2d`` weight
layout (C_in, C_out, kh, kw), and returns NCHW float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# phase row/col -> kernel taps of a ConvTranspose2d(k4, s2, p1): output
# row 2m + a reads input rows (m - 1 + a, m + a) through kernel rows
# _KR[a] (torch's y = 2i - 1 + k); columns likewise.
_KR = ((3, 1), (2, 0))


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32."""
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"int8_matmul takes int8 operands, got {a.dtype} "
                        f"and {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"int8_matmul takes (M, K) and (K, N), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    return (a.double() @ b.double()).to(torch.int32)


def prep_deconv_weights(wq: torch.Tensor) -> torch.Tensor:
    """int8 (C_in, C_out, 4, 4) ``ConvTranspose2d`` weight -> the four
    per-phase GEMM operands (4, 4 * C_in, C_out): phase p = 2a + c, rows
    in (di, dj) row-major blocks of C_in, as the JAX package's
    ``prep_deconv_weights`` orders them."""
    if wq.dim() != 4 or tuple(wq.shape[2:]) != (4, 4):
        raise ValueError(f"expected a (C_in, C_out, 4, 4) weight, got "
                         f"{tuple(wq.shape)}")
    return torch.stack([
        torch.cat([wq[:, :, _KR[a][di], _KR[c][dj]]
                   for di in (0, 1) for dj in (0, 1)])
        for a in (0, 1) for c in (0, 1)])


def deconv4x4s2_int8(xq: torch.Tensor, wq: torch.Tensor,
                     scale: torch.Tensor) -> torch.Tensor:
    """``ConvTranspose2d(k4, s2, p1)`` on int8 codes, dequantized.

    Args:
      xq: (B, H, W, C_in) int8 activations, NHWC.
      wq: (C_in, C_out, 4, 4) int8 weight.
      scale: (C_out,) float32 combined dequant scale ``s_in * s_w[oc]``.
    Returns:
      (B, C_out, 2H, 2W) float32: the int32 sum cast to float32, times
      ``scale[oc]``.
    """
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"deconv takes int8 codes, got {xq.dtype} and "
                        f"{wq.dtype}")
    if (xq.dim() != 4 or wq.dim() != 4 or tuple(wq.shape[2:]) != (4, 4)
            or wq.shape[0] != xq.shape[3]
            or tuple(scale.shape) != (wq.shape[1],)):
        raise ValueError(f"deconv takes (B, H, W, C_in), (C_in, C_out, 4, "
                         f"4) and (C_out,), got {tuple(xq.shape)}, "
                         f"{tuple(wq.shape)} and {tuple(scale.shape)}")
    acc = F.conv_transpose2d(xq.permute(0, 3, 1, 2).double(), wq.double(),
                             stride=2, padding=1)
    return acc.float() * scale.float().view(1, -1, 1, 1)
