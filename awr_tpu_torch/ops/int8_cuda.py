"""Wrappers of the hand-written CUDA int8 kernels (``csrc/int8.cu``): the
int8 GEMM and the polyphase int8 transposed conv.

The kernels' library is built and loaded at the first call
(:mod:`awr_tpu_torch.kernels`), so this module imports without a GPU or
``nvcc``.  Their plain versions are :func:`awr_tpu_torch.ops.int8.int8_matmul`
and :func:`~awr_tpu_torch.ops.int8.deconv4x4s2_int8`; the wrappers take the
same arguments.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from awr_tpu_torch import kernels
from awr_tpu_torch.ops.int8 import prep_deconv_weights

# Kernel launches made by each wrapper since its count was last reset.
GEMM_LAUNCHES = 0
DECONV_LAUNCHES = 0


@functools.lru_cache(maxsize=None)
def _gemm_launcher():
    fn = kernels.load("int8").awr_s8_gemm
    # A, Bt, C, M, N, K, vec, stream
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _deconv_launcher():
    fn = kernels.load("int8").awr_s8_deconv
    # x, wph, scale, out, B, H, W, C_in, C_out, stream
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _aligned(*ts) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def _on_one_cuda_device(name, *ts) -> None:
    dev = ts[0].device
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError(f"{name} needs every tensor on one CUDA device, got "
                         f"{[str(t.device) for t in ts]}")


def int8_matmul_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32 on one CUDA device.

    ``a`` must be contiguous.  The kernel reads ``b`` as its transpose
    (N, K) with K contiguous: a ``b`` that is the transposed view of a
    contiguous (N, K) matrix (a conv weight ``w.view(N, K).t()``) is
    passed without a copy; any other ``b`` is copied into that layout."""
    global GEMM_LAUNCHES
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"int8 GEMM takes int8 operands, got {a.dtype} and "
                        f"{b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0] or \
            a.numel() == 0 or b.numel() == 0:
        raise ValueError(f"int8 GEMM takes non-empty (M, K) and (K, N), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if not a.is_contiguous():
        raise ValueError("int8 GEMM takes a contiguous A")
    _on_one_cuda_device("int8 GEMM", a, b)
    M, K = a.shape
    N = b.shape[1]
    if max(M, N, K) >= 2 ** 31:
        raise ValueError(f"int8 GEMM: {(M, K, N)} overflows 32-bit sizes")
    bt = b.t().contiguous()
    c = torch.empty((M, N), dtype=torch.int32, device=a.device)
    vec = int(K % 16 == 0 and _aligned(a, bt))
    with torch.cuda.device(a.device):
        err = _gemm_launcher()(a.data_ptr(), bt.data_ptr(), c.data_ptr(),
                               M, N, K, vec,
                               torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int8 GEMM launch failed: CUDA error {err}")
    GEMM_LAUNCHES += 1
    return c


def deconv4x4s2_int8_cuda(xq: torch.Tensor, wq: torch.Tensor,
                          scale: torch.Tensor) -> torch.Tensor:
    """``ConvTranspose2d(k4, s2, p1)`` on int8 codes, dequantized, on one
    CUDA device: (B, H, W, C_in) int8 NHWC (contiguous), (C_in, C_out, 4,
    4) int8 weight and (C_out,) float32 scale -> (B, C_out, 2H, 2W)
    float32.  C_in must be a multiple of 16."""
    global DECONV_LAUNCHES
    if xq.dtype != torch.int8 or wq.dtype != torch.int8 or \
            scale.dtype != torch.float32:
        raise TypeError(f"int8 deconv takes int8 codes and a float32 scale, "
                        f"got {xq.dtype}, {wq.dtype} and {scale.dtype}")
    if (xq.dim() != 4 or wq.dim() != 4 or tuple(wq.shape[2:]) != (4, 4)
            or wq.shape[0] != xq.shape[3]
            or tuple(scale.shape) != (wq.shape[1],) or xq.numel() == 0):
        raise ValueError(f"int8 deconv takes (B, H, W, C_in), (C_in, C_out, "
                         f"4, 4) and (C_out,), got {tuple(xq.shape)}, "
                         f"{tuple(wq.shape)} and {tuple(scale.shape)}")
    B, H, W, c_in = xq.shape
    c_out = wq.shape[1]
    if c_in % 16:
        raise ValueError(f"int8 deconv needs C_in % 16 == 0, got {c_in}")
    if not xq.is_contiguous():
        raise ValueError("int8 deconv takes contiguous NHWC codes")
    _on_one_cuda_device("int8 deconv", xq, wq, scale)
    if 4 * B * H * W >= 2 ** 31 or 4 * c_in >= 2 ** 31:
        raise ValueError("int8 deconv: shape overflows 32-bit sizes")
    # (4, C_out, 4 C_in): each phase's operand with K contiguous
    wph = prep_deconv_weights(wq).transpose(1, 2).contiguous()
    scale = scale.contiguous()
    if not _aligned(xq, wph):
        raise ValueError("int8 deconv takes 16-byte aligned codes")
    out = torch.empty((B, c_out, 2 * H, 2 * W), dtype=torch.float32,
                      device=xq.device)
    with torch.cuda.device(xq.device):
        err = _deconv_launcher()(
            xq.data_ptr(), wph.data_ptr(), scale.data_ptr(), out.data_ptr(),
            B, H, W, c_in, c_out,
            torch.cuda.current_stream(xq.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int8 deconv launch failed: CUDA error {err}")
    DECONV_LAUNCHES += 1
    return out
