"""Wrappers of the hand-written CUDA int8 kernels (``csrc/int8.cu``): the
int8 GEMM and the polyphase int8 transposed conv.

The kernels' library is built and loaded at the first call
(:mod:`awr_tpu_torch.kernels`), so this module imports without a GPU or
``nvcc``.  Their plain versions are :func:`awr_tpu_torch.ops.int8.int8_matmul`
and :func:`~awr_tpu_torch.ops.int8.deconv4x4s2_int8`; the wrappers take the
same arguments.  :func:`gemm_plan` and :func:`deconv_plan` choose each
launch's tiles from the shapes alone, on the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from awr_tpu_torch import kernels
from awr_tpu_torch.kernels import INT, PTR

# The tensor-core kernels' fixed tile: 128 rows of A (two warpgroups of
# 64) and 128 bytes of K a pipeline stage; the GEMM's tile width BN is 64
# or 128, the deconv's 64 output channels.  These mirror the constants
# of csrc/int8.cu.
BM = 128
BK = 128
DECONV_BN = 64
# SMs of an H100 SXM.
SMS = 132
# A split of K walks at least this many stages.
MIN_SPLIT_STAGES = 4
# Shared memory a block may use on Hopper.
SMEM_LIMIT = 232_448
# a, b^T, c, M, N, K, bn, split, per_split, stream
_GEMM_TC = (PTR,) * 3 + (INT,) * 6 + (PTR,)
# a, b^T, c, M, N, K, stream
_GEMM = (PTR,) * 3 + (INT,) * 3 + (PTR,)
# x, w, w per phase, scale, out, B, H, W, C_in, C_out, tw, th, tb, bf16,
# stream
_DECONV = (PTR,) * 5 + (INT,) * 9 + (PTR,)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _ring_smem(stages: int, stage_bytes: int) -> int:
    # the ring, a full and an empty barrier a stage, and 1024 bytes of
    # slack to align the ring for the 128-byte swizzle
    return stages * stage_bytes + 16 * stages + 1024


def tc_smem(bn: int) -> int:
    """Dynamic shared memory of a GEMM block of width ``bn`` (a ring of 3
    stages at 128, 4 at 64: two blocks an SM), or with ``bn`` 0 of a
    deconv block (4 stages of an A tile and two weight tiles, and the
    float32 output tile of both column phases: one block an SM)."""
    if bn == 0:
        return (_ring_smem(4, (BM + 2 * DECONV_BN) * BK)
                + BM * 2 * DECONV_BN * 4)
    return _ring_smem(3 if bn == 128 else 4, (BM + bn) * BK)


class GemmPlan(NamedTuple):
    path: str       # "wgmma" (tensor cores, TMA) or "dp4a" (byte loads)
    bn: int         # tile width along N
    split: int      # splits of K (blockIdx.z); > 1 adds into a zeroed C
    per_split: int  # K stages (BK bytes each) a split walks
    smem: int       # dynamic shared memory a block, bytes


def gemm_plan(M: int, K: int, N: int) -> GemmPlan:
    """The launch of an (M, K) @ (K, N) int8 GEMM.  K % 16 != 0 (TMA needs
    16-byte row strides in A and B) takes the byte-load dp4a kernel.
    Otherwise BN is 128 where 128-wide tiles still give every SM one,
    else 64 (twice the blocks).  A grid that leaves three quarters of the
    SMs idle splits K until about every SM has a block, each split
    walking at least ``MIN_SPLIT_STAGES`` stages and none empty: its
    partial tiles are added into a zeroed C by TMA, so N % 4 == 0 (C's
    rows 16-byte strided); the memset and the adds cost more than the
    idle SMs until then (measured on an H100, PERF.md)."""
    k_stages = _cdiv(K, BK)
    if K % 16:
        return GemmPlan("dp4a", 64, 1, k_stages, 0)
    bn = 128 if N > 64 and _cdiv(M, BM) * _cdiv(N, 128) >= SMS else 64
    tiles = _cdiv(M, BM) * _cdiv(N, bn)
    split = 1
    if 4 * tiles <= SMS and N % 4 == 0:
        split = max(1, min(_cdiv(SMS, tiles), k_stages // MIN_SPLIT_STAGES))
    per_split = _cdiv(k_stages, split)
    return GemmPlan("wgmma", bn, _cdiv(k_stages, per_split), per_split,
                    tc_smem(bn))


class DeconvPlan(NamedTuple):
    tw: int    # input pixels of a tile along W ...
    th: int    # ... along H ...
    tb: int    # ... and images: tw * th * tb == BM
    smem: int  # dynamic shared memory a block, bytes


def deconv_plan(B: int, H: int, W: int, c_in: int, c_out: int) -> DeconvPlan:
    """The launch of a polyphase int8 deconv.  A unit of work is BM = 128
    input pixels (16 x 8 of one image where W > 8, else 8 wide and 8 high
    (two images) or 16 high) of one row phase, both column phases and 64
    output channels; its K stages are 128 channels of one row tap and
    one column shift.  One persistent block an SM walks the units."""
    tw = 16 if W > 8 else 8
    th = 8 if tw == 16 or H <= 8 else 16
    return DeconvPlan(tw, th, BM // (tw * th), tc_smem(0))


def library_smem(bn: int) -> int:
    """The built library's dynamic shared memory of a GEMM block at width
    ``bn``, or of a deconv block at 0 (the numbers of :func:`tc_smem`)."""
    return kernels.bind("int8", "awr_s8_tc_smem", (INT,))(bn)


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
    plan = gemm_plan(M, K, N)
    alloc = torch.zeros if plan.split > 1 else torch.empty
    c = alloc((M, N), dtype=torch.int32, device=a.device)
    if plan.path == "wgmma":
        a, bt = kernels.aligned(a), kernels.aligned(bt)
        fn = kernels.bind("int8", "awr_s8_gemm_tc", _GEMM_TC)
        tiles = (plan.bn, plan.split, plan.per_split)
    else:
        fn, tiles = kernels.bind("int8", "awr_s8_gemm", _GEMM), ()
    kernels.launch("int8_gemm", fn, a.device, a.data_ptr(), bt.data_ptr(),
                   c.data_ptr(), M, N, K, *tiles)
    return c


def deconv4x4s2_int8_cuda(xq: torch.Tensor, wq: torch.Tensor,
                          scale: torch.Tensor,
                          out_dtype: torch.dtype = torch.float32
                          ) -> torch.Tensor:
    """``ConvTranspose2d(k4, s2, p1)`` on int8 codes, dequantized, on one
    CUDA device: (B, H, W, C_in) int8 NHWC (contiguous), (C_in, C_out, 4,
    4) int8 weight and (C_out,) float32 scale -> (B, C_out, 2H, 2W)
    ``out_dtype``, float32 or bfloat16 (the float32 product rounded once
    in the kernel's epilogue).  C_in must be a multiple of 16."""
    if xq.dtype != torch.int8 or wq.dtype != torch.int8 or \
            scale.dtype != torch.float32:
        raise TypeError(f"int8 deconv takes int8 codes and a float32 scale, "
                        f"got {xq.dtype}, {wq.dtype} and {scale.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"int8 deconv writes float32 or bfloat16, not "
                        f"{out_dtype}")
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
    wq, scale, xq = wq.contiguous(), scale.contiguous(), kernels.aligned(xq)
    # the kernel's per-phase weight operands, (4, C_out, 4 C_in), made by
    # the library's first kernel
    wph = torch.empty((4, c_out, 4 * c_in), dtype=torch.int8,
                      device=xq.device)
    plan = deconv_plan(B, H, W, c_in, c_out)
    out = torch.empty((B, c_out, 2 * H, 2 * W), dtype=out_dtype,
                      device=xq.device)
    bf16 = out_dtype == torch.bfloat16
    kernels.launch("deconv_int8_bf16" if bf16 else "deconv_int8",
                   kernels.bind("int8", "awr_s8_deconv", _DECONV), xq.device,
                   xq.data_ptr(), wq.data_ptr(), wph.data_ptr(),
                   scale.data_ptr(), out.data_ptr(), B, H, W, c_in, c_out,
                   plan.tw, plan.th, plan.tb, int(bf16))
    return out
