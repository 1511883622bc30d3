"""The port's hand-written kernels as ``torch.library`` custom ops, in the
namespace ``awr_tpu_torch``.

Every path reaches a kernel through its op here, and the op chooses by
device: a CUDA tensor takes the kernel's ``ctypes`` wrapper (which counts
the launch), a CPU tensor the plain PyTorch version.  Each op also has a
fake implementation, which gives the output's shape and dtype only: it is
what ``torch.export`` and ``torch.compile`` trace through, so the kernels
stay in an exported program or a compiled graph as single nodes.  A
program that ``torch.export`` saved needs this module imported before it
loads (:mod:`awr_tpu_torch.export`).

| op | CUDA | CPU |
| --- | --- | --- |
| ``decode`` | ``decode_cuda.offset2joint_softmax_cuda`` | ``functional.offset2joint_softmax`` and ``_stats`` |
| ``decode_rows`` | ``decode_cuda.offset2joint_softmax_rows_cuda`` | ``functional.offset2joint_softmax_rows`` |
| ``decode_backward`` | ``decode_cuda.offset2joint_softmax_backward_cuda`` | the VJP of ``functional.offset2joint_softmax`` |
| ``encode`` | ``encode_cuda.joint2offset_cuda`` | ``functional.joint2offset`` |
| ``int8_matmul`` | ``int8_cuda.int8_matmul_cuda`` | ``int8.int8_matmul`` |
| ``deconv4x4s2_int8`` | ``int8_cuda.deconv4x4s2_int8_cuda`` | ``int8.deconv4x4s2_int8`` |
| ``bias_relu_`` | ``folded_cuda.bias_relu_cuda`` | ``folded.bias_relu_`` |
| ``head_out`` | ``folded_cuda.head_out_cuda`` | ``folded.head_out`` |
| ``stem_pool`` | ``folded_cuda.stem_pool_cuda`` | ``folded.stem_pool`` |

Every op takes its tensors dense (``.contiguous()``, a copy only where
they are not), the int8 GEMM's ``b`` aside, which its wrapper lays out
itself.  The caller's layout is not to be trusted: in an exported
program a tensor's strides are the ones the trace's fake tensors had,
and a conv whose input is channels-last gives a channels-last output on
the CPU where its fake output was contiguous, so a ``.contiguous()`` in
the model is traced away.  The kernels read a dense layout, and the
plain versions then sum in the same order as in eager mode.

The last three are the bf16 inference form's passes between its convs
(:mod:`awr_tpu_torch.models.inference`), 21 calls a resnet_18 forward on
a path the host bounds.  They are defined on a
``torch.library.Library`` fragment, with the same CPU/CUDA split and
fake implementations, rather than through ``custom_op``: a call of a
``custom_op`` that mutates its input took about 30 us of host time
under ``no_grad``, a call of an op defined this way about 4 us (empty
implementations, an Intel Xeon core, PyTorch 2.13).  They have no gradient.  ``bias_relu_`` writes into its
first argument and returns nothing; the Python function of that name
returns the argument.

``decode`` is differentiable in its map: its gradient is the op
``decode_backward``, from the saved output and softmax statistics (the
JAX package's ``custom_vjp`` around its Pallas decode).  Importing this
module builds nothing and needs neither ``nvcc`` nor a GPU: the kernels
build at their first launch (:mod:`awr_tpu_torch.kernels`).
"""

from __future__ import annotations

import concurrent.futures
import functools

import torch
from torch import Tensor

from typing import Optional

from awr_tpu_torch.ops import (decode_cuda, encode_cuda, folded, folded_cuda,
                               functional, int8_cuda)
from awr_tpu_torch.ops import int8 as plain_int8

NAMESPACE = "awr_tpu_torch"


# ---------------------------------------------------------------- decode

@torch.library.custom_op(f"{NAMESPACE}::decode", mutates_args=(),
                         device_types="cpu")
def decode(offset: Tensor, img: Tensor,
           kernel_size: float) -> tuple[Tensor, Tensor]:
    """(B, 4J, F, F) map + (B, H, W) depth -> ((B, J, 3) joints, (B, J, 2)
    softmax statistics (max, sum)), float32 (float64 for a float64 map)."""
    offset, img = offset.contiguous(), img.contiguous()
    return (functional.offset2joint_softmax(offset, img, kernel_size),
            functional.offset2joint_softmax_stats(offset, img))


@decode.register_kernel("cuda")
def _decode_cuda(offset, img, kernel_size):
    return decode_cuda.offset2joint_softmax_cuda(
        offset.contiguous(), img.contiguous(), kernel_size)


@decode.register_fake
def _decode_fake(offset, img, kernel_size):
    B, C = offset.shape[:2]
    # float32 (a bfloat16 map is upcast) or float64
    dtype = torch.promote_types(offset.dtype, torch.float32)
    return (offset.new_empty((B, C // 4, 3), dtype=dtype),
            offset.new_empty((B, C // 4, 2), dtype=dtype))


@functools.lru_cache(maxsize=None)
def _vjp_thread() -> concurrent.futures.ThreadPoolExecutor:
    return concurrent.futures.ThreadPoolExecutor(
        1, thread_name_prefix="awr_decode_vjp")


@torch.library.custom_op(f"{NAMESPACE}::decode_backward", mutates_args=(),
                         device_types="cpu")
def decode_backward(offset: Tensor, img: Tensor, out: Tensor, stats: Tensor,
                    grad_out: Tensor, kernel_size: float) -> Tensor:
    """Gradient of :func:`decode` with respect to the map, for the
    cotangent ``grad_out`` (B, J, 3), given the forward's ``out`` and
    ``stats``; in the map's dtype.

    On the CPU it is the vector-Jacobian product of the plain forward
    (``torch.func.vjp``), so it is bit-equal to autograd through
    :func:`~awr_tpu_torch.ops.functional.offset2joint_softmax` (the
    closed form, ``offset2joint_softmax_backward``, rounds otherwise, and
    the float64 multi-step parity tests amplify one ulp).  It runs on a
    thread of its own: an op's implementation runs with the dispatch
    keys the dispatcher left it, and inside a dispatch mode (``opcheck``'s
    schema check, for one) those exclude functorch's, which ``vjp``
    needs; a new thread starts from the default ones."""
    offset, img = offset.contiguous(), img.contiguous()

    @torch.no_grad()
    def vjp():
        _, pullback = torch.func.vjp(
            lambda o: functional.offset2joint_softmax(o, img, kernel_size),
            offset)
        return pullback(grad_out)[0]

    return _vjp_thread().submit(vjp).result()


@decode_backward.register_kernel("cuda")
def _decode_backward_cuda(offset, img, out, stats, grad_out, kernel_size):
    return decode_cuda.offset2joint_softmax_backward_cuda(
        offset.contiguous(), img.contiguous(), out.contiguous(),
        stats.contiguous(), grad_out.contiguous(), kernel_size)


@decode_backward.register_fake
def _decode_backward_fake(offset, img, out, stats, grad_out, kernel_size):
    return torch.empty_like(offset, memory_format=torch.contiguous_format)


def _decode_setup_context(ctx, inputs, output):
    offset, img, kernel_size = inputs
    out, stats = output
    ctx.save_for_backward(offset, img, out, stats)
    ctx.mark_non_differentiable(stats)
    ctx.kernel_size = kernel_size


def _decode_grad(ctx, grad_out, _grad_stats):
    """Only the map gets a gradient: no step differentiates with respect
    to the depth."""
    offset, img, out, stats = ctx.saved_tensors
    return (decode_backward(offset, img, out, stats, grad_out.contiguous(),
                            ctx.kernel_size), None, None)


decode.register_autograd(_decode_grad, setup_context=_decode_setup_context)


@torch.library.custom_op(f"{NAMESPACE}::decode_rows", mutates_args=(),
                         device_types="cpu")
def decode_rows(offset: Tensor, img: Tensor, kernel_size: float, row0: int,
                img_row0: int, img_rows: int) -> tuple[Tensor, Tensor]:
    """The decode of rows [row0, row0 + R) of an F x F map, (B, 4J, R, F),
    given the rows [img_row0, img_row0 + h) of its (B, ``img_rows``, W)
    depth, (B, h, W) -> ((B, J, 3) joints, (B, J, 2) softmax statistics
    (max, sum)) of the window, float32 (float64 for a float64 map): a
    spatial band's decode, which
    :func:`~awr_tpu_torch.ops.functional.merge_softmax_bands` merges.
    No gradient: spatial mode serves only."""
    return functional.offset2joint_softmax_rows(
        offset.contiguous(), img.contiguous(), kernel_size, row0, img_row0,
        img_rows)


@decode_rows.register_kernel("cuda")
def _decode_rows_cuda(offset, img, kernel_size, row0, img_row0, img_rows):
    return decode_cuda.offset2joint_softmax_rows_cuda(
        offset.contiguous(), img.contiguous(), kernel_size, row0, img_row0,
        img_rows)


@decode_rows.register_fake
def _decode_rows_fake(offset, img, kernel_size, row0, img_row0, img_rows):
    return _decode_fake(offset, img, kernel_size)


# ---------------------------------------------------------------- encode

@torch.library.custom_op(f"{NAMESPACE}::encode", mutates_args=(),
                         device_types="cpu")
def encode(jt_uvd: Tensor, img: Tensor, kernel_size: float,
           feature_size: int) -> Tensor:
    """(B, J, 3) joints + (B, H, W) depth -> (B, 4J, F, F) ground-truth
    field in the joints' dtype (float32 on a GPU).  No gradient: it is a
    target built from labels."""
    return functional.joint2offset(jt_uvd.contiguous(), img.contiguous(),
                                   kernel_size, feature_size)


@encode.register_kernel("cuda")
def _encode_cuda(jt_uvd, img, kernel_size, feature_size):
    return encode_cuda.joint2offset_cuda(jt_uvd.contiguous(),
                                         img.contiguous(), kernel_size,
                                         feature_size)


@encode.register_fake
def _encode_fake(jt_uvd, img, kernel_size, feature_size):
    B, J = jt_uvd.shape[:2]
    return jt_uvd.new_empty((B, 4 * J, feature_size, feature_size))


# ------------------------------------------------------------------ int8

@torch.library.custom_op(f"{NAMESPACE}::int8_matmul", mutates_args=(),
                         device_types="cpu")
def int8_matmul(a: Tensor, b: Tensor) -> Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32."""
    return plain_int8.int8_matmul(a.contiguous(), b)


@int8_matmul.register_kernel("cuda")
def _int8_matmul_cuda(a, b):
    return int8_cuda.int8_matmul_cuda(a.contiguous(), b)


@int8_matmul.register_fake
def _int8_matmul_fake(a, b):
    return a.new_empty((a.shape[0], b.shape[1]), dtype=torch.int32)


@torch.library.custom_op(f"{NAMESPACE}::deconv4x4s2_int8", mutates_args=(),
                         device_types="cpu")
def deconv4x4s2_int8(xq: Tensor, wq: Tensor, scale: Tensor,
                     out_dtype: torch.dtype) -> Tensor:
    """``ConvTranspose2d(k4, s2, p1)`` on int8 codes, dequantized: (B, H,
    W, C_in) int8 NHWC, (C_in, C_out, 4, 4) int8 weight, (C_out,) float32
    scale -> (B, C_out, 2H, 2W) ``out_dtype`` (float32 or bfloat16)."""
    # NCHW contiguous, as the kernel writes it (the plain version's
    # transposed conv of NHWC codes gives channels-last strides)
    return plain_int8.deconv4x4s2_int8(xq.contiguous(), wq.contiguous(),
                                       scale.contiguous(),
                                       out_dtype).contiguous()


@deconv4x4s2_int8.register_kernel("cuda")
def _deconv4x4s2_int8_cuda(xq, wq, scale, out_dtype):
    return int8_cuda.deconv4x4s2_int8_cuda(xq.contiguous(), wq.contiguous(),
                                           scale.contiguous(), out_dtype)


@deconv4x4s2_int8.register_fake
def _deconv4x4s2_int8_fake(xq, wq, scale, out_dtype):
    B, H, W, _ = xq.shape
    return xq.new_empty((B, wq.shape[1], 2 * H, 2 * W), dtype=out_dtype)


# ----------------------------------------------- bf16 inference form

_form = torch.library.Library(NAMESPACE, "FRAGMENT")
_form.define("bias_relu_(Tensor(a!) y, Tensor bias, Tensor? residual) -> ()")
_form.define("head_out(Tensor y, Tensor bias) -> Tensor")
_form.define("stem_pool(Tensor x, Tensor weight, Tensor bias) -> Tensor")


def _bias_relu_cpu(y, bias, residual):
    folded.bias_relu_(y, bias, residual)  # an op of schema "-> ()"


for _name, _cpu, _cuda in (
        ("bias_relu_", _bias_relu_cpu, folded_cuda.bias_relu_cuda),
        ("head_out", folded.head_out, folded_cuda.head_out_cuda),
        ("stem_pool", folded.stem_pool, folded_cuda.stem_pool_cuda)):
    _form.impl(_name, _cpu, "CPU")
    _form.impl(_name, _cuda, "CUDA")


@torch.library.register_fake(f"{NAMESPACE}::bias_relu_", lib=_form)
def _bias_relu_fake(y, bias, residual):
    return None


@torch.library.register_fake(f"{NAMESPACE}::head_out", lib=_form)
def _head_out_fake(y, bias):
    return y.new_empty(y.shape, dtype=bias.dtype)


@torch.library.register_fake(f"{NAMESPACE}::stem_pool", lib=_form)
def _stem_pool_fake(x, weight, bias):
    B, _, H, W = x.shape
    return x.new_empty((B, (H + 1) // 2, (W + 1) // 2, weight.shape[0]),
                       dtype=weight.dtype).permute(0, 3, 1, 2)


_bias_relu_op = torch.ops.awr_tpu_torch.bias_relu_.default
head_out = torch.ops.awr_tpu_torch.head_out.default
stem_pool = torch.ops.awr_tpu_torch.stem_pool.default


def bias_relu_(y: Tensor, bias: Tensor,
               residual: Optional[Tensor] = None) -> Tensor:
    """relu(y + bias + residual) in place on ``y`` (B, C, H, W), ``bias``
    per channel, computed in ``bias``'s dtype and rounded once; returns
    ``y``."""
    _bias_relu_op(y, bias, residual)
    return y
