"""The port's hand-written kernels as ``torch.library`` ops, in the namespace
``awr_tpu_torch``.

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

Each op computes what its implementations' docstrings say.  The ops are
defined on a ``torch.library.Library`` fragment, which costs less host
time a call than ``torch.library.custom_op``'s Python layer.

Every op takes its tensors dense (``.contiguous()``, a copy only where
they are not), the int8 GEMM's ``b`` aside, which its wrapper lays out
itself, and the bf16 inference form's channels-last tensors.  The
caller's layout is not to be trusted: in an exported program a tensor's
strides are the ones the trace's fake tensors had, and a conv whose
input is channels-last gives a channels-last output on the CPU where its
fake output was contiguous, so a ``.contiguous()`` in the model is
traced away.  The kernels read a dense layout, and the plain versions
then sum in the same order as in eager mode.

The last three are the bf16 inference form's passes between its convs
(:mod:`awr_tpu_torch.models.inference`), 21 calls a resnet_18 forward on
a path the host bounds.  ``bias_relu_`` writes into its first argument
and returns nothing; the Python function of that name returns the
argument.

``decode`` is differentiable in its map: its gradient is the op
``decode_backward``, from the saved output and softmax statistics (the
JAX package's ``custom_vjp`` around its Pallas decode).  No other op has
a gradient: the encode is a target built from labels, and the rest
serve.  Importing this module builds nothing and needs neither ``nvcc``
nor a GPU: the kernels build at their first launch
(:mod:`awr_tpu_torch.kernels`).
"""

from __future__ import annotations

import concurrent.futures
import functools
from typing import Optional

import torch
from torch import Tensor

from awr_tpu_torch.ops import (decode_cuda, encode_cuda, folded, folded_cuda,
                               functional, int8_cuda)
from awr_tpu_torch.ops import int8 as plain_int8

NAMESPACE = "awr_tpu_torch"


def _dense(fn):
    """``fn`` on its tensor arguments made dense (the module's docstring
    says why)."""
    def impl(*args):
        return fn(*[a.contiguous() if isinstance(a, Tensor) else a
                    for a in args])
    return impl


# ---------------------------------------------------------------- decode

def _decode_cpu(offset, img, kernel_size):
    offset, img = offset.contiguous(), img.contiguous()
    return (functional.offset2joint_softmax(offset, img, kernel_size),
            functional.offset2joint_softmax_stats(offset, img))


def _decode_fake(offset, img, kernel_size, *window):
    B, C = offset.shape[:2]
    # float32 (a bfloat16 map is upcast) or float64
    dtype = torch.promote_types(offset.dtype, torch.float32)
    return (offset.new_empty((B, C // 4, 3), dtype=dtype),
            offset.new_empty((B, C // 4, 2), dtype=dtype))


@functools.lru_cache(maxsize=None)
def _vjp_thread() -> concurrent.futures.ThreadPoolExecutor:
    return concurrent.futures.ThreadPoolExecutor(
        1, thread_name_prefix="awr_decode_vjp")


def _decode_backward_cpu(offset, img, out, stats, grad_out, kernel_size):
    """The vector-Jacobian product of the plain forward
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


# ---------------------------------------------------------- the others

def _encode_fake(jt_uvd, img, kernel_size, feature_size):
    B, J = jt_uvd.shape[:2]
    return jt_uvd.new_empty((B, 4 * J, feature_size, feature_size))


def _int8_matmul_fake(a, b):
    return a.new_empty((a.shape[0], b.shape[1]), dtype=torch.int32)


def _deconv_cpu(xq, wq, scale, out_dtype):
    # NCHW contiguous, as the kernel writes it (the plain version's
    # transposed conv of NHWC codes gives channels-last strides)
    return plain_int8.deconv4x4s2_int8(xq.contiguous(), wq.contiguous(),
                                       scale.contiguous(),
                                       out_dtype).contiguous()


def _deconv_fake(xq, wq, scale, out_dtype):
    B, H, W, _ = xq.shape
    return xq.new_empty((B, wq.shape[1], 2 * H, 2 * W), dtype=out_dtype)


def _bias_relu_cpu(y, bias, residual):
    folded.bias_relu_(y, bias, residual)  # an op of schema "-> ()"


def _stem_pool_fake(x, weight, bias):
    B, _, H, W = x.shape
    return x.new_empty((B, (H + 1) // 2, (W + 1) // 2, weight.shape[0]),
                       dtype=weight.dtype).permute(0, 3, 1, 2)


# Each op's schema, and its CPU, CUDA and fake implementations.
_OPS = {
    "decode": ("(Tensor offset, Tensor img, float kernel_size) "
               "-> (Tensor, Tensor)",
               _decode_cpu, _dense(decode_cuda.offset2joint_softmax_cuda),
               _decode_fake),
    "decode_backward": (
        "(Tensor offset, Tensor img, Tensor out, Tensor stats, "
        "Tensor grad_out, float kernel_size) -> Tensor",
        _decode_backward_cpu,
        _dense(decode_cuda.offset2joint_softmax_backward_cuda),
        _decode_backward_fake),
    "decode_rows": (
        "(Tensor offset, Tensor img, float kernel_size, SymInt row0, "
        "SymInt img_row0, SymInt img_rows) -> (Tensor, Tensor)",
        _dense(functional.offset2joint_softmax_rows),
        _dense(decode_cuda.offset2joint_softmax_rows_cuda), _decode_fake),
    "encode": ("(Tensor jt_uvd, Tensor img, float kernel_size, "
               "SymInt feature_size) -> Tensor",
               _dense(functional.joint2offset),
               _dense(encode_cuda.joint2offset_cuda), _encode_fake),
    "int8_matmul": ("(Tensor a, Tensor b) -> Tensor",
                    lambda a, b: plain_int8.int8_matmul(a.contiguous(), b),
                    lambda a, b: int8_cuda.int8_matmul_cuda(a.contiguous(),
                                                            b),
                    _int8_matmul_fake),
    "deconv4x4s2_int8": (
        "(Tensor xq, Tensor wq, Tensor scale, ScalarType out_dtype) "
        "-> Tensor",
        _deconv_cpu, _dense(int8_cuda.deconv4x4s2_int8_cuda), _deconv_fake),
    "bias_relu_": ("(Tensor(a!) y, Tensor bias, Tensor? residual) -> ()",
                   _bias_relu_cpu, folded_cuda.bias_relu_cuda,
                   lambda y, bias, residual: None),
    "head_out": ("(Tensor y, Tensor bias) -> Tensor", folded.head_out,
                 folded_cuda.head_out_cuda,
                 lambda y, bias: y.new_empty(y.shape, dtype=bias.dtype)),
    "stem_pool": ("(Tensor x, Tensor weight, Tensor bias) -> Tensor",
                  folded.stem_pool, folded_cuda.stem_pool_cuda,
                  _stem_pool_fake),
}

_lib = torch.library.Library(NAMESPACE, "FRAGMENT")
for _name, (_args, _cpu, _cuda, _fake) in _OPS.items():
    _lib.define(_name + _args, tags=(torch.Tag.pt2_compliant_tag,))
    _lib.impl(_name, _cpu, "CPU")
    _lib.impl(_name, _cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{_name}", _fake, lib=_lib)
torch.library.register_autograd(f"{NAMESPACE}::decode", _decode_grad,
                                setup_context=_decode_setup_context, lib=_lib)

_ops = torch.ops.awr_tpu_torch
_bias_relu_op = _ops.bias_relu_.default
decode = _ops.decode.default
decode_backward = _ops.decode_backward.default
decode_rows = _ops.decode_rows.default
encode = _ops.encode.default
int8_matmul = _ops.int8_matmul.default
deconv4x4s2_int8 = _ops.deconv4x4s2_int8.default
head_out = _ops.head_out.default
stem_pool = _ops.stem_pool.default


def bias_relu_(y: Tensor, bias: Tensor,
               residual: Optional[Tensor] = None) -> Tensor:
    """relu(y + bias + residual) in place on ``y`` (B, C, H, W), ``bias``
    per channel, computed in ``bias``'s dtype and rounded once; returns
    ``y``."""
    _bias_relu_op(y, bias, residual)
    return y
