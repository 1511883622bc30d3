"""Wrappers of the hand-written CUDA decode kernels (``csrc/decode.cu``):
the forward, which also gives the softmax statistics, of a whole map or
of a window of its rows (spatial serving), and the backward, which takes
them.

The kernels' library is built and loaded at the first call
(:mod:`awr_tpu_torch.kernels`), so this module imports without a GPU or
``nvcc``.  Their plain versions are
:func:`awr_tpu_torch.ops.functional.offset2joint_softmax` (with
:func:`~awr_tpu_torch.ops.functional.offset2joint_softmax_stats`),
:func:`~awr_tpu_torch.ops.functional.offset2joint_softmax_rows` and
:func:`~awr_tpu_torch.ops.functional.offset2joint_softmax_backward`.
Both kernels give each (sample, joint) one block.
"""

from __future__ import annotations

import torch

from awr_tpu_torch import kernels
from awr_tpu_torch.kernels import FLOAT, INT, PTR

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}

# Threads of a block and pixel groups a thread loads at once; these mirror
# kThreads and kUnroll of csrc/decode.cu (tests/test_torch_decode_plan.py
# walks the kernels' cursor with them).
THREADS = 256
UNROLL = 2

# offset, img, out, stats, B, J, F, rows, row0, H, W, img_row0, img_h,
# kernel_size, stream
_FORWARD = (PTR,) * 4 + (INT,) * 9 + (FLOAT, PTR)
# offset, img, out, stats, grad_out, grad, B, J, F, H, W, kernel_size,
# stream
_BACKWARD = (PTR,) * 6 + (INT,) * 5 + (FLOAT, PTR)


def _check_inputs(offset: torch.Tensor, img: torch.Tensor,
                  window: bool = False) -> None:
    """``window``: ``offset`` is (B, 4J, R, F), R rows of an F x F map;
    else it is the square map."""
    if offset.dtype not in _DTYPES or img.dtype != torch.float32:
        raise TypeError(f"decode kernel takes a float32 or bfloat16 map "
                        f"and float32 depth, got {offset.dtype} and "
                        f"{img.dtype}")
    if (offset.dim() != 4 or offset.numel() == 0 or offset.shape[1] % 4
            or not (window or offset.shape[2] == offset.shape[3])
            or img.dim() != 3 or img.shape[0] != offset.shape[0]
            or img.numel() == 0):
        shape = "(B, 4J, R, F)" if window else "(B, 4J, F, F)"
        raise ValueError(f"decode kernel takes non-empty {shape} and "
                         f"(B, H, W), got {tuple(offset.shape)} and "
                         f"{tuple(img.shape)}")
    if not (offset.is_contiguous() and img.is_contiguous()):
        raise ValueError("decode kernel takes contiguous tensors")
    if offset.device.type != "cuda" or img.device != offset.device:
        raise ValueError(f"decode kernel needs both tensors on one CUDA "
                         f"device, got {offset.device} and {img.device}")


def _check_joint_tensor(name: str, t: torch.Tensor, shape, device) -> None:
    if t.dtype != torch.float32 or tuple(t.shape) != shape:
        raise ValueError(f"decode backward takes a float32 {name} of shape "
                         f"{shape}, got {t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous() or t.device != device:
        raise ValueError(f"decode backward takes a contiguous {name} on "
                         f"{device}")


def _decode(kernel, offset, img, kernel_size, row0, img_row0, H):
    """Launch the decode, counted as ``kernel``, on rows [row0, row0 + R)
    of the map (``offset`` (B, 4J, R, F)), the depth rows [img_row0,
    img_row0 + h) of a (B, H, W) depth given as ``img`` (B, h, W)."""
    B, C, R, F = offset.shape
    J = C // 4
    h, W = img.shape[1:]
    offset = kernels.aligned(offset)
    out = torch.empty((B, J, 3), dtype=torch.float32, device=offset.device)
    stats = torch.empty((B, J, 2), dtype=torch.float32, device=offset.device)
    fn = kernels.bind("decode", f"awr_decode_{_DTYPES[offset.dtype]}",
                      _FORWARD)
    kernels.launch(kernel, fn, offset.device, offset.data_ptr(),
                   img.data_ptr(), out.data_ptr(), stats.data_ptr(), B, J, F,
                   R, row0, H, W, img_row0, h, float(kernel_size))
    return out, stats


def offset2joint_softmax_cuda(offset: torch.Tensor, img: torch.Tensor,
                              kernel_size: float):
    """(B, 4J, F, F) float32/bfloat16 map + (B, H, W) float32 depth, both
    contiguous on one CUDA device -> ((B, J, 3) float32 joints, (B, J, 2)
    float32 softmax statistics (max, sum), which
    :func:`offset2joint_softmax_backward_cuda` takes)."""
    _check_inputs(offset, img)
    return _decode("decode", offset, img, kernel_size, 0, 0, img.shape[1])


def offset2joint_softmax_rows_cuda(offset: torch.Tensor, img: torch.Tensor,
                                   kernel_size: float, row0: int,
                                   img_row0: int, img_rows: int):
    """The decode of a row window, as
    :func:`~awr_tpu_torch.ops.functional.offset2joint_softmax_rows`:
    ``offset`` (B, 4J, R, F) float32/bfloat16 holds rows [row0, row0 + R)
    of an F x F map, ``img`` (B, h, W) float32 the rows [img_row0,
    img_row0 + h) of its (B, ``img_rows``, W) depth, both contiguous on
    one CUDA device -> ((B, J, 3) joints, (B, J, 2) statistics (max,
    sum)) of the window, float32."""
    _check_inputs(offset, img, window=True)
    R, F = offset.shape[2:]
    h = img.shape[1]
    first, last = (row0 * img_rows) // F, ((row0 + R - 1) * img_rows) // F
    if not (0 <= row0 and row0 + R <= F and 0 <= img_row0 <= first
            and last < img_row0 + h <= img_rows):
        raise ValueError(f"decode window: map rows [{row0}, {row0 + R}) of "
                         f"{F} read depth rows [{first}, {last}], not all "
                         f"in the {h} given from {img_row0} of {img_rows}")
    return _decode("decode_rows", offset, img, kernel_size, int(row0),
                   int(img_row0), int(img_rows))


def offset2joint_softmax_backward_cuda(offset: torch.Tensor,
                                       img: torch.Tensor, out: torch.Tensor,
                                       stats: torch.Tensor,
                                       grad_out: torch.Tensor,
                                       kernel_size: float) -> torch.Tensor:
    """Gradient of the decode with respect to the map: the forward's
    inputs, its (B, J, 3) float32 output ``out`` and (B, J, 2) float32
    ``stats`` (both from :func:`offset2joint_softmax_cuda`), and the
    cotangent ``grad_out`` (B, J, 3) float32, all contiguous on one CUDA
    device -> (B, 4J, F, F) in the map's dtype."""
    _check_inputs(offset, img)
    B, C, F, _ = offset.shape
    J = C // 4
    H, W = img.shape[1:]
    _check_joint_tensor("out", out, (B, J, 3), offset.device)
    _check_joint_tensor("stats", stats, (B, J, 2), offset.device)
    _check_joint_tensor("grad_out", grad_out, (B, J, 3), offset.device)
    offset = kernels.aligned(offset)
    grad = torch.empty_like(offset)
    fn = kernels.bind("decode",
                      f"awr_decode_backward_{_DTYPES[offset.dtype]}",
                      _BACKWARD)
    kernels.launch("decode_backward", fn, offset.device, offset.data_ptr(),
                   img.data_ptr(), out.data_ptr(), stats.data_ptr(),
                   grad_out.data_ptr(), grad.data_ptr(), B, J, F, H, W,
                   float(kernel_size))
    return grad
