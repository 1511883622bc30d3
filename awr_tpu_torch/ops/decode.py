"""Decode dispatch: a CUDA tensor runs the hand-written kernels (the
forward, and under autograd its backward), a CPU tensor the plain
PyTorch version, which autograd differentiates directly."""

from __future__ import annotations

import torch

from awr_tpu_torch.ops import decode_cuda
from awr_tpu_torch.ops.functional import offset2joint_softmax


class DecodeCuda(torch.autograd.Function):
    """The CUDA decode with the CUDA decode backward as its gradient
    (the JAX package's ``custom_vjp`` around its Pallas decode).  The
    forward saves its softmax statistics, so the backward never
    recomputes them.  Only the map gets a gradient: the train step never
    differentiates with respect to the depth."""

    @staticmethod
    def forward(ctx, offset, img, kernel_size):
        out, stats = decode_cuda.offset2joint_softmax_cuda(offset, img,
                                                           kernel_size)
        ctx.save_for_backward(offset, img, out, stats)
        ctx.kernel_size = kernel_size
        return out

    @staticmethod
    def backward(ctx, grad_out):
        offset, img, out, stats = ctx.saved_tensors
        grad = decode_cuda.offset2joint_softmax_backward_cuda(
            offset, img, out, stats, grad_out.contiguous(), ctx.kernel_size)
        return grad, None, None


def decode_offsets(offset: torch.Tensor, img: torch.Tensor,
                   kernel_size: float) -> torch.Tensor:
    """(B, 4J, F, F) dense map + (B, H, W) depth -> (B, J, 3) joints."""
    if offset.device.type == "cuda":
        return DecodeCuda.apply(offset, img, kernel_size)
    return offset2joint_softmax(offset, img, kernel_size)
