"""Encode dispatch: a CUDA tensor runs the hand-written kernel, a CPU
tensor the plain PyTorch version.  The field is a target built from
ground-truth joints, so it carries no gradient (the JAX package wraps it
in ``stop_gradient``)."""

from __future__ import annotations

import torch

from awr_tpu_torch.ops.encode_cuda import joint2offset_cuda
from awr_tpu_torch.ops.functional import joint2offset


def encode_offsets(jt_uvd: torch.Tensor, img: torch.Tensor,
                   kernel_size: float, feature_size: int) -> torch.Tensor:
    """(B, J, 3) joints + (B, H, W) depth -> (B, 4J, F, F) GT field."""
    if jt_uvd.device.type == "cuda":
        out = joint2offset_cuda(jt_uvd, img, kernel_size, feature_size)
    else:
        out = joint2offset(jt_uvd, img, kernel_size, feature_size)
    return out.detach()
