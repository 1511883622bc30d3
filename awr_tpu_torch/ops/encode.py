"""Encode dispatch: the op ``awr_tpu_torch::encode``
(:mod:`awr_tpu_torch.ops.library`), which runs the hand-written kernel
on a CUDA tensor and the plain PyTorch version on a CPU tensor.  The
field is a target built from ground-truth joints, so it carries no
gradient (the JAX package wraps it in ``stop_gradient``)."""

from __future__ import annotations

import torch

from awr_tpu_torch.ops import library


def encode_offsets(jt_uvd: torch.Tensor, img: torch.Tensor,
                   kernel_size: float, feature_size: int) -> torch.Tensor:
    """(B, J, 3) joints + (B, H, W) depth -> (B, 4J, F, F) GT field."""
    return library.encode(jt_uvd, img, float(kernel_size),
                          int(feature_size)).detach()
