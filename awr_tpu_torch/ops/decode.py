"""Decode dispatch: the op ``awr_tpu_torch::decode``
(:mod:`awr_tpu_torch.ops.library`), which runs the hand-written kernel
on a CUDA tensor and the plain PyTorch version on a CPU tensor, and whose
gradient in the map is the op ``awr_tpu_torch::decode_backward`` (the
backward kernel, or on the CPU the VJP of the plain version)."""

from __future__ import annotations

import torch

from awr_tpu_torch.ops import library


def decode_offsets(offset: torch.Tensor, img: torch.Tensor,
                   kernel_size: float) -> torch.Tensor:
    """(B, 4J, F, F) dense map + (B, H, W) depth -> (B, J, 3) joints."""
    return library.decode(offset, img, float(kernel_size))[0]
