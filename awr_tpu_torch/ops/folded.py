"""Plain PyTorch versions of the bf16 inference form's kernels
(:mod:`awr_tpu_torch.models.inference`), on any device: the CPU
implementations of the ops ``awr_tpu_torch::bias_relu_``, ``head_out``
and ``stem_pool`` (:mod:`awr_tpu_torch.ops.library`), and what the
kernels of ``csrc/folded.cu`` (:mod:`awr_tpu_torch.ops.folded_cuda`) are
held against.

- :func:`bias_relu_`: relu(y + bias + residual) in place on ``y``, in
  ``bias``'s dtype with one rounding (a conv's folded BatchNorm, a
  block's residual and the ReLU);
- :func:`head_out`: the heads' output + bias as a contiguous (NCHW) map
  in ``bias``'s dtype, the layout the decode reads;
- :func:`stem_pool`: the ResNet stem's 5x5 conv of the one-channel depth,
  its bias and ReLU, and the 3x3 / stride 2 max-pool after it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def bias_relu_(y: torch.Tensor, bias: torch.Tensor,
               residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """relu(y + bias + residual), ``bias`` per channel of the (B, C, H, W)
    ``y``, written into ``y`` and returned: computed in ``bias``'s dtype
    and rounded once to ``y``'s."""
    out = y.to(bias.dtype) + bias[:, None, None]
    if residual is not None:
        out += residual
    return y.copy_(torch.relu_(out))


def head_out(y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) ``y`` + ``bias`` per channel as a new contiguous
    tensor in ``bias``'s dtype."""
    out = torch.empty(y.shape, dtype=bias.dtype, device=y.device)
    return torch.add(y, bias[:, None, None], out=out)


def stem_pool(x: torch.Tensor, weight: torch.Tensor,
              bias: torch.Tensor) -> torch.Tensor:
    """(B, 1, H, W) depth -> max_pool(relu(conv(x, ``weight``, pad 2) +
    ``bias``), 3, stride 2, pad 1), (B, C, ceil(H/2), ceil(W/2)) in
    ``weight``'s dtype, channels-last.  ``x`` is rounded to ``weight``'s
    dtype, the conv and bias are computed in ``bias``'s and rounded
    once."""
    y = F.conv2d(x.to(weight.dtype).to(bias.dtype), weight.to(bias.dtype),
                 bias, 1, 2)
    y = torch.relu_(y).to(weight.dtype)
    return F.max_pool2d(y, 3, 2, 1).contiguous(
        memory_format=torch.channels_last)
