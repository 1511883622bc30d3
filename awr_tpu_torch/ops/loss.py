"""Smooth-L1 loss with the reference's nonstandard delta = 0.01
(reference model/loss.py:3-25): ``0.5 z^2`` for |z| < 0.01, ``0.01 (|z| -
0.005)`` otherwise, as one mean of the piecewise value."""

from __future__ import annotations

from typing import Optional

import torch

DELTA = 0.01


def smooth_l1_loss(x: torch.Tensor, y: torch.Tensor,
                   sample_weight: Optional[torch.Tensor] = None,
                   weight_sum: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Mean piecewise smooth-L1 over all elements (a float32 scalar).

    The difference is cast to float32, as the reference's ``z.float()``
    is, whatever the inputs' dtype.  ``sample_weight`` (B,) masks padded
    batch rows: the result is the plain mean over the weight-1 rows, and
    an all-zero weight gives 0 (the sum of weights is clamped to 1), not
    0/0.

    ``weight_sum`` (with ``sample_weight``) replaces the sum of these
    rows' weights as the divisor: under data parallelism the weight sum
    of the global batch, so that the ranks' results add up to the loss
    of the global batch, and a rank whose rows are all padding adds 0.
    """
    if x.shape != y.shape:
        raise ValueError(f"shapes differ: {tuple(x.shape)} and "
                         f"{tuple(y.shape)}")
    z = (x - y).to(torch.float32)
    az = z.abs()
    val = torch.where(az < DELTA, 0.5 * z * z, DELTA * (az - 0.5 * DELTA))
    if sample_weight is None:
        return val.mean()
    w = sample_weight.to(torch.float32)
    w_full = w.reshape((-1,) + (1,) * (val.dim() - 1))
    per_sample = val[0].numel()
    denom = torch.clamp(w.sum() if weight_sum is None else weight_sum,
                        min=1.0)
    return (val * w_full).sum() / (denom * per_sample)
