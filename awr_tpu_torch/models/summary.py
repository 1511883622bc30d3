"""Model summary: parameter count and forward FLOPs (the JAX package's
``models/summary.py``; the reference's ptflops ``__main__`` blocks,
resnet_deconv.py:219-232, hourglass.py:167-179).

Usage: ``python -m awr_tpu_torch.models.summary [net] [img_size]``

The FLOPs are ``FlopCounterMode``'s (:func:`~awr_tpu_torch.utils.
profiling.flops_of`) of the backbone's forward at batch 1, counted on
the ``meta`` device without computing.  They differ from the JAX
package's, which asks XLA's cost model of the compiled program: the two
cost models count the transposed convolutions differently
(``FlopCounterMode`` takes 2 FLOPs per multiply-add of every
convolution and transposed convolution from the shapes alone, and
nothing for elementwise work; XLA counts the convolutions it lowered
the program to).  At img 128 the port's count is 1.0568x the JAX
count for resnet_18, whose three 4x4 stride-2 deconvs make the larger
gap, and 1.0061x for hourglass_1.  The parameter counts are equal.
"""

from __future__ import annotations

import sys

import torch

from awr_tpu_torch.models import build_model
from awr_tpu_torch.utils.profiling import flops_of


def summarize(net: str = "resnet_18", img_size: int = 128,
              downsample: int = 2, joint_num: int = 14):
    """Print and return ``(parameter count, forward FLOPs a frame)``."""
    model = build_model(net, joint_num, downsample).eval().to("meta")
    x = torch.zeros((1, 1, img_size, img_size), device="meta")
    n_params = sum(p.numel() for p in model.parameters())
    with torch.no_grad():
        flops = flops_of(model, x)
        out_shape = tuple(model(x).shape)
    print(f"net: {net}  input: {img_size}x{img_size}x1")
    print(f"params: {n_params / 1e6:.2f} M")
    print(f"fwd flops: {flops / 1e9:.2f} GFLOP/frame "
          f"({flops / 2e9:.2f} GMACs)")
    print(f"output: {out_shape}")
    return n_params, flops


if __name__ == "__main__":
    net = sys.argv[1] if len(sys.argv) > 1 else "resnet_18"
    size = int(sys.argv[2]) if len(sys.argv) > 2 else 128
    summarize(net, size)
