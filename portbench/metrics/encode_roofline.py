"""``encode_roofline.<cell kind>``: the AWR encode kernel's share of its
roofline (``awr_tpu_torch::encode`` -> ``encode_kernel`` of
``csrc/encode.cu``), %.

A call reads the (B, J, 3) joints and the F x F depth samples of each
frame and writes the (B, 4J, F, F) target map in float32 (F, the
configuration's ``feature_size``, is a scalar argument of the op); 20
float operations for each (sample, joint, pixel).
"""

import re

from portbench.harness import roofline_share

KERNEL = re.compile(r"\bencode_kernel\b")
OPS_PER_PIXEL = 20


def read(ctx):
    F = ctx.run.cfg["feature_size"]

    def cost(shapes, dtypes):
        B, J, _ = shapes[0]
        nbytes = B * J * 3 * 4 + B * F * F * 4 + B * 4 * J * F * F * 4
        return nbytes, B * J * F * F * OPS_PER_PIXEL

    return roofline_share(ctx, "awr_tpu_torch::encode", KERNEL, cost)
