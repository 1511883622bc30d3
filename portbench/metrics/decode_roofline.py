"""``decode_roofline.<cell kind>``: the AWR decode kernel's share of its
roofline (``awr_tpu_torch::decode`` -> ``decode_kernel`` of
``csrc/decode.cu``), %.

A call reads the (B, 4J, F, F) map and the F x F depth samples of each
frame, and writes (B, J, 3) joints and (B, J, 2) softmax statistics in
float32; 25 float operations for each (sample, joint, pixel).
"""

import re

from portbench.harness import DTYPE_BYTES, roofline_share

KERNEL = re.compile(r"\bdecode_kernel\b")
OPS_PER_PIXEL = 25


def cost(shapes, dtypes):
    B, C, F, _ = shapes[0]
    J = C // 4
    nbytes = (B * C * F * F * DTYPE_BYTES[dtypes[0]] + B * F * F * 4
              + B * J * 3 * 4 + B * J * 2 * 4)
    return nbytes, B * J * F * F * OPS_PER_PIXEL


def read(ctx):
    return roofline_share(ctx, "awr_tpu_torch::decode", KERNEL, cost)
