"""``decode_bwd_roofline.<cell kind>``: the decode backward kernel's
share of its roofline (``awr_tpu_torch::decode_backward`` ->
``decode_backward_kernel`` of ``csrc/decode.cu``), %.

A call reads the (B, 4J, F, F) map, the F x F depth samples, the joints,
the softmax statistics and the cotangent, and writes the map's gradient;
30 float operations for each (sample, joint, pixel).
"""

import re

from portbench.harness import DTYPE_BYTES, roofline_share

KERNEL = re.compile(r"\bdecode_backward_kernel\b")
OPS_PER_PIXEL = 30


def cost(shapes, dtypes):
    B, C, F, _ = shapes[0]
    J = C // 4
    nbytes = (2 * B * C * F * F * DTYPE_BYTES[dtypes[0]] + B * F * F * 4
              + 2 * B * J * 3 * 4 + B * J * 2 * 4)
    return nbytes, B * J * F * F * OPS_PER_PIXEL


def read(ctx):
    return roofline_share(ctx, "awr_tpu_torch::decode_backward", KERNEL,
                          cost)
