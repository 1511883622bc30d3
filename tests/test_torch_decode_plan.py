"""The launch of the CUDA decode and decode backward, on the CPU: both
kernels give each (sample, joint) one block, whose threads walk its
F x F planes with a cursor (``Cursor`` in ``csrc/decode.cu``).  A mirror
of that cursor shows that the block visits every pixel exactly once, at
the feature sizes of the port's models (resnet ds 4/2/1 at img 128: F =
32/64/128; hourglass: 64), the small maps of the card tests and a row
that holds no whole 4-pixel group (F = 10: scalar loads)."""

import collections

import pytest

from awr_tpu_torch.ops import decode_cuda

FEATURES = (8, 10, 16, 32, 64, 128)


def walk(F, vec):
    """Pixels (y, x) visited by the threads of one block, stepped as the
    kernel's Cursor steps them, ``UNROLL`` groups at a time."""
    groups = F // vec
    threads, unroll = decode_cuda.THREADS, decode_cuda.UNROLL
    dy, dx = threads // groups, (threads % groups) * vec
    seen = []
    for t in range(threads):
        y, x = t // groups, (t % groups) * vec
        while y < F:
            for _ in range(unroll):
                if y < F:
                    seen.extend((y, x + i) for i in range(vec))
                x, y = x + dx, y + dy
                if x >= F:
                    x, y = x - F, y + 1
    return seen


@pytest.mark.parametrize("F", FEATURES)
def test_block_visits_every_pixel_once(F):
    """4-pixel groups (16-byte loads) where F % 4 == 0, else single
    pixels, as the kernels' launchers choose."""
    vec = 4 if F % 4 == 0 else 1
    assert collections.Counter(walk(F, vec)) == collections.Counter(
        (y, x) for y in range(F) for x in range(F))


def test_threads_take_whole_groups_at_the_main_path_shape():
    """hourglass_1 and resnet_18 at ds 2 (F = 64): each of a block's
    threads takes the same number of 4-pixel groups."""
    assert (64 * 64 // 4) % decode_cuda.THREADS == 0
