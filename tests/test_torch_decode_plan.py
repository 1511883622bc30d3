"""The launch of the CUDA decode and decode backward, on the CPU: both
kernels give each (sample, joint) one block, whose threads walk its
F x F planes with a cursor (``Cursor`` in ``csrc/decode.cu``).  A mirror
of that cursor shows that the block visits every pixel exactly once, at
the feature sizes of the port's models (resnet ds 4/2/1 at img 128: F =
32/64/128; hourglass: 64), the small maps of the card tests and a row
that holds no whole 4-pixel group (F = 10: scalar loads); and the row
windows of spatial serving, a (rows, F) plane of an F x F map, whose
every pixel the block visits once too."""

import collections

import pytest

from awr_tpu_torch.ops import decode_cuda

FEATURES = (8, 10, 16, 32, 64, 128)


def walk(F, vec, rows=None):
    """Pixels (y, x) visited by the threads of one block over a plane of
    ``rows`` (default F) rows of F pixels, stepped as the kernel's Cursor
    steps them, ``UNROLL`` groups at a time."""
    rows = F if rows is None else rows
    groups = F // vec
    threads, unroll = decode_cuda.THREADS, decode_cuda.UNROLL
    dy, dx = threads // groups, (threads % groups) * vec
    seen = []
    for t in range(threads):
        y, x = t // groups, (t % groups) * vec
        while y < rows:
            for _ in range(unroll):
                if y < rows:
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


def windows(F):
    """(row0, rows) of the bands of an F-row map over 1 to 8 bands, and a
    one-row window."""
    out = {(F - 1, 1)}
    for n in range(1, 9):
        bounds = [b * F // n for b in range(n + 1)]
        out.update((a, b - a) for a, b in zip(bounds, bounds[1:]) if b > a)
    return sorted(out)


@pytest.mark.parametrize("F", FEATURES)
def test_block_visits_every_pixel_of_a_row_window_once(F):
    """The row-window decode of spatial serving: a block walks the
    (rows, F) plane of its band's map, each pixel once, for every band of
    an F-row map over 1 to 8 bands (the cursor is local to the window;
    its first global row only offsets the kernel's tables)."""
    vec = 4 if F % 4 == 0 else 1
    for _, rows in windows(F):
        assert collections.Counter(walk(F, vec, rows)) == \
            collections.Counter((y, x) for y in range(rows)
                                for x in range(F)), rows
