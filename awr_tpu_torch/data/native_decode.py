"""Depth-PNG decoding for the dataset loaders (the JAX package's
``data/native_decode.py``): the chunk parse and the inflate of
:func:`awr_tpu_torch.utils.png.inflate_depth_png`, then the unfilter and
the depth fold in one pass of host C++ (``csrc/png_unfilter.cpp``,
built at first use by :mod:`awr_tpu_torch.kernels` and called through
``ctypes``, which drops the GIL so loader threads overlap).

``kind`` pins the encoding a dataset expects: 'nyu' (8-bit RGB/RGBA,
blue + 256 * green), 'gray16' (16-bit gray), or 'any'.  Unlike the JAX
package, nothing falls back: a file this reader cannot decode, or a
failed build of the C++, raises.
"""

from __future__ import annotations

import numpy as np

from awr_tpu_torch import kernels
from awr_tpu_torch.kernels import I64, INT, PTR
from awr_tpu_torch.utils.png import inflate_depth_png

# rows, h, width, bpp, pixels, out
_UNFILTER = (PTR, I64, I64, INT, PTR, PTR)


def unfilter_depth(rows: np.ndarray, width: int, bpp: int, path: str = "",
                   out: np.ndarray = None):
    """The C++ pass over one image's (H, 1 + width * bpp) filtered
    scanlines: ``(pixels, depth)``, the (H, width * bpp) unfiltered bytes
    and the (H, width) float32 depth (written into ``out`` when given)."""
    rows = np.ascontiguousarray(rows, np.uint8)
    h = rows.shape[0]
    if rows.shape != (h, 1 + width * bpp) or bpp not in (2, 3, 4):
        raise ValueError(f"{path}: scanlines {rows.shape} do not match "
                         f"width {width} at {bpp} bytes a pixel")
    pixels = np.empty((h, width * bpp), np.uint8)
    if out is None:
        out = np.empty((h, width), np.float32)
    if out.shape != (h, width) or out.dtype != np.float32 \
            or not out.flags.c_contiguous:
        raise ValueError(f"out must be a contiguous ({h}, {width}) float32 "
                         f"array")
    bad = kernels.bind("png_unfilter", "awr_png_unfilter_depth", _UNFILTER)(
        rows.ctypes.data, h, width, bpp, pixels.ctypes.data, out.ctypes.data)
    if bad:
        raise ValueError(f"{path}: bad filter byte {rows[bad - 1, 0]} on "
                         f"row {bad - 1}")
    return pixels, out


def decode_depth_png(path: str, kind: str = "any") -> np.ndarray:
    """(H, W) float32 depth mm from one depth PNG; raises ``ValueError``
    on a malformed, unsupported or kind-mismatched file."""
    rows, width, bpp = inflate_depth_png(path, kind)
    return unfilter_depth(rows, width, bpp, path)[1]


def decode_depth_pngs(paths, kind: str = "any") -> np.ndarray:
    """(N, H, W) float32 depth mm in one contiguous buffer; every frame
    must have the first one's shape."""
    paths = list(paths)
    if not paths:
        raise ValueError("decode_depth_pngs: no paths")
    first = decode_depth_png(paths[0], kind)
    out = np.empty((len(paths), *first.shape), np.float32)
    out[0] = first
    for i, path in enumerate(paths[1:], 1):
        rows, width, bpp = inflate_depth_png(path, kind)
        if (rows.shape[0], width) != first.shape:
            raise ValueError(f"{path}: {rows.shape[0]}x{width} frame, "
                             f"expected {first.shape[0]}x{first.shape[1]}")
        unfilter_depth(rows, width, bpp, path, out=out[i])
    return out
