"""A minimal PNG writer and depth-PNG reader (stdlib ``zlib`` + ``struct``
+ numpy): the GPU machine has neither OpenCV nor matplotlib.

The writer serves the port's figures and the test fixtures: 8-bit gray
or RGB, or 16-bit gray, with a chosen filter type per row.  The reader
serves the datasets' depth frames: it parses the chunks and inflates the
image data here; the unfilter and the depth fold run in host C++
(``csrc/png_unfilter.cpp``, through :mod:`awr_tpu_torch.data.native_decode`).
:func:`unfilter_plain` and :func:`fold_depth` are the plain numpy version
of that pass, which the tests and ``chip_smoke.py`` hold it to.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
FILTERS = (0, 1, 2, 3, 4)  # None, Sub, Up, Average, Paeth
# the caller's required encoding: 'nyu' 8-bit RGB/RGBA (blue + 256 *
# green), 'gray16' 16-bit gray, 'any' either
KINDS = ("any", "nyu", "gray16")


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def to_uint8(image) -> np.ndarray:
    """Round half to even and saturate to [0, 255], as OpenCV converts a
    float image to 8 bits."""
    return np.clip(np.rint(np.asarray(image, np.float64)), 0,
                   255).astype(np.uint8)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter_rows(rows: np.ndarray, bpp: int, filters) -> np.ndarray:
    """(H, stride) bytes -> (H, 1 + stride) filtered rows; row y takes
    filter ``filters[y % len(filters)]``."""
    x = rows.astype(np.int32)
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    upleft = np.zeros_like(x)
    upleft[1:, bpp:] = x[:-1, :-bpp]
    pred = {0: 0, 1: left, 2: up, 3: (left + up) >> 1,
            4: _paeth(left, up, upleft)}
    kind = np.asarray(filters)[np.arange(len(rows)) % len(filters)]
    out = np.empty((len(rows), rows.shape[1] + 1), np.uint8)
    out[:, 0] = kind
    for f in set(kind.tolist()):
        sel = kind == f
        p = pred[f] if f == 0 else pred[f][sel]
        out[sel, 1:] = ((x[sel] - p) & 255).astype(np.uint8)
    return out


def write_png(path: str, image, filters=(0,)) -> None:
    """Write an (H, W) uint16 image as 16-bit gray, or an (H, W) gray or
    (H, W, 3) RGB image, values rounded and saturated to 8 bits, as an
    8-bit PNG.  Row y is filtered with ``filters[y % len(filters)]``
    (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    if not filters or set(filters) - set(FILTERS):
        raise ValueError(f"filter types are 0-4, got {filters}")
    image = np.asarray(image)
    if image.dtype == np.uint16:
        if image.ndim != 2:
            raise ValueError(f"16-bit PNGs are gray (H, W), got "
                             f"{image.shape}")
        img, depth, color, bpp = image.astype(">u2"), 16, 0, 2
    else:
        img, depth = to_uint8(image), 8
        if img.ndim == 2:
            color, bpp = 0, 1
        elif img.ndim == 3 and img.shape[2] == 3:
            color, bpp = 2, 3
        else:
            raise ValueError(f"expected (H, W) or (H, W, 3), got "
                             f"{img.shape}")
    h, w = img.shape[:2]
    rows = np.frombuffer(img.tobytes(), np.uint8).reshape(h, -1)
    raw = _filter_rows(rows, bpp, filters)
    header = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0)
    with open(path, "wb") as fh:
        fh.write(SIGNATURE)
        fh.write(_chunk(b"IHDR", header))
        fh.write(_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        fh.write(_chunk(b"IEND", b""))


def inflate_depth_png(path: str, kind: str = "any"):
    """Parse and inflate a depth PNG: ``(rows, width, bpp)``, ``rows`` the
    (H, 1 + width * bpp) uint8 filtered scanlines and ``bpp`` 2 (16-bit
    gray), 3 (8-bit RGB) or 4 (8-bit RGBA).  ``kind`` is 'any', 'nyu'
    (require 8-bit RGB/RGBA) or 'gray16' (require 16-bit gray).  Raises
    ``ValueError`` naming the file on anything else: not a PNG, a
    truncated file, a palette, an interlaced image, other bit depths or
    color types, or a kind mismatch."""
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}; expected one of {KINDS}")
    with open(path, "rb") as fh:
        buf = fh.read()
    if buf[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG (bad signature)")
    pos, ihdr, idat, iend = 8, None, [], False
    while pos + 12 <= len(buf):
        (n,) = struct.unpack_from(">I", buf, pos)
        if pos + 12 + n > len(buf):
            raise ValueError(f"{path}: truncated chunk")
        tag = buf[pos + 4:pos + 8]
        data = buf[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            if n != 13:
                raise ValueError(f"{path}: bad IHDR")
            ihdr = struct.unpack(">IIBBBBB", data)
        elif tag == b"IDAT":
            idat.append(data)
        elif tag == b"IEND":
            iend = True
            break
        pos += 12 + n
    if ihdr is None or not iend:
        raise ValueError(f"{path}: truncated (missing IHDR or IEND)")
    width, height, bit_depth, color, _, _, interlace = ihdr
    found = (f"bit_depth={bit_depth} color_type={color} "
             f"interlace={interlace}")
    rgb8 = bit_depth == 8 and color in (2, 6)
    gray16 = bit_depth == 16 and color == 0
    if (kind == "nyu" and not rgb8) or (kind == "gray16" and not gray16):
        raise ValueError(
            f"{path}: PNG ({found}) does not match the expected encoding "
            f"({'8-bit RGB/RGBA' if kind == 'nyu' else '16-bit gray'})")
    if not (rgb8 or gray16) or interlace != 0 or width == 0 or height == 0:
        raise ValueError(
            f"{path}: unsupported PNG ({found}, {width}x{height}); depth "
            f"frames are 8-bit RGB/RGBA or 16-bit gray, not interlaced "
            f"(color_type 3 is a palette)")
    bpp = 2 if gray16 else (3 if color == 2 else 4)
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{path}: inflate failed ({e})") from None
    if len(raw) != height * (1 + width * bpp):
        raise ValueError(f"{path}: inflated {len(raw)} bytes, expected "
                         f"{height * (1 + width * bpp)}")
    return np.frombuffer(raw, np.uint8).reshape(height, -1), width, bpp


def unfilter_plain(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Plain numpy PNG unfilter: (..., H, 1 + stride) filtered scanlines
    -> (..., H, stride) bytes, for one image or a stack of same-shape
    images.  None, Sub and Up are vectorized; Average and Paeth, whose
    pixels depend on the pixel to their left, step through a row a pixel
    at a time (across the stack at once).  Raises ``ValueError`` on a
    filter byte that is not 0-4."""
    rows = np.asarray(rows, np.uint8)
    stack = rows.reshape(-1, *rows.shape[-2:])
    n, h, _ = stack.shape
    out = np.empty((n, h, stack.shape[2] - 1), np.uint8)
    prev = np.zeros((n, out.shape[2]), np.int32)
    for y in range(h):
        kind = stack[:, y, 0]
        src = stack[:, y, 1:].astype(np.int32)
        for f in np.unique(kind).tolist():
            sel = kind == f
            s, up = src[sel], prev[sel]
            if f == 0:
                cur = s
            elif f == 1:
                px = s.reshape(len(s), -1, bpp)
                cur = (np.cumsum(px, axis=1) & 255).reshape(len(s), -1)
            elif f == 2:
                cur = (s + up) & 255
            elif f in (3, 4):
                cur = np.empty_like(s)
                left = np.zeros((len(s), bpp), np.int32)
                upleft = np.zeros((len(s), bpp), np.int32)
                for i in range(0, s.shape[1], bpp):
                    u = up[:, i:i + bpp]
                    pred = ((left + u) >> 1 if f == 3
                            else _paeth(left, u, upleft))
                    left = (s[:, i:i + bpp] + pred) & 255
                    cur[:, i:i + bpp] = left
                    upleft = u
            else:
                raise ValueError(f"bad filter byte {f} on row {y}")
            out[sel, y] = cur
        prev = out[:, y].astype(np.int32)
    return out.reshape(*rows.shape[:-1], -1)


def fold_depth(pixels: np.ndarray, bpp: int) -> np.ndarray:
    """(..., H, W * bpp) unfiltered bytes -> (..., H, W) float32 depth:
    blue + 256 * green for 8-bit RGB/RGBA (reference nyu_loader.py:71-74),
    the big-endian uint16 for 16-bit gray."""
    px = pixels.reshape(*pixels.shape[:-1], -1, bpp).astype(np.float32)
    if bpp == 2:
        return px[..., 0] * 256.0 + px[..., 1]
    return px[..., 2] + 256.0 * px[..., 1]
