"""A minimal PNG writer (zlib + struct), for the port's figures: the
GPU machine has neither OpenCV nor matplotlib."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def to_uint8(image) -> np.ndarray:
    """Round half to even and saturate to [0, 255], as OpenCV converts a
    float image to 8 bits."""
    return np.clip(np.rint(np.asarray(image, np.float64)), 0,
                   255).astype(np.uint8)


def write_png(path: str, image) -> None:
    """Write an (H, W) gray or (H, W, 3) RGB image, values rounded and
    saturated to 8 bits, as an 8-bit PNG."""
    img = to_uint8(image)
    if img.ndim == 2:
        color = 0
    elif img.ndim == 3 and img.shape[2] == 3:
        color = 2
    else:
        raise ValueError(f"expected (H, W) or (H, W, 3), got {img.shape}")
    h, w = img.shape[:2]
    rows = img.reshape(h, -1)
    # filter type 0 (none) before each row
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n")
        fh.write(_chunk(b"IHDR", header))
        fh.write(_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        fh.write(_chunk(b"IEND", b""))
