"""The three OpenCV operations of the reference's host crop chain, in
numpy, bit for bit: the nearest-neighbour resize of ``crop``, the
rotation matrix and affine warp of ``rotate``, and the perspective warp
of ``recrop`` (reference loader.py:38-40, :141-160, :125-138).  The GPU
machine has no OpenCV.

What is emulated is OpenCV 5.0 on a float32 image, as its vectorized
kernels run on an x86 CPU with FMA (held against ``cv2`` in
tests/test_torch_host_data.py):

- ``resize`` INTER_NEAREST: ``fx = dsize.width / src.width`` in double
  and the source column ``min(floor(x * (1 / fx)), src.width - 1)``, the
  same for rows.
- ``getRotationMatrix2D(center, angle, scale)``: the closed form in
  double, the center rounded to float32.
- ``warpAffine`` / ``warpPerspective`` INTER_LINEAR, BORDER_CONSTANT:
  the matrix is inverted in double (``warpAffine``'s own 2x3 inverse;
  ``invert``'s 3x3 closed form for the perspective) and rounded to
  float32.  Each row's terms are ``float32(y * M1) + M2`` (two
  roundings); each pixel's source coordinate is ``fma(M0, x, row term)``
  (divided by ``fma(M6, x, row term)`` for the perspective), so it is
  not quantized to 1/32 pixel as OpenCV's older fixed-point remap did.
  The four taps (a tap outside the source reads the border value) are
  blended by three float32 ``fma`` lerps, across then down.

These are the vectorized kernels; OpenCV finishes a row whose width is
not a multiple of its vector step with scalar code that rounds
differently, so bit equality holds for the crop widths the models use
(multiples of 32).
"""

from __future__ import annotations

import math

import numpy as np

_F32 = np.float32
_F64 = np.float64


def fma32(a, b, c) -> np.ndarray:
    """Elementwise float32 ``a * b + c`` rounded once, as a fused
    multiply-add does.  The float64 product of two float32 values is
    exact; the sum is taken exactly as a float64 value plus its error
    (TwoSum) and rounded to odd, which then rounds to float32 without a
    second rounding error."""
    a, b, c = np.broadcast_arrays(np.asarray(a, _F32), np.asarray(b, _F32),
                                  np.asarray(c, _F32))
    p = a.astype(_F64) * b
    c = c.astype(_F64)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    odd = (s.view(np.int64) & 1) == 1
    toward = np.where(err > 0, np.inf, -np.inf)
    return np.where((err == 0) | odd, s,
                    np.nextafter(s, toward)).astype(_F32)


def resize_nearest(img: np.ndarray, size) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=INTER_NEAREST)``; ``size`` is
    (width, height)."""
    h, w = img.shape[:2]
    dw, dh = int(size[0]), int(size[1])
    ifx, ify = 1.0 / (dw / w), 1.0 / (dh / h)
    sx = np.minimum(np.floor(np.arange(dw) * ifx).astype(np.int64), w - 1)
    sy = np.minimum(np.floor(np.arange(dh) * ify).astype(np.int64), h - 1)
    return img[sy[:, None], sx[None, :]]


def rotation_matrix_2d(center, angle: float, scale: float = 1.0):
    """``cv2.getRotationMatrix2D(center, angle, scale)``: (2, 3) float64,
    a counter-clockwise rotation by ``angle`` degrees about ``center``."""
    cx, cy = float(_F32(center[0])), float(_F32(center[1]))
    angle = float(angle) * (math.pi / 180)
    alpha = math.cos(angle) * scale
    beta = math.sin(angle) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]], _F64)


def _invert_affine(M) -> np.ndarray:
    """``warpAffine``'s inverse of a 2x3 matrix, in double."""
    m = [float(v) for v in np.asarray(M, _F64).reshape(6)]
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0] = a11
    m[1] *= -d
    m[3] *= -d
    m[4] = a22
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return np.array(m, _F64)


def _invert_3x3(M) -> np.ndarray:
    """``cv::invert``'s closed-form 3x3 inverse (DECOMP_LU), in double;
    raises on a singular matrix."""
    S = np.asarray(M, _F64).reshape(3, 3)

    def m(i, j):
        return float(S[i, j])

    d = (m(0, 0) * (m(1, 1) * m(2, 2) - m(1, 2) * m(2, 1))
         - m(0, 1) * (m(1, 0) * m(2, 2) - m(1, 2) * m(2, 0))
         + m(0, 2) * (m(1, 0) * m(2, 1) - m(1, 1) * m(2, 0)))
    if d == 0:
        raise ValueError("warp_perspective: singular matrix")
    d = 1.0 / d
    return np.array([
        (m(1, 1) * m(2, 2) - m(1, 2) * m(2, 1)) * d,
        (m(0, 2) * m(2, 1) - m(0, 1) * m(2, 2)) * d,
        (m(0, 1) * m(1, 2) - m(0, 2) * m(1, 1)) * d,
        (m(1, 2) * m(2, 0) - m(1, 0) * m(2, 2)) * d,
        (m(0, 0) * m(2, 2) - m(0, 2) * m(2, 0)) * d,
        (m(0, 2) * m(1, 0) - m(0, 0) * m(1, 2)) * d,
        (m(1, 0) * m(2, 1) - m(1, 1) * m(2, 0)) * d,
        (m(0, 1) * m(2, 0) - m(0, 0) * m(2, 1)) * d,
        (m(0, 0) * m(1, 1) - m(0, 1) * m(1, 0)) * d], _F64)


def _mapped(Mf: np.ndarray, i: int, dsize):
    """The (H, W) float32 source coordinate ``fma(M[i], x, float32(y *
    M[i+1]) + M[i+2])`` of every destination pixel."""
    w, h = dsize
    row = np.arange(h, dtype=_F32) * Mf[i + 1] + Mf[i + 2]
    return fma32(Mf[i], np.arange(w, dtype=_F32)[None, :], row[:, None])


def _bilinear(img: np.ndarray, sx: np.ndarray, sy: np.ndarray,
              border_value: float) -> np.ndarray:
    ix, iy = np.floor(sx), np.floor(sy)
    a, b = sx - ix, sy - iy  # exact in float32
    ix, iy = ix.astype(np.int64), iy.astype(np.int64)
    h, w = img.shape
    fill = _F32(border_value)

    def tap(dy, dx):
        yy, xx = iy + dy, ix + dx
        inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        v = img[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)]
        return np.where(inside, v, fill)

    p00, p01, p10, p11 = tap(0, 0), tap(0, 1), tap(1, 0), tap(1, 1)
    top = fma32(a, p01 - p00, p00)
    bottom = fma32(a, p11 - p10, p10)
    return fma32(b, bottom - top, top)


def _check(img: np.ndarray) -> np.ndarray:
    if img.dtype != _F32 or img.ndim != 2:
        raise ValueError(f"expected an (H, W) float32 image, got "
                         f"{img.dtype} {img.shape}")
    return img


def warp_affine(img: np.ndarray, M, dsize,
                border_value: float = 0.0) -> np.ndarray:
    """``cv2.warpAffine(img, M, dsize, flags=INTER_LINEAR,
    borderMode=BORDER_CONSTANT, borderValue=border_value)`` of an (H, W)
    float32 image; ``M`` (2, 3) maps source to destination, ``dsize`` is
    (width, height)."""
    Mf = _invert_affine(M).astype(_F32)
    return _bilinear(_check(img), _mapped(Mf, 0, dsize),
                     _mapped(Mf, 3, dsize), border_value)


def warp_perspective(img: np.ndarray, M, dsize,
                     border_value: float = 0.0) -> np.ndarray:
    """``cv2.warpPerspective(img, M, dsize, flags=INTER_LINEAR,
    borderMode=BORDER_CONSTANT, borderValue=border_value)`` of an (H, W)
    float32 image; ``M`` (3, 3) maps source to destination."""
    Mf = _invert_3x3(M).astype(_F32)
    w = _mapped(Mf, 6, dsize)
    with np.errstate(divide="ignore", invalid="ignore"):
        sx = _mapped(Mf, 0, dsize) / w
        sy = _mapped(Mf, 3, dsize) / w
    return _bilinear(_check(img), sx, sy, border_value)
