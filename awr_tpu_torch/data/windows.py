"""The serving crop's windows: the pixels of each raw frame that the device
crop (:func:`awr_tpu_torch.data.device.crop_normalize`) can read, and
their packing into one flat float32 buffer on the host, which is all the
Predictor uploads.

The crop takes, for each output pixel, the nearest pixel of the box
``[vs, ve) x [us, ue)`` that :func:`~awr_tpu_torch.data.transforms.
crop_params_np` projects (the cube at the hand's depth), and writes 0
where that pixel lies outside the frame.  So of a frame it reads only the
box clipped to the frame, ``[v0, v0 + h) x [u0, u0 + w)``: its window.  A
hand at 650-950 mm in a 480x640 frame has a 186-271 px box, about a sixth
of the frame's pixels.

Axis by axis: a box with ``s < e`` (and a width that fits int32, as the
crop computes it) is clipped to ``[0, size)``, and is empty where it lies
wholly outside the frame; an inverted or empty box (``s >= e``: a center
at or behind the camera, or NaN) takes the whole axis, so such a frame is
read whole, as the full-frame crop reads it.

Frame ``i``'s window is packed row by row at ``base[i]`` with row stride
``w[i]``.  Rows past the first ``n`` (a bucket's padding, which repeats the
last frame) share frame ``n - 1``'s window.  An empty window has ``h = w
= 0``, and every ``base`` lies inside the buffer, an empty window's too,
so an index clamped into its window never leaves the buffer.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from awr_tpu_torch import kernels
from awr_tpu_torch.kernels import I64, INT, PTR

_INT32_MAX = np.iinfo(np.int32).max
# imgs, n, strides (3), v0, u0, h, w, base, out, threads
_PACK = (PTR, I64, I64, I64, I64) + (PTR,) * 6 + (INT,)


class Windows(NamedTuple):
    """Per bucket row: the window's origin ``v0``, ``u0`` and size ``h``,
    ``w`` (int32) in its frame, and its offset ``base`` (int64) in the
    packed buffer; the frames' size ``hw``; ``n`` rows packed, ``size``
    floats in all."""
    v0: np.ndarray
    u0: np.ndarray
    h: np.ndarray
    w: np.ndarray
    base: np.ndarray
    hw: Tuple[int, int]
    n: int
    size: int

    def columns(self) -> dict:
        """The per-row arrays by name, as the device crop takes them."""
        return dict(v0=self.v0, u0=self.u0, h=self.h, w=self.w,
                    base=self.base)


def _axis(s, e, size: int):
    s, e = s.astype(np.int64), e.astype(np.int64)
    box = (s < e) & (e - s <= _INT32_MAX)
    lo = np.where(box, np.clip(s, 0, size), 0)
    hi = np.where(box, np.clip(e, 0, size), size)
    return lo.astype(np.int32), (hi - lo).astype(np.int32)


def crop_windows(p: dict, hw, n: int) -> Windows:
    """The windows of the crop parameters ``p`` (``crop_params_np``'s
    ``us ue vs ve`` for each bucket row) in frames of size ``hw`` = (H0,
    W0), the first ``n`` rows packed in order."""
    H0, W0 = (int(x) for x in hw)
    v0, h = _axis(p["vs"], p["ve"], H0)
    u0, w = _axis(p["us"], p["ue"], W0)
    # an empty window is empty both ways: its clamped index is its base
    empty = (h == 0) | (w == 0)
    h[empty] = 0
    w[empty] = 0
    area = h[:n].astype(np.int64) * w[:n]
    size = int(area.sum())
    base = np.empty(len(v0), np.int64)
    base[0] = 0
    base[1:n] = np.cumsum(area[:-1])
    base[n:] = base[n - 1]
    np.minimum(base, max(size - 1, 0), out=base)
    return Windows(v0, u0, h, w, base, (H0, W0), n, size)


@functools.lru_cache(maxsize=None)
def _packer():
    """The C++ packer (``csrc/window_pack.cpp``), or None where no host
    C++ compiler is found (the numpy loop packs then)."""
    if kernels.host_compiler() is None:
        return None
    return kernels.bind("window_pack", "awr_pack_windows", _PACK, None)


def pack_windows(imgs: np.ndarray, win: Windows, out: torch.Tensor) -> None:
    """Copy the windows of the first ``win.n`` of the (B, H0, W0) float32
    frames ``imgs`` (any strides) into ``out``, a contiguous float32 host
    tensor of at least ``win.size`` elements; over PyTorch's number of
    threads."""
    if imgs.dtype != np.float32 or imgs.shape[1:] != win.hw:
        raise ValueError(f"expected float32 frames of {win.hw}, got "
                         f"{imgs.dtype} {imgs.shape}")
    if (out.dtype != torch.float32 or not out.is_contiguous()
            or out.numel() < win.size or len(imgs) < win.n):
        raise ValueError("pack_windows: the buffer or the frames are too "
                         "small for the windows")
    fn = _packer()
    if fn is None:
        _pack_numpy(imgs, win, out.numpy())
        return
    if any(s % 4 for s in imgs.strides):
        imgs = np.ascontiguousarray(imgs)
    fn(imgs.ctypes.data, win.n, *(s // 4 for s in imgs.strides),
       win.v0.ctypes.data, win.u0.ctypes.data, win.h.ctypes.data,
       win.w.ctypes.data, win.base.ctypes.data, out.data_ptr(),
       torch.get_num_threads())


def _pack_numpy(imgs: np.ndarray, win: Windows, flat: np.ndarray) -> None:
    for i in range(win.n):
        v0, u0, h, w, b = (int(a[i]) for a in (win.v0, win.u0, win.h,
                                                win.w, win.base))
        if h and w:
            flat[b:b + h * w].reshape(h, w)[...] = \
                imgs[i, v0:v0 + h, u0:u0 + w]
