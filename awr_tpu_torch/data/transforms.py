"""Host-side crop parameters for the device crop (reference
loader.py:181-240) and label normalization (nyu_loader.py:61-64)."""

from __future__ import annotations

import numpy as np


def crop_params_np(centers_uvd, cubes, paras, dsize: int):
    """Vectorized float64 crop parameters for a batch.

    Computed on the host in float64 because the reference's ``int()``
    truncations sit right on integer boundaries that float32 can land on
    the wrong side of (e.g. 227 * (128/227) is 127.99999 in float32 but
    128.00000000000003 in float64).

    Returns a dict of (B,)-shaped arrays: us, ue, vs, ve (int32 crop
    bounds), zs, ze (float32 depth clip), sw, sh (int32 resized size),
    tx, ty (int32 paste offsets), and M (B, 3, 3) float32.
    """
    c = np.asarray(centers_uvd, np.float64)
    cube = np.asarray(cubes, np.float64)
    fx, fy = float(paras[0]), float(paras[1])
    half_u = (cube[:, 0] / 2.0) / c[:, 2] * fx
    half_v = (cube[:, 1] / 2.0) / c[:, 2] * fy
    us = np.trunc(c[:, 0] - half_u + 0.5).astype(np.int32)
    ue = np.trunc(c[:, 0] + half_u + 0.5).astype(np.int32)
    vs = np.trunc(c[:, 1] - half_v + 0.5).astype(np.int32)
    ve = np.trunc(c[:, 1] + half_v + 0.5).astype(np.int32)
    zs = (c[:, 2] - cube[:, 2] / 2.0).astype(np.float32)
    ze = (c[:, 2] + cube[:, 2] / 2.0).astype(np.float32)
    w = (ue - us).astype(np.float64)
    h = (ve - vs).astype(np.float64)
    scale = np.minimum(dsize / w, dsize / h)
    sw = np.trunc(w * scale).astype(np.int32)
    sh = np.trunc(h * scale).astype(np.int32)
    tx = np.floor(dsize / 2.0 - sw / 2.0).astype(np.int32)
    ty = np.floor(dsize / 2.0 - sh / 2.0).astype(np.int32)
    B = len(c)
    M = np.zeros((B, 3, 3), np.float64)
    M[:, 0, 0] = scale
    M[:, 1, 1] = scale
    M[:, 0, 2] = -us * scale + tx
    M[:, 1, 2] = -vs * scale + ty
    M[:, 2, 2] = 1.0
    return dict(us=us, ue=ue, vs=vs, ve=ve, zs=zs, ze=ze, sw=sw, sh=sh,
                tx=tx, ty=ty, M=M.astype(np.float32))


def normalize_labels(jt_xyz, jt_uvd_px, center_xyz, cube, img_size):
    """Label normalization (reference nyu_loader.py:61-64): crop-pixel uv ->
    [-1,1], depth -> cube-relative [-1,1], xyz -> center-relative half-cube
    units.  ``jt_uvd_px`` is the M-transformed uv with raw mm depth."""
    jt_uvd = jt_uvd_px.copy()
    jt_uvd[:, :2] = jt_uvd[:, :2] / (img_size / 2.0) - 1
    jt_uvd[:, 2] = (jt_uvd[:, 2] - center_xyz[2]) / (cube[2] / 2.0)
    return (jt_xyz / (np.asarray(cube) / 2.0)).astype(np.float32), \
        jt_uvd.astype(np.float32)
