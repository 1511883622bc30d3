"""Pinhole camera geometry: xyz (mm, camera frame) <-> uvd (pixels + mm
depth), over the last axis of size 3 (reference util/util.py:3-20; NYU
uses ``flip=-1``), as numpy functions for the host and batched torch
functions for the device, with the 2D uv affine and rotation of the
augmentation (reference loader.py:242-260)."""

from __future__ import annotations

import numpy as np
import torch


def xyz2uvd_np(pts, paras, flip=1):
    """u = x*fx/z + u0 ; v = flip*y*fy/z + v0 ; d = z (float32)."""
    pts = np.asarray(pts, dtype=np.float32)
    fx, fy, u0, v0 = paras
    out = np.empty_like(pts)
    z = pts[..., 2]
    out[..., 0] = pts[..., 0] * fx / z + u0
    out[..., 1] = pts[..., 1] * flip * fy / z + v0
    out[..., 2] = z
    return out


def uvd2xyz_np(pts, paras, flip=1):
    """x = (u-u0)*d/fx ; y = flip*(v-v0)*d/fy ; z = d (float32)."""
    pts = np.asarray(pts, dtype=np.float32)
    fx, fy, u0, v0 = paras
    out = np.empty_like(pts)
    d = pts[..., 2]
    out[..., 0] = (pts[..., 0] - u0) * d / fx
    out[..., 1] = (pts[..., 1] - v0) * d / fy * flip
    out[..., 2] = d
    return out


def transform_uv_np(jt_uvd, M):
    """Apply a 3x3 homogeneous affine M to the uv part of (..., J, 3)
    points in the points' dtype; depth untouched (reference
    loader.py:254-260).  The numpy branch of the JAX package's
    ``transform_uv``, operation for operation."""
    uv1 = np.concatenate(
        [jt_uvd[..., :2], np.ones_like(jt_uvd[..., :1])], axis=-1)
    uv1 = np.einsum("ij,...kj->...ki", np.asarray(M, dtype=uv1.dtype), uv1)
    uv = uv1[..., :2] / uv1[..., 2:]
    return np.concatenate([uv, jt_uvd[..., 2:]], axis=-1)


def rotate_pts_uv_np(pts, center, angle_deg):
    """Rotate (J, 3) uv points clockwise by ``angle_deg`` about
    ``center``; depth untouched (reference loader.py:242-252).  The numpy
    branch of the JAX package's ``rotate_pts_uv``."""
    a = angle_deg * np.pi / 180.0
    ca, sa = np.cos(a), np.sin(a)
    du = pts[..., 0] - center[0]
    dv = pts[..., 1] - center[1]
    u = du * ca - dv * sa + center[0]
    v = du * sa + dv * ca + center[1]
    return np.stack([u, v, pts[..., 2]], axis=-1)


# Batched torch twins of the above for the device train path.  Each casts
# the points to float32 and takes ``paras`` as (fx, fy, u0, v0) floats or
# a float32 tensor, as the JAX package's device path does, so the two
# round alike.


def xyz2uvd(pts: torch.Tensor, paras, flip: int = 1) -> torch.Tensor:
    """(..., 3) camera xyz mm -> (u px, v px, d mm) (float32)."""
    pts = pts.to(torch.float32)
    fx, fy, u0, v0 = paras[0], paras[1], paras[2], paras[3]
    x, y, z = pts[..., 0], pts[..., 1] * flip, pts[..., 2]
    return torch.stack([x * fx / z + u0, y * fy / z + v0, z], dim=-1)


def uvd2xyz(pts: torch.Tensor, paras, flip: int = 1) -> torch.Tensor:
    """(..., 3) (u px, v px, d mm) -> camera xyz mm (float32)."""
    pts = pts.to(torch.float32)
    fx, fy, u0, v0 = paras[0], paras[1], paras[2], paras[3]
    u, v, d = pts[..., 0], pts[..., 1], pts[..., 2]
    return torch.stack([(u - u0) * d / fx, (v - v0) * d / fy * flip, d],
                       dim=-1)


def transform_uv(jt_uvd: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """Apply per-sample 3x3 homogeneous affines M (B, 3, 3) to the uv part
    of (B, J, 3) points; depth untouched (reference loader.py:254-260)."""
    u, v = jt_uvd[..., 0], jt_uvd[..., 1]
    row = lambda i: (M[:, i, 0, None] * u + M[:, i, 1, None] * v  # noqa: E731
                     + M[:, i, 2, None])
    w = row(2)
    return torch.stack([row(0) / w, row(1) / w, jt_uvd[..., 2]], dim=-1)


def rotate_pts_uv(pts: torch.Tensor, center: torch.Tensor,
                  angle_deg: torch.Tensor) -> torch.Tensor:
    """Rotate (B, J, 3) uv points clockwise by ``angle_deg`` (B,) about
    ``center`` (B, >=2); depth untouched (reference loader.py:242-252)."""
    a = (angle_deg * np.pi / 180.0)[:, None]
    ca, sa = torch.cos(a), torch.sin(a)
    cu, cv = center[:, 0, None], center[:, 1, None]
    du = pts[..., 0] - cu
    dv = pts[..., 1] - cv
    return torch.stack([du * ca - dv * sa + cu, du * sa + dv * ca + cv,
                        pts[..., 2]], dim=-1)
