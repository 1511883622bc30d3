"""The AWR encode, decode and loss in plain PyTorch (reference
util/feature_tool.py:12-65 and model/loss.py:3-25).

Maps are NCHW (B, 4J, F, F), channels [j0x, j0y, j0d, j1x, ...,
ht_j0 ... ht_jJ-1].  Computed in the inputs' dtype promoted to float32.
"""

from __future__ import annotations

import numpy as np
import torch

FG_THRESHOLD = 0.99  # normalized depth >= 0.99 is background
SOFTMAX_TEMP = 30.0
DIS_EPS = 1e-8
DELTA = 0.01  # the reference's smooth-L1 knee


def resize_nearest(img: torch.Tensor, size: int) -> torch.Tensor:
    """Nearest resize of (..., H, W) to (..., size, size): ``src =
    floor(dst * H / size)``."""
    h, w = img.shape[-2], img.shape[-1]
    if h == size and w == size:
        return img
    rows = torch.from_numpy((np.arange(size) * h) // size).to(img.device)
    cols = torch.from_numpy((np.arange(size) * w) // size).to(img.device)
    return img.index_select(-2, rows).index_select(-1, cols)


def pixel_mesh(F: int, dtype, device):
    """(mesh_x, mesh_y), each (F, F): pixel centers 2 (i + 0.5) / F - 1,
    rounded once from float64."""
    r = 2.0 * (np.arange(F, dtype=np.float64) + 0.5) / F - 1.0
    r = torch.tensor(r, dtype=dtype, device=device)
    return r[None, :].expand(F, F), r[:, None].expand(F, F)


def decode(offset: torch.Tensor, img: torch.Tensor,
           kernel_size: float) -> torch.Tensor:
    """(B, 4J, F, F) map + (B, H, W) normalized depth -> (B, J, 3)
    joints: the softmax(30 * heatmap)-weighted mean over the pixels of
    ``(u, v, depth) + offset * (k - k * heatmap)``, heatmap and offsets
    zeroed on background pixels (whose logit stays 0)."""
    B, C, F, _ = offset.shape
    J, P = C // 4, F * F
    dtype = torch.promote_types(offset.dtype, torch.float32)
    img_f = resize_nearest(img, F).to(dtype).reshape(B, P)
    mesh_x, mesh_y = pixel_mesh(F, dtype, offset.device)
    coords = torch.stack([mesh_x.reshape(P).expand(B, P),
                          mesh_y.reshape(P).expand(B, P), img_f], dim=-1)
    mask = (img_f < FG_THRESHOLD).to(dtype)[:, None, :]
    off = offset.to(dtype).reshape(B, C, P)
    vec = off[:, :3 * J] * mask
    ht = off[:, 3 * J:] * mask
    w = torch.softmax(ht * SOFTMAX_TEMP, dim=-1)
    dis = kernel_size - ht * kernel_size
    term_vec = (vec.reshape(B, J, 3, P) * (w * dis)[:, :, None]).sum(-1)
    return term_vec + torch.einsum("bjp,bpa->bja", w, coords)


def encode(jt_uvd: torch.Tensor, img: torch.Tensor, kernel_size: float,
           F: int) -> torch.Tensor:
    """(B, J, 3) normalized joints + (B, H, W) depth -> the (B, 4J, F, F)
    target map: per pixel and joint the unit offset to the joint and the
    closeness ``(k - dis) / k``, both zeroed where the closeness is
    negative or the pixel is background."""
    B, J, _ = jt_uvd.shape
    dtype = jt_uvd.dtype
    img_f = resize_nearest(img, F).to(dtype)[:, None]
    mesh_x, mesh_y = pixel_mesh(F, dtype, jt_uvd.device)
    jt = jt_uvd[..., None, None]
    dx = jt[:, :, 0] - mesh_x
    dy = jt[:, :, 1] - mesh_y
    dz = jt[:, :, 2] - img_f
    dis = torch.sqrt(dx * dx + dy * dy + dz * dz + DIS_EPS)
    ht = (kernel_size - dis) / kernel_size
    mask = ((ht >= 0) & (img_f < FG_THRESHOLD)).to(dtype)
    vec = torch.stack([dx / dis, dy / dis, dz / dis], dim=2) * mask[:, :, None]
    return torch.cat([vec.reshape(B, 3 * J, F, F), ht * mask], dim=1)


def smooth_l1(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean over all elements of ``0.5 z^2`` (|z| < 0.01) and ``0.01 (|z|
    - 0.005)`` (otherwise), z = x - y in float32."""
    z = (x - y).to(torch.float32)
    az = z.abs()
    return torch.where(az < DELTA, 0.5 * z * z,
                       DELTA * (az - 0.5 * DELTA)).mean()
