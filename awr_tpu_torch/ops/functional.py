"""The AWR encode, decode and decode backward in plain PyTorch.

These are the definitions the CUDA kernels (``csrc/encode.cu``,
``csrc/decode.cu``) are held to, and what a CPU tensor runs.  Maps are
NCHW: (B, 4J, F, F) with channel order [j0x, j0y, j0d, j1x, ..., ht_j0
... ht_jJ-1] (reference feature_tool.py:12-65), the JAX package's NHWC
map transposed.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# Foreground threshold: normalized depth >= 0.99 is background
# (reference feature_tool.py:35,57).
FG_THRESHOLD = 0.99
# Softmax temperature over the closeness heatmap (reference feature_tool.py:60).
SOFTMAX_TEMP = 30.0
# Distance epsilon under the sqrt (reference feature_tool.py:31).
DIS_EPS = 1e-8


def resize_nearest(img: torch.Tensor, size: int) -> torch.Tensor:
    """Nearest resize of (..., H, W) to (..., size, size) with torch
    ``F.interpolate(mode='nearest')`` indexing: ``src = floor(dst*H/size)``."""
    h, w = img.shape[-2], img.shape[-1]
    if h == size and w == size:
        return img
    rows = torch.from_numpy((np.arange(size) * h) // size).to(img.device)
    cols = torch.from_numpy((np.arange(size) * w) // size).to(img.device)
    return img.index_select(-2, rows).index_select(-1, cols)


@functools.lru_cache(maxsize=None)
def _pixel_mesh_np(feature_size: int):
    """Normalized pixel-center coordinates 2*(i+0.5)/F - 1, computed in
    float64 so each cast rounds the constant once."""
    r = (2.0 * (np.arange(feature_size, dtype=np.float64) + 0.5)
         / feature_size - 1.0)
    mesh_x = np.broadcast_to(r[None, :], (feature_size, feature_size))
    mesh_y = np.broadcast_to(r[:, None], (feature_size, feature_size))
    return mesh_x, mesh_y


def pixel_mesh(feature_size: int, dtype=torch.float32, device="cpu"):
    """(mesh_x, mesh_y), each (F, F): x varies along columns, y along rows."""
    mesh_x, mesh_y = _pixel_mesh_np(feature_size)
    return (torch.tensor(mesh_x, dtype=dtype, device=device),
            torch.tensor(mesh_y, dtype=dtype, device=device))


def resize_nearest_rows(img: torch.Tensor, size: int, row0: int,
                        rows: int, img_row0: int = 0,
                        img_rows: int | None = None) -> torch.Tensor:
    """Rows [row0, row0 + rows) of the (size, size) nearest resize of a
    (B, H, W) depth, given only its rows [img_row0, img_row0 + h) as
    ``img`` (B, h, W); H = ``img_rows`` (default h).  Row i reads the
    depth's global row ``floor(i*H/size)``, as :func:`resize_nearest`."""
    H = img.shape[-2] if img_rows is None else img_rows
    src = (np.arange(row0, row0 + rows) * H) // size - img_row0
    if len(src) and (src[0] < 0 or src[-1] >= img.shape[-2]):
        raise ValueError(f"map rows [{row0}, {row0 + rows}) read depth rows "
                         f"[{src[0] + img_row0}, {src[-1] + img_row0}], "
                         f"outside the {img.shape[-2]} given from "
                         f"{img_row0}")
    cols = (np.arange(size) * img.shape[-1]) // size
    return (img.index_select(-2, torch.from_numpy(src).to(img.device))
            .index_select(-1, torch.from_numpy(cols).to(img.device)))


def _softmax_decode(offset: torch.Tensor, img_f: torch.Tensor,
                    mesh_x: torch.Tensor, mesh_y: torch.Tensor,
                    kernel_size: float) -> torch.Tensor:
    """The decode of a (B, 4J, R, F) map over its R*F pixels, given their
    resized depth ``img_f`` (B, R, F) and coordinates (R, F)."""
    B, C, R, F = offset.shape
    J = C // 4
    P = R * F
    dtype = torch.promote_types(offset.dtype, torch.float32)
    img_f = img_f.to(dtype).reshape(B, P)
    # the coordinate term uses the raw resized depth: the reference
    # masks the heatmap and the offsets, not the coordinates
    coords = torch.stack([mesh_x.reshape(P).expand(B, P),
                          mesh_y.reshape(P).expand(B, P), img_f], dim=-1)
    mask = (img_f < FG_THRESHOLD).to(dtype)[:, None, :]  # (B, 1, P)
    off = offset.to(dtype).reshape(B, C, P)
    vec = off[:, :3 * J] * mask  # (B, 3J, P)
    ht = off[:, 3 * J:] * mask  # (B, J, P)
    # background pixels keep logit 0 (weight exp(0)), not -inf: the
    # reference zeroes the heatmap, not the logit
    w = torch.softmax(ht * SOFTMAX_TEMP, dim=-1)
    dis = kernel_size - ht * kernel_size
    term_vec = (vec.reshape(B, J, 3, P) * (w * dis)[:, :, None]).sum(-1)
    term_coord = torch.einsum("bjp,bpa->bja", w, coords)
    return term_vec + term_coord


def _softmax_stats(offset: torch.Tensor, img_f: torch.Tensor) -> torch.Tensor:
    """The softmax statistics of a (B, 4J, R, F) map over its R*F pixels,
    given their resized depth ``img_f`` (B, R, F)."""
    B, C, R, F = offset.shape
    J = C // 4
    dtype = torch.promote_types(offset.dtype, torch.float32)
    mask = (img_f.to(dtype).reshape(B, 1, R * F) < FG_THRESHOLD).to(dtype)
    # spelled as _softmax_decode spells the logit, so the max is
    # bit-equal to the one its softmax takes
    logit = (offset.to(dtype).reshape(B, C, R * F)[:, 3 * J:] * mask
             * SOFTMAX_TEMP)
    m = logit.amax(-1)
    return torch.stack([m, torch.exp(logit - m[..., None]).sum(-1)], dim=-1)


def offset2joint_softmax(offset: torch.Tensor, img: torch.Tensor,
                         kernel_size: float) -> torch.Tensor:
    """Adaptive weighted decode: (B, 4J, F, F) map -> (B, J, 3) joints.

    Each joint is the softmax(30 * heatmap)-weighted mean over the F*F
    pixels of ``pixel (u, v, depth) + offset * (k - k * heatmap)``, with
    heatmap and offset zeroed on background pixels.  Computed in float32
    (a bfloat16 map is upcast, as the kernel does) or float64.
    """
    F = offset.shape[2]
    dtype = torch.promote_types(offset.dtype, torch.float32)
    return _softmax_decode(offset, resize_nearest(img, F),
                           *pixel_mesh(F, dtype, offset.device), kernel_size)


def offset2joint_softmax_rows(offset: torch.Tensor, img: torch.Tensor,
                              kernel_size: float, row0: int,
                              img_row0: int = 0,
                              img_rows: int | None = None):
    """The decode of a row window: ``offset`` (B, 4J, R, F) holds rows
    [row0, row0 + R) of an F x F map, ``img`` (B, h, W) rows [img_row0,
    img_row0 + h) of its (B, H, W) depth (H = ``img_rows``, default h).
    Returns ((B, J, 3) joints of the softmax over the window's R*F
    pixels, (B, J, 2) its statistics (max, sum)), which
    :func:`merge_softmax_bands` merges over the windows of a map.  The
    pixel coordinates 2(i + 0.5)/F - 1 and the nearest resize's source
    rows floor(i*H/F) are those of the global row i."""
    R, F = offset.shape[2:]
    dtype = torch.promote_types(offset.dtype, torch.float32)
    img_f = resize_nearest_rows(img, F, row0, R, img_row0, img_rows)
    mesh_x, mesh_y = pixel_mesh(F, dtype, offset.device)
    return (_softmax_decode(offset, img_f, mesh_x[row0:row0 + R],
                            mesh_y[row0:row0 + R], kernel_size),
            _softmax_stats(offset, img_f))


def merge_softmax_bands(parts):
    """Merge the decodes of a map's row windows (each ``(joints, stats)``
    of :func:`offset2joint_softmax_rows`, on one device; empty windows
    left out) into the whole map's ``(joints, stats)``: with m the max
    of the windows' maxima, each window's weight is w_b = s_b exp(m_b -
    m), the sum s = sum_b w_b and the joints sum_b joints_b w_b / s (a
    window's joints are its unnormalized weighted sum over s_b)."""
    m = torch.stack([st[..., 0] for _, st in parts]).amax(0)
    w = [st[..., 1] * torch.exp(st[..., 0] - m) for _, st in parts]
    s = sum(w)
    out = sum(o * wb[..., None] for (o, _), wb in zip(parts, w))
    return out / s[..., None], torch.stack([m, s], dim=-1)


def joint2offset(jt_uvd: torch.Tensor, img: torch.Tensor,
                 kernel_size: float, feature_size: int) -> torch.Tensor:
    """GT dense field: (B, J, 3) normalized joints + (B, H, W) depth ->
    (B, 4J, F, F) in the joints' dtype.

    Per pixel and joint: ``off = joint - (x, y, depth)``, ``dis =
    sqrt(|off|^2 + 1e-8)``, ``ht = (k - dis) / k``; both the unit offsets
    (3J channels) and ``ht`` (J channels) are zeroed outside ``ht >= 0``
    and the foreground.  ``(k - dis) / k`` is spelled as the reference
    spells it: the mask tests the rounded value.
    """
    B, J, _ = jt_uvd.shape
    F = feature_size
    dtype = jt_uvd.dtype
    img_f = resize_nearest(img, F).to(dtype)[:, None]  # (B, 1, F, F)
    mesh_x, mesh_y = pixel_mesh(F, dtype, jt_uvd.device)
    jt = jt_uvd[..., None, None]  # (B, J, 3, 1, 1)
    dx = jt[:, :, 0] - mesh_x
    dy = jt[:, :, 1] - mesh_y
    dz = jt[:, :, 2] - img_f  # each (B, J, F, F)
    dis = torch.sqrt(dx * dx + dy * dy + dz * dz + DIS_EPS)
    ht = (kernel_size - dis) / kernel_size
    mask = ((ht >= 0) & (img_f < FG_THRESHOLD)).to(dtype)
    vec = torch.stack([dx / dis, dy / dis, dz / dis], dim=2) * mask[:, :, None]
    return torch.cat([vec.reshape(B, 3 * J, F, F), ht * mask], dim=1)


def offset2joint_softmax_stats(offset: torch.Tensor,
                               img: torch.Tensor) -> torch.Tensor:
    """The decode's softmax statistics: (B, 4J, F, F) map + (B, H, W)
    depth -> (B, J, 2), for each joint the max ``m`` over the F*F pixels
    of the masked logit ``30 * heatmap * mask`` and ``s = sum exp(logit -
    m)``, in float32 (a bfloat16 map is upcast) or float64.  The CUDA
    decode writes them beside the joints, and its backward reads them."""
    return _softmax_stats(offset, resize_nearest(img, offset.shape[2]))


def offset2joint_softmax_backward(offset: torch.Tensor, img: torch.Tensor,
                                  kernel_size: float, grad_out: torch.Tensor,
                                  stats: torch.Tensor | None = None
                                  ) -> torch.Tensor:
    """Gradient of :func:`offset2joint_softmax` with respect to ``offset``
    for the cotangent ``grad_out`` (B, J, 3), in closed form; returned in
    the map's dtype.  With m the foreground mask, h = H m, w =
    softmax(30 h), dis = k - k h, v = V m, c = (x, y, depth) and
    out = sum_p w (v dis + c):

      dL/dV_p[a] = m g_a w_p dis_p
      dL/dH_p    = m w_p (-k g.v_p + 30 (g.(v_p dis_p + c_p) - g.out))

    Given the forward's ``stats`` (:func:`offset2joint_softmax_stats`),
    w = exp(30 h - max) / sum from them, as the CUDA backward takes it.
    """
    B, C, F, _ = offset.shape
    J = C // 4
    P = F * F
    dtype = torch.promote_types(offset.dtype, torch.float32)
    img_f = resize_nearest(img, F).to(dtype).reshape(B, 1, 1, P)
    mesh_x, mesh_y = pixel_mesh(F, dtype, offset.device)
    coords = torch.cat([mesh_x.reshape(1, 1, 1, P).expand(B, 1, 1, P),
                        mesh_y.reshape(1, 1, 1, P).expand(B, 1, 1, P),
                        img_f], dim=2)  # (B, 1, 3, P)
    mask = (img_f < FG_THRESHOLD).to(dtype)  # (B, 1, 1, P)
    off = offset.to(dtype).reshape(B, C, P)
    vec = off[:, :3 * J].reshape(B, J, 3, P) * mask
    ht = off[:, 3 * J:] * mask[:, 0]  # (B, J, P)
    if stats is None:
        w = torch.softmax(ht * SOFTMAX_TEMP, dim=-1)
    else:
        st = stats.to(dtype)[..., None]  # (B, J, 2, 1)
        w = torch.exp(ht * SOFTMAX_TEMP - st[:, :, 0]) / st[:, :, 1]
    dis = kernel_size - ht * kernel_size
    g = grad_out.to(dtype)[..., None]  # (B, J, 3, 1)
    term = vec * dis[:, :, None] + coords  # (B, J, 3, P)
    g_term = (g * term).sum(2)  # (B, J, P)
    g_out = (g_term * w).sum(-1, keepdim=True)  # g . out, (B, J, 1)
    g_vec = g * (w * dis)[:, :, None] * mask
    g_ht = mask[:, 0] * w * (-kernel_size * (g * vec).sum(2)
                             + SOFTMAX_TEMP * (g_term - g_out))
    grad = torch.cat([g_vec.reshape(B, 3 * J, P), g_ht], dim=1)
    return grad.reshape(B, C, F, F).to(offset.dtype)
