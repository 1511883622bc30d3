"""Crop, augmentation and normalization in plain PyTorch and numpy
(reference loader.py:19-260, nyu_loader.py:38-66).

Crop parameters are computed on the host in float64 (the reference's
``int()`` truncations sit on integer boundaries that float32 can land on
the wrong side of); the crop is a batched gather whose nearest index is
OpenCV's ``floor(x * (1 / (sw / w)))`` in double; the z-threshold maps
nonzero depth below zstart to zstart and above zend to 0; normalize maps
{0, the crop's max} to the background ``center_z + cube_z / 2`` and clips
to the cube.  Training's one-of-four augmentation (translate, scale,
rotate, none) computes every branch for the batch and selects each
sample's with ``torch.where``.
"""

from __future__ import annotations

import numpy as np
import torch


def augment_seed(seed: int, epoch: int, step: int) -> int:
    """The augmentation generator's seed for (seed, epoch, step)."""
    return (seed * 1_000_003 ** 2 + epoch * 1_000_003 + step) % 2 ** 63


def draw_augment_params(generator: torch.Generator, batch: int,
                        sigma_trans: float, sigma_scale: float,
                        sigma_rot: float):
    """(op (B,) in {0..3}, trans (B, 3) N(0, s_t), scale (B,) |1 + N(0,
    s_s)|, rot (B,) U[-s_r, s_r)) on ``generator``'s device, drawn in this
    order (reference loader.py:53-73)."""
    kw = dict(generator=generator, device=generator.device)
    op = torch.randint(0, 4, (batch,), **kw)
    trans = torch.randn(batch, 3, **kw) * sigma_trans
    scale = torch.abs(1.0 + torch.randn(batch, **kw) * sigma_scale)
    rot = torch.rand(batch, **kw) * (2 * sigma_rot) - sigma_rot
    return op, trans, scale, rot


# ------------------------------------------------------------ geometry

def xyz2uvd_np(pts, paras, flip):
    pts = np.asarray(pts, np.float32)
    fx, fy, u0, v0 = paras
    out = np.empty_like(pts)
    out[..., 0] = pts[..., 0] * fx / pts[..., 2] + u0
    out[..., 1] = pts[..., 1] * flip * fy / pts[..., 2] + v0
    out[..., 2] = pts[..., 2]
    return out


def xyz2uvd(pts, paras, flip):
    pts = pts.to(torch.float32)
    fx, fy, u0, v0 = paras[0], paras[1], paras[2], paras[3]
    x, y, z = pts[..., 0], pts[..., 1] * flip, pts[..., 2]
    return torch.stack([x * fx / z + u0, y * fy / z + v0, z], dim=-1)


def uvd2xyz(pts, paras, flip):
    pts = pts.to(torch.float32)
    fx, fy, u0, v0 = paras[0], paras[1], paras[2], paras[3]
    u, v, d = pts[..., 0], pts[..., 1], pts[..., 2]
    return torch.stack([(u - u0) * d / fx, (v - v0) * d / fy * flip, d],
                       dim=-1)


def transform_uv(jt_uvd, M):
    u, v = jt_uvd[..., 0], jt_uvd[..., 1]
    row = lambda i: (M[:, i, 0, None] * u + M[:, i, 1, None] * v  # noqa: E731
                     + M[:, i, 2, None])
    w = row(2)
    return torch.stack([row(0) / w, row(1) / w, jt_uvd[..., 2]], dim=-1)


def rotate_pts_uv(pts, center, angle_deg):
    a = (angle_deg * np.pi / 180.0)[:, None]
    ca, sa = torch.cos(a), torch.sin(a)
    cu, cv = center[:, 0, None], center[:, 1, None]
    du, dv = pts[..., 0] - cu, pts[..., 1] - cv
    return torch.stack([du * ca - dv * sa + cu, du * sa + dv * ca + cv,
                        pts[..., 2]], dim=-1)


# ---------------------------------------------------------------- crop

def crop_params(centers_uvd, cubes, paras, dsize: int) -> dict:
    """(B,) crop bounds, clip depths, resized size and paste offsets, and
    the (B, 3, 3) crop affine "M", in float64 on the host."""
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
    M = np.zeros((len(c), 3, 3), np.float64)
    M[:, 0, 0] = M[:, 1, 1] = scale
    M[:, 0, 2] = -us * scale + tx
    M[:, 1, 2] = -vs * scale + ty
    M[:, 2, 2] = 1.0
    return dict(us=us, ue=ue, vs=vs, ve=ve, zs=zs, ze=ze, sw=sw, sh=sh,
                tx=tx, ty=ty, M=M.astype(np.float32))


def _z_threshold(val, zstart, zend):
    nz = val != 0
    val = torch.where(nz & (val < zstart), zstart, val)
    return torch.where(nz & (val > zend), torch.zeros_like(val), val)


def crop_gather(imgs, p, dsize: int):
    """Raw (B, H0, W0) mm frames -> (B, dsize, dsize) mm crops; ``p``
    holds :func:`crop_params`' arrays as tensors on the frames' device."""
    B, H0, W0 = imgs.shape
    dev = imgs.device
    col = lambda k: p[k].view(B, 1, 1)  # noqa: E731
    us, ue, vs, ve = col("us"), col("ue"), col("vs"), col("ve")
    sw, sh, tx, ty = col("sw"), col("sh"), col("tx"), col("ty")
    ii = torch.arange(dsize, dtype=torch.int32, device=dev).view(1, dsize, 1)
    jj = torch.arange(dsize, dtype=torch.int32, device=dev).view(1, 1, dsize)
    in_paste = (ii >= ty) & (ii < ty + sh) & (jj >= tx) & (jj < tx + sw)
    cu = torch.minimum(torch.floor(
        (jj - tx).double() * (1.0 / (torch.clamp(sw, min=1).double()
                                     / (ue - us).double()))
    ).to(torch.int32), ue - us - 1)
    cv = torch.minimum(torch.floor(
        (ii - ty).double() * (1.0 / (torch.clamp(sh, min=1).double()
                                     / (ve - vs).double()))
    ).to(torch.int32), ve - vs - 1)
    su, sv = us + cu, vs + cv
    in_img = (su >= 0) & (su < W0) & (sv >= 0) & (sv < H0)
    b = torch.arange(B, device=dev).view(B, 1, 1)
    val = imgs[b, sv.clamp(0, H0 - 1).long(), su.clamp(0, W0 - 1).long()]
    zero = torch.zeros((), dtype=val.dtype, device=dev)
    val = torch.where(in_img, val, zero)
    val = _z_threshold(val, p["zs"].view(B, 1, 1), p["ze"].view(B, 1, 1))
    return torch.where(in_paste, val, zero)


def normalize(img, depth_max, center_z, cube_z):
    bg = center_z + cube_z / 2.0
    img = torch.where((img == depth_max) | (img == 0), bg, img)
    img = torch.clamp(img, center_z - cube_z / 2.0, bg)
    return (img - center_z) / (cube_z / 2.0)


def to_device(p_np: dict, device) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in p_np.items()}


def eval_crops(imgs, centers_uvd, cubes, paras, dsize: int):
    """Raw (B, H0, W0) frames on a device -> ((B, dsize, dsize) normalized
    crops, (B, 3, 3) float64 host crop affines)."""
    p_np = crop_params(centers_uvd, cubes, paras, dsize)
    M = p_np.pop("M")
    p = to_device(p_np, imgs.device)
    B = imgs.shape[0]
    crop = crop_gather(imgs, p, dsize)
    cz = torch.from_numpy(np.asarray(centers_uvd)[:, 2].astype(np.float32))
    cb = torch.from_numpy(np.asarray(cubes)[:, 2].astype(np.float32))
    return (normalize(crop, crop.amax(dim=(1, 2), keepdim=True),
                      cz.to(imgs.device).view(B, 1, 1),
                      cb.to(imgs.device).view(B, 1, 1)),
            M.astype(np.float64))


# ------------------------------------------------------- train augment

def _bounds_f32(center_uvd, cube, paras):
    fx, fy = paras[0], paras[1]
    cz = center_uvd[:, 2]
    half_u = (cube[:, 0] / 2.0) / cz * fx
    half_v = (cube[:, 1] / 2.0) / cz * fy
    bound = lambda x: torch.trunc(x + 0.5).to(torch.int32)  # noqa: E731
    return (bound(center_uvd[:, 0] - half_u), bound(center_uvd[:, 0] + half_u),
            bound(center_uvd[:, 1] - half_v), bound(center_uvd[:, 1] + half_v),
            cz - cube[:, 2] / 2.0, cz + cube[:, 2] / 2.0)


def _transmat_f32(ustart, uend, vstart, vend, dsize: int):
    w = (uend - ustart).to(torch.float32)
    h = (vend - vstart).to(torch.float32)
    scale = torch.minimum(dsize / w, dsize / h)
    sw, sh = torch.trunc(w * scale), torch.trunc(h * scale)
    tx = torch.floor(dsize / 2.0 - sw / 2.0)
    ty = torch.floor(dsize / 2.0 - sh / 2.0)
    zero, one = torch.zeros_like(scale), torch.ones_like(scale)
    return torch.stack([
        torch.stack([scale, zero, -ustart * scale + tx], -1),
        torch.stack([zero, scale, -vstart * scale + ty], -1),
        torch.stack([zero, zero, one], -1)], 1)


def _inv3(A):
    return torch.linalg.inv_ex(A).inverse


def _bilinear_sample(img, x, y):
    B, H, W = img.shape
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    x0i, y0i = x0.to(torch.int32), y0.to(torch.int32)
    flat = img.reshape(B, H * W)

    def tap(yi, xi):
        ok = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        idx = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        v = flat.gather(1, idx.reshape(B, -1).long()).reshape(idx.shape)
        return torch.where(ok, v, torch.zeros_like(v))

    v00, v01 = tap(y0i, x0i), tap(y0i, x0i + 1)
    v10, v11 = tap(y0i + 1, x0i), tap(y0i + 1, x0i + 1)
    return ((v00 * (1 - fx) + v01 * fx) * (1 - fy)
            + (v10 * (1 - fx) + v11 * fx) * fy)


def _warp_affine_inv(img, A_inv, dsize: int):
    r = torch.arange(dsize, dtype=torch.float32, device=img.device)
    ii, jj = r.view(1, dsize, 1), r.view(1, 1, dsize)
    a = lambda i, j: A_inv[:, i, j].view(-1, 1, 1)  # noqa: E731
    sx = a(0, 0) * jj + a(0, 1) * ii + a(0, 2)
    sy = a(1, 0) * jj + a(1, 1) * ii + a(1, 2)
    return _bilinear_sample(img, sx, sy)


def _recrop(img, center_uvd, cube, new_M, M_inv, paras, dsize: int):
    A_inv = _inv3(new_M @ M_inv)
    inf = torch.full_like(img, float("inf"))
    nv_val = (torch.where(img > 0, img, inf).amin(dim=(1, 2)) - 1.0
              ).view(-1, 1, 1)
    out = _warp_affine_inv(img, A_inv, dsize)
    out = torch.where(out < nv_val, torch.zeros_like(out), out)
    zs, ze = _bounds_f32(center_uvd, cube, paras)[4:]
    return _z_threshold(out, zs.view(-1, 1, 1), ze.view(-1, 1, 1))


def _rotation(rot, dsize: int):
    r = torch.remainder(rot, 360.0)
    a = -r * np.pi / 180.0
    ca, sa = torch.cos(a), torch.sin(a)
    c = dsize // 2
    zero, one = torch.zeros_like(a), torch.ones_like(a)
    A = torch.stack([
        torch.stack([ca, sa, (1 - ca) * c - sa * c], -1),
        torch.stack([-sa, ca, sa * c + (1 - ca) * c], -1),
        torch.stack([zero, zero, one], -1)], 1)
    return A, r


def _augment(img, jt_xyz, center_uvd, cube, M, paras, flip, aug, dsize):
    op, trans, scale, rot = aug
    B = img.shape[0]
    depth_max = img.amax(dim=(1, 2))
    M_inv = _inv3(M)
    cz_nonzero = ~torch.isclose(center_uvd[:, 2],
                                torch.zeros_like(center_uvd[:, 2]))
    center_xyz = uvd2xyz(center_uvd, paras, flip)

    c_t = xyz2uvd(center_xyz + trans, paras, flip)
    M_t = _transmat_f32(*_bounds_f32(c_t, cube, paras)[:4], dsize)
    ok_t = cz_nonzero | torch.isclose(c_t[:, 2], torch.zeros_like(c_t[:, 2]))
    img_t = _recrop(img, c_t, cube, M_t, M_inv, paras, dsize)
    jt_t = (jt_xyz + center_xyz[:, None]
            - uvd2xyz(c_t, paras, flip)[:, None])

    cube_s = cube * scale[:, None]
    M_s = _transmat_f32(*_bounds_f32(center_uvd, cube_s, paras)[:4], dsize)
    img_s = _recrop(img, center_uvd, cube_s, M_s, M_inv, paras, dsize)

    A_r, r = _rotation(rot, dsize)
    img_r = _warp_affine_inv(img, _inv3(A_r), dsize)
    jt_uvd = rotate_pts_uv(xyz2uvd(jt_xyz + center_xyz[:, None], paras, flip),
                           center_uvd, r)
    jt_r = uvd2xyz(jt_uvd, paras, flip) - center_xyz[:, None]

    is_op = [(op == i) for i in range(3)]
    sel = lambda k, a, b: torch.where(  # noqa: E731
        k.view((B,) + (1,) * (a.dim() - 1)), a, b)
    use_t, use_s = is_op[0] & ok_t, is_op[1] & cz_nonzero
    img = sel(use_t, img_t, sel(use_s, img_s, sel(is_op[2], img_r, img)))
    M = sel(use_t, M_t, sel(use_s, M_s, M))
    jt_xyz = sel(is_op[0], jt_t, sel(is_op[2], jt_r, jt_xyz))
    cube = sel(is_op[1], cube_s, cube)
    center_uvd = sel(is_op[0], c_t, center_uvd)
    img = normalize(img, depth_max.view(B, 1, 1),
                    center_uvd[:, 2].view(B, 1, 1), cube[:, 2].view(B, 1, 1))
    return img, jt_xyz, cube, center_uvd, M


def train_batch(imgs, jt_xyz, centers_xyz, cubes, paras, flip, aug,
                dsize: int):
    """Raw (B, H0, W0) mm frames on a device, (B, J, 3) absolute mm joints
    and (B, 3) host centers and cubes -> ((B, dsize, dsize) augmented
    normalized crops, (B, J, 3) normalized uvd labels)."""
    dev = imgs.device
    centers_uvd = xyz2uvd_np(centers_xyz, paras, flip).astype(np.float64)
    p = to_device(crop_params(centers_uvd, cubes, paras, dsize), dev)
    f32 = lambda a: torch.as_tensor(  # noqa: E731
        np.asarray(a, np.float32)).to(dev)
    paras_t = f32(paras)
    c_uvd, cube = f32(centers_uvd), f32(cubes)
    jt = f32(jt_xyz) - uvd2xyz(c_uvd, paras_t, flip)[:, None]
    crop = crop_gather(imgs, p, dsize)
    img, jt, cube, c_uvd, M = _augment(crop, jt, c_uvd, cube, p["M"],
                                       paras_t, flip, aug, dsize)
    center_xyz = uvd2xyz(c_uvd, paras_t, flip)
    px = transform_uv(xyz2uvd(jt + center_xyz[:, None], paras_t, flip), M)
    jt_uvd = torch.stack(
        [px[..., 0] / (dsize / 2.0) - 1, px[..., 1] / (dsize / 2.0) - 1,
         (px[..., 2] - center_xyz[:, None, 2]) / (cube[:, None, 2] / 2.0)],
        -1)
    return img, jt_uvd


def to_normalized(joints_cam, M, centers_uvd, cubes, dsize: int):
    """Camera (u px, v px, d mm) joints (B, J, 3) -> normalized crop uvd,
    through the (B, 3, 3) crop affines ``M`` (float64, host)."""
    j = np.asarray(joints_cam, np.float64)
    uv1 = np.concatenate([j[..., :2], np.ones_like(j[..., :1])], -1)
    uv = np.einsum("bij,bkj->bki", np.asarray(M, np.float64), uv1)
    out = np.empty_like(j)
    out[..., :2] = uv[..., :2] / (dsize / 2.0) - 1.0
    cz = np.asarray(centers_uvd, np.float64)[:, 2]
    cb = np.asarray(cubes, np.float64)[:, 2]
    out[..., 2] = (j[..., 2] - cz[:, None]) / (cb[:, None] / 2.0)
    return out
