"""Device-side depth preprocessing: the eval and serving crop, and the
train path's crop, one-of-four augmentation and label normalization.

The reference crops, z-clips, NEAREST-resizes, center-pads and
normalizes each frame on the host (loader.py:19-51,88-101).  Here that
chain is one batched gather per output pixel on the frames' device; only
the scalar crop parameters are computed on the host, in float64
(:func:`awr_tpu_torch.data.transforms.crop_params_np`).  The serving crop
also reads frames packed down to the windows it can read
(:mod:`awr_tpu_torch.data.windows`), with the same result.

Semantics:
- NEAREST resize uses OpenCV's index, ``src = min(floor(dst * (1 /
  (dst_n / n))), n - 1)`` in double, so the crop is the host crop's bit
  for bit (the JAX package's device crop takes the float32 quotient,
  which differs for a few crop sizes; ROADMAP queue 3);
- the z-threshold maps nonzero depth below zstart to zstart and above
  zend to 0 (loader.py:202-205);
- normalize maps {exact 0, exact crop max} to background
  ``center_z + cube_z/2`` then clips to the cube (loader.py:88-101).

Every other step is float32 in the same order of operations as the JAX
package's spelling.

Train-time augmentation (choose one of {trans, scale, rot, none},
loader.py:53-86) is a batch of inverse-affine bilinear gathers.  As in
the JAX package (which vmaps ``lax.switch``), every branch is computed
for the whole batch and each sample selects its own with
``torch.where``; no Python loop runs over samples and nothing waits on
the host (3x3 inverses go through ``torch.linalg.inv_ex``).  Warped
pixels agree with the JAX package to rounding, labels to float32
rounding, and op 3 (none) bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from awr_tpu_torch.data.transforms import crop_params_np
from awr_tpu_torch.geometry import (rotate_pts_uv, transform_uv, uvd2xyz,
                                    xyz2uvd)


def _z_threshold(val, zstart, zend):
    nz = val != 0
    val = torch.where(nz & (val < zstart), zstart, val)
    return torch.where(nz & (val > zend), torch.zeros_like(val), val)


def _crop_gather(imgs, p, dsize: int, win=None):
    """Crop raw (B, H0, W0) mm frames to (B, dsize, dsize) mm (before
    normalization).  ``p`` holds the (B,) crop parameters as tensors on
    the frames' device.

    ``win``: None, or ``imgs`` is the flat buffer of the frames' packed
    crop windows (:mod:`awr_tpu_torch.data.windows`) and ``win`` holds
    their (B,) ``v0 u0 h w base`` as tensors there and the frames' size
    ``hw``.  Pixel (sv, su) of frame b is then read at ``base + (sv - v0)
    * w + (su - u0)``, the row and column clamped into the window: the
    crop is the full frames' bit for bit."""
    if win is None:
        B, H0, W0 = imgs.shape
    else:
        B, (H0, W0) = p["us"].shape[0], win["hw"]
    dev = imgs.device
    col = lambda k: p[k].view(B, 1, 1)  # noqa: E731
    us, ue, vs, ve = col("us"), col("ue"), col("vs"), col("ve")
    sw, sh, tx, ty = col("sw"), col("sh"), col("tx"), col("ty")
    ii = torch.arange(dsize, dtype=torch.int32, device=dev).view(1, dsize, 1)
    jj = torch.arange(dsize, dtype=torch.int32, device=dev).view(1, 1, dsize)
    in_paste = (ii >= ty) & (ii < ty + sh) & (jj >= tx) & (jj < tx + sw)

    # OpenCV's nearest index, in double as it computes it: floor(x * (1 /
    # (sw / w))).  The float32 quotient x * w / sw is exact where x * w
    # is a multiple of sw, and OpenCV's product can fall just under it
    # (w = 186, sw = 128, x = 64: 93 against 92.99999999999999)
    crop_w = (ue - us).double()
    crop_h = (ve - vs).double()
    cu = torch.minimum(
        torch.floor((jj - tx).double()
                    * (1.0 / (torch.clamp(sw, min=1).double() / crop_w))
                    ).to(torch.int32),
        ue - us - 1)
    cv = torch.minimum(
        torch.floor((ii - ty).double()
                    * (1.0 / (torch.clamp(sh, min=1).double() / crop_h))
                    ).to(torch.int32),
        ve - vs - 1)
    su = us + cu
    sv = vs + cv
    in_img = (su >= 0) & (su < W0) & (sv >= 0) & (sv < H0)
    if win is None:
        b = torch.arange(B, device=dev).view(B, 1, 1)
        val = imgs[b, sv.clamp(0, H0 - 1).long(),
                   su.clamp(0, W0 - 1).long()]
    else:
        v0, u0, h, w = (win[k].view(B, 1, 1) for k in ("v0", "u0", "h", "w"))
        # (B, dsize, 1) rows and (B, 1, dsize) columns of the window
        r = torch.minimum(sv - v0, h - 1).clamp(min=0)
        c = torch.minimum(su - u0, w - 1).clamp(min=0)
        val = imgs[win["base"].view(B, 1, 1) + (r * w).long() + c.long()]
    zero = torch.zeros((), dtype=val.dtype, device=dev)
    val = torch.where(in_img, val, zero)
    val = _z_threshold(val, p["zs"].view(B, 1, 1), p["ze"].view(B, 1, 1))
    return torch.where(in_paste, val, zero)


def normalize(img, depth_max, center_z, cube_z):
    """mm depth -> [-1, 1], background -> +1 (reference loader.py:88-101).
    All arguments broadcast against ``img``."""
    bg = center_z + cube_z / 2.0
    img = torch.where((img == depth_max) | (img == 0), bg, img)
    img = torch.clamp(img, center_z - cube_z / 2.0, bg)
    return (img - center_z) / (cube_z / 2.0)


def upload(a, device) -> torch.Tensor:
    """A host array on ``device``.  On a GPU it goes through pinned memory
    and a ``non_blocking`` copy on the current stream, so the host does not
    wait for the work already queued there (a copy from pageable memory
    does).  The pinned block comes from PyTorch's caching host allocator,
    which keeps it until the copy has run."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def upload_columns(cols: dict, device) -> dict:
    """Each (B,) host array of ``cols`` on ``device``, in one
    :func:`upload` for each dtype: the arrays of a dtype stacked, and
    their rows returned by name."""
    out = {}
    for dt in dict.fromkeys(np.dtype(v.dtype) for v in cols.values()):
        keys = [k for k, v in cols.items() if v.dtype == dt]
        out.update(zip(keys, upload(np.stack([cols[k] for k in keys]),
                                    device)))
    return out


def crop_param_tensors(centers_uvd, cubes, paras, dsize: int, device):
    """:func:`crop_params_np` (float64 on the host) as tensors on
    ``device``: the (B,) bounds, clip depths and paste geometry, and the
    (B, 3, 3) float32 crop affine under "M"."""
    p_np = crop_params_np(np.asarray(centers_uvd), np.asarray(cubes),
                          np.asarray(paras), dsize)
    return {k: upload(v, device) for k, v in p_np.items()}


def crop_normalize_batch(imgs, centers_uvd, cubes, paras, dsize: int):
    """Eval-path preprocessing for a batch of raw frames.

    Args:
      imgs: (B, H0, W0) float32 raw mm depth, a tensor on the device the
        crop runs on.
      centers_uvd: (B, 3) host array; cubes: (B, 3); paras: intrinsics.
        They go to the device without a host sync (:func:`upload`).
    Returns:
      (B, dsize, dsize) float32 normalized depth on ``imgs.device``, and
      the (B, 3, 3) crop affine M as a host float32 array.
    """
    centers_uvd = np.asarray(centers_uvd)
    cubes = np.asarray(cubes)
    p_np = crop_params_np(centers_uvd, cubes, np.asarray(paras), dsize)
    M = p_np.pop("M")
    return crop_normalize_params(imgs, p_np, centers_uvd, cubes, dsize), M


def crop_normalize_params(imgs, p_np: dict, centers_uvd, cubes, dsize: int,
                          windows=None):
    """:func:`crop_normalize_batch` past the host's crop parameters
    ``p_np`` (:func:`crop_params_np`'s, without "M"), which go to the
    device with the depths in one upload a dtype.

    ``windows``: None for (B, H0, W0) frames; or ``imgs`` is the flat
    buffer that :func:`awr_tpu_torch.data.windows.pack_windows` packed by
    these :class:`~awr_tpu_torch.data.windows.Windows`."""
    host = dict(p_np, center_z=np.asarray(centers_uvd)[:, 2].astype(
        np.float32), cube_z=np.asarray(cubes)[:, 2].astype(np.float32))
    if windows is not None:
        host.update(windows.columns())
    t = upload_columns(host, imgs.device)
    win = None if windows is None else dict(
        {k: t[k] for k in windows.columns()}, hw=windows.hw)
    return crop_normalize(imgs, {k: t[k] for k in p_np}, t["center_z"],
                          t["cube_z"], dsize, win)


def crop_normalize(imgs, p, center_z, cube_z, dsize: int, win=None):
    """Crop raw (B, H0, W0) mm frames with the (B,) crop parameters ``p``
    (:func:`crop_params_np`'s, without "M", as tensors on the frames'
    device) and normalize them about the (B,) float32 ``center_z`` and
    ``cube_z`` -> (B, dsize, dsize) float32 (the JAX package's
    ``_crop_normalize_kernel``).  ``win``: the packed frames' windows, as
    :func:`_crop_gather` takes them."""
    B = center_z.shape[0]
    crop = _crop_gather(imgs, p, dsize, win)
    depth_max = crop.amax(dim=(1, 2), keepdim=True)
    return normalize(crop, depth_max, center_z.view(B, 1, 1),
                     cube_z.view(B, 1, 1))


# --------------------------------------------------------------------------
# Train path: crop, choose-one augmentation, normalize, labels.
# --------------------------------------------------------------------------


def _bounds_f32(center_uvd, cube, paras):
    """(B,) trunc(x + 0.5) crop bounds and clip depths in float32 on the
    device (reference loader.py:181-188); used only for augmented
    re-crops."""
    fx, fy = paras[0], paras[1]
    cz = center_uvd[:, 2]
    half_u = (cube[:, 0] / 2.0) / cz * fx
    half_v = (cube[:, 1] / 2.0) / cz * fy
    bound = lambda x: torch.trunc(x + 0.5).to(torch.int32)  # noqa: E731
    return (bound(center_uvd[:, 0] - half_u), bound(center_uvd[:, 0] + half_u),
            bound(center_uvd[:, 1] - half_v), bound(center_uvd[:, 1] + half_v),
            cz - cube[:, 2] / 2.0, cz + cube[:, 2] / 2.0)


def _transmat_f32(ustart, uend, vstart, vend, dsize: int):
    """(B, 3, 3) float32 crop affines (reference loader.py:210-240)."""
    w = (uend - ustart).to(torch.float32)
    h = (vend - vstart).to(torch.float32)
    scale = torch.minimum(dsize / w, dsize / h)
    sw = torch.trunc(w * scale)
    sh = torch.trunc(h * scale)
    tx = torch.floor(dsize / 2.0 - sw / 2.0)
    ty = torch.floor(dsize / 2.0 - sh / 2.0)
    zero, one = torch.zeros_like(scale), torch.ones_like(scale)
    return torch.stack([
        torch.stack([scale, zero, -ustart * scale + tx], -1),
        torch.stack([zero, scale, -vstart * scale + ty], -1),
        torch.stack([zero, zero, one], -1)], 1)


def _inv3(A):
    """Batched 3x3 inverse without a host sync (no singularity check)."""
    return torch.linalg.inv_ex(A).inverse


def _bilinear_sample(img, x, y):
    """Bilinear sample of (B, H, W) images at float coords (B, h, w),
    border 0."""
    B, H, W = img.shape
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = x0.to(torch.int32)
    y0i = y0.to(torch.int32)
    flat = img.reshape(B, H * W)

    def tap(yi, xi):
        ok = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        idx = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        v = flat.gather(1, idx.reshape(B, -1).long()).reshape(idx.shape)
        return torch.where(ok, v, torch.zeros_like(v))

    v00 = tap(y0i, x0i)
    v01 = tap(y0i, x0i + 1)
    v10 = tap(y0i + 1, x0i)
    v11 = tap(y0i + 1, x0i + 1)
    return ((v00 * (1 - fx) + v01 * fx) * (1 - fy)
            + (v10 * (1 - fx) + v11 * fx) * fy)


def _warp_affine_inv(img, A_inv, dsize: int):
    """dst(i, j) = bilinear(src, A_inv @ (j, i, 1)), border 0, for (B, 3, 3)
    inverse affines."""
    r = torch.arange(dsize, dtype=torch.float32, device=img.device)
    ii, jj = r.view(1, dsize, 1), r.view(1, 1, dsize)
    a = lambda i, j: A_inv[:, i, j].view(-1, 1, 1)  # noqa: E731
    sx = a(0, 0) * jj + a(0, 1) * ii + a(0, 2)
    sy = a(1, 0) * jj + a(1, 1) * ii + a(1, 2)
    return _bilinear_sample(img, sx, sy)


def _recrop(img, center_uvd, cube, new_M, M_inv, paras, dsize: int):
    """Warp to the new crop, drop the warp's outliers, z-clip (reference
    loader.py:125-138)."""
    A_inv = _inv3(new_M @ M_inv)
    inf = torch.full_like(img, float("inf"))
    pos_min = torch.where(img > 0, img, inf).amin(dim=(1, 2))
    nv_val = (pos_min - 1.0).view(-1, 1, 1)
    out = _warp_affine_inv(img, A_inv, dsize)
    out = torch.where(out < nv_val, torch.zeros_like(out), out)
    zs, ze = _bounds_f32(center_uvd, cube, paras)[4:]
    return _z_threshold(out, zs.view(-1, 1, 1), ze.view(-1, 1, 1))


def _rotation(rot, dsize: int):
    """(B, 3, 3) forward affines of cv2 getRotationMatrix2D(center, -rot,
    1) about the crop center, and the angles taken mod 360."""
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


def augment(img, jt_xyz, center_uvd, cube, M, paras, flip: int, aug,
            dsize: int):
    """Batched device twin of reference loader.py:75-86 on mm-depth crops.

    Args:
      img: (B, S, S) mm crops; jt_xyz: (B, J, 3) center-relative mm
        joints; center_uvd, cube: (B, 3); M: (B, 3, 3) crop affines.
      aug: (op, trans, scale, rot) from :func:`draw_augment_params`; op
        indexes (trans, scale, rot, none).
    Returns:
      (normalized img, jt_xyz, cube, center_uvd, M) after each sample's op.
    """
    op, trans, scale, rot = aug
    B = img.shape[0]
    depth_max = img.amax(dim=(1, 2))
    M_inv = _inv3(M)
    cz_nonzero = ~torch.isclose(center_uvd[:, 2],
                                torch.zeros_like(center_uvd[:, 2]))
    center_xyz = uvd2xyz(center_uvd, paras, flip)

    # op 0: translate the crop center by trans mm
    c_t = xyz2uvd(center_xyz + trans, paras, flip)
    M_t = _transmat_f32(*_bounds_f32(c_t, cube, paras)[:4], dsize)
    ok_t = cz_nonzero | torch.isclose(c_t[:, 2], torch.zeros_like(c_t[:, 2]))
    img_t = _recrop(img, c_t, cube, M_t, M_inv, paras, dsize)
    jt_t = (jt_xyz + center_xyz[:, None]
            - uvd2xyz(c_t, paras, flip)[:, None])

    # op 1: scale the cube
    cube_s = cube * scale[:, None]
    M_s = _transmat_f32(*_bounds_f32(center_uvd, cube_s, paras)[:4], dsize)
    img_s = _recrop(img, center_uvd, cube_s, M_s, M_inv, paras, dsize)

    # op 2: rotate about the crop center
    A_r, r = _rotation(rot, dsize)
    img_r = _warp_affine_inv(img, _inv3(A_r), dsize)
    jt_uvd = rotate_pts_uv(xyz2uvd(jt_xyz + center_xyz[:, None], paras, flip),
                           center_uvd, r)
    jt_r = uvd2xyz(jt_uvd, paras, flip) - center_xyz[:, None]

    is_op = [(op == i) for i in range(3)]
    sel = lambda k, a, b: torch.where(  # noqa: E731
        k.view((B,) + (1,) * (a.dim() - 1)), a, b)
    use_t = is_op[0] & ok_t
    use_s = is_op[1] & cz_nonzero
    img = sel(use_t, img_t, sel(use_s, img_s, sel(is_op[2], img_r, img)))
    M = sel(use_t, M_t, sel(use_s, M_s, M))
    jt_xyz = sel(is_op[0], jt_t, sel(is_op[2], jt_r, jt_xyz))
    cube = sel(is_op[1], cube_s, cube)
    center_uvd = sel(is_op[0], c_t, center_uvd)
    img = normalize(img, depth_max.view(B, 1, 1),
                    center_uvd[:, 2].view(B, 1, 1), cube[:, 2].view(B, 1, 1))
    return img, jt_xyz, cube, center_uvd, M


def draw_augment_params(generator: torch.Generator, batch: int,
                        sigma_trans: float = 10.0, sigma_scale: float = 0.1,
                        sigma_rot: float = 180.0):
    """Reference loader.py:53-73 on ``generator``'s device: op (B,) int64
    uniform in {0, 1, 2, 3}, trans (B, 3) N(0, sigma_trans), scale (B,)
    |1 + N(0, sigma_scale)|, rot (B,) uniform in [-sigma_rot, sigma_rot).
    The same distributions as the JAX package's, another stream."""
    kw = dict(generator=generator, device=generator.device)
    op = torch.randint(0, 4, (batch,), **kw)
    trans = torch.randn(batch, 3, **kw) * sigma_trans
    scale = torch.abs(1.0 + torch.randn(batch, **kw) * sigma_scale)
    rot = torch.rand(batch, **kw) * (2 * sigma_rot) - sigma_rot
    return op, trans, scale, rot


def train_preprocess(imgs, jt_xyz, centers_uvd, cubes, paras, p, aug,
                     dsize: int, flip: int):
    """Train-path preprocessing of a batch of raw frames, all on their
    device (see :func:`train_preprocess_batch`); ``p`` holds the crop
    parameters from :func:`crop_param_tensors` and ``paras`` the
    intrinsics as a float32 tensor on the same device."""
    # absolute joints -> center-relative (reference nyu_loader.py:50)
    jt = jt_xyz - uvd2xyz(centers_uvd, paras, flip)[:, None]
    crop = _crop_gather(imgs, p, dsize)
    img, jt, cube, c_uvd, M = augment(crop, jt, centers_uvd, cubes, p["M"],
                                      paras, flip, aug, dsize)
    center_xyz = uvd2xyz(c_uvd, paras, flip)
    px = transform_uv(xyz2uvd(jt + center_xyz[:, None], paras, flip), M)
    jt_uvd = torch.stack(
        [px[..., 0] / (dsize / 2.0) - 1, px[..., 1] / (dsize / 2.0) - 1,
         (px[..., 2] - center_xyz[:, None, 2]) / (cube[:, None, 2] / 2.0)],
        -1)
    return dict(img=img, jt_xyz=jt / (cube[:, None] / 2.0), jt_uvd=jt_uvd,
                center_xyz=center_xyz, M=M, cube=cube)


def train_preprocess_batch(imgs, jt_xyz, centers_uvd, cubes, paras, aug,
                           dsize: int, flip: int):
    """Train-path preprocessing (reference nyu_loader.py:38-66): crop ->
    one-of-four augment -> normalize -> normalized labels.

    Args:
      imgs: (B, H0, W0) float32 raw mm depth, a tensor on the device the
        work runs on; jt_xyz: (B, J, 3) absolute mm joints;
        centers_uvd, cubes: (B, 3) host arrays; paras: intrinsics;
        aug: (op, trans, scale, rot) tensors on ``imgs.device``.
    Returns dict with img (B, S, S), jt_xyz and jt_uvd (B, J, 3)
    normalized, center_xyz (B, 3), M (B, 3, 3), cube (B, 3).
    """
    dev = imgs.device
    f32 = lambda a: torch.as_tensor(  # noqa: E731
        np.asarray(a, np.float32)).to(dev)
    p = crop_param_tensors(centers_uvd, cubes, paras, dsize, dev)
    return train_preprocess(imgs, f32(jt_xyz), f32(centers_uvd), f32(cubes),
                            f32(paras), p, aug, dsize, flip)
