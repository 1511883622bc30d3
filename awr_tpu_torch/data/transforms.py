"""The host crop chain (reference loader.py:19-260; the JAX package's
``data/transforms.py``): ``CameraCrop``, the reference's crop, one-of-four
augmentation and normalization in numpy, the crop parameters of the
device crop, and label normalization (nyu_loader.py:61-64).

Every observable quirk of the reference is kept, because it shifts crops
by up to a pixel and is baked into the reference's trained models and
golden prediction files:

- ``center2bounds`` adds 0.5 then truncates with ``int()`` (ref :183-188);
- the crop resize is OpenCV's INTER_NEAREST with ``min(dsize/w,
  dsize/h)`` scale and truncated target size (ref :38-40);
- center padding offsets are ``int()``-truncated (ref :43-47, :237-238);
- z-thresholding maps depth below zstart to zstart and above zend to 0,
  only for nonzero pixels (ref :202-205);
- ``normalize`` first maps pixels equal to the pre-augment max AND exact
  zeros to background ``center_z + cube_z/2`` (ref :88-101);
- augmentation picks ONE of {trans, scale, rot, none} per sample
  (ref :63-64) from a ``np.random.RandomState(23455)`` stream (ref :11).

OpenCV's resize, rotation matrix and warps are the numpy emulations of
:mod:`awr_tpu_torch.data.cvwarp`, bit-equal to ``cv2`` on the crops.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from awr_tpu_torch.data import cvwarp
from awr_tpu_torch.geometry import rotate_pts_uv_np, uvd2xyz_np, xyz2uvd_np

AUG_OPS = ("trans", "scale", "rot", None)


@dataclasses.dataclass
class CameraCrop:
    """Perspective-aware hand-cube cropper for one camera."""

    paras: Tuple[float, float, float, float]
    flip: int
    img_size: int = 128

    # ------------------------------------------------------------ bounds
    def center2bounds(self, center_uvd, cube):
        """(ustart, uend, vstart, vend, zstart, zend); u/v ``int()``-truncated
        after +0.5 (reference loader.py:181-188)."""
        c = np.asarray(center_uvd, np.float64)
        cube = np.asarray(cube, np.float64)
        fx, fy = self.paras[0], self.paras[1]
        ustart = int(c[0] - (cube[0] / 2.0) / c[2] * fx + 0.5)
        uend = int(c[0] + (cube[0] / 2.0) / c[2] * fx + 0.5)
        vstart = int(c[1] - (cube[1] / 2.0) / c[2] * fy + 0.5)
        vend = int(c[1] + (cube[1] / 2.0) / c[2] * fy + 0.5)
        zstart = float(c[2] - cube[2] / 2.0)
        zend = float(c[2] + cube[2] / 2.0)
        return ustart, uend, vstart, vend, zstart, zend

    def bounds2crop(self, img, ustart, uend, vstart, vend, zstart, zend,
                    thresh_z=True, bg=0):
        """Slice-and-pad crop + z-threshold (reference loader.py:190-207)."""
        h, w = img.shape[:2]
        out = np.full((vend - vstart, uend - ustart), bg, img.dtype)
        sv0, sv1 = max(vstart, 0), min(vend, h)
        su0, su1 = max(ustart, 0), min(uend, w)
        if sv1 > sv0 and su1 > su0:
            out[sv0 - vstart : sv1 - vstart, su0 - ustart : su1 - ustart] = (
                img[sv0:sv1, su0:su1]
            )
        if thresh_z:
            nz = out != 0
            out[np.logical_and(out < zstart, nz)] = zstart
            out[np.logical_and(out > zend, nz)] = 0
        return out

    # -------------------------------------------------------------- crop
    def crop(self, img, center_uvd, cube, dsize: Optional[int] = None):
        """Crop + NEAREST resize + center pad; returns (img, M)
        (reference loader.py:19-51)."""
        d = dsize or self.img_size
        us, ue, vs, ve, zs, ze = self.center2bounds(center_uvd, cube)
        cropped = self.bounds2crop(img, us, ue, vs, ve, zs, ze)

        w, h = (ue - us), (ve - vs)
        scale = min(d / w, d / h)
        size = (int(w * scale), int(h * scale))
        cropped = cvwarp.resize_nearest(cropped, size)

        res = np.zeros((d, d), np.float32)
        u0 = (d - size[0]) / 2.0
        v0 = (d - size[1]) / 2.0
        res[int(v0) : int(v0) + size[1], int(u0) : int(u0) + size[0]] = cropped
        return res, self.center2transmat(center_uvd, cube, d)

    def center2transmat(self, center_uvd, cube, dsize: Optional[int] = None):
        """Affine M = trans2 @ scale @ trans1 mapping original uv to crop
        pixels (reference loader.py:210-240)."""
        d = dsize or self.img_size
        us, ue, vs, ve, _, _ = self.center2bounds(center_uvd, cube)
        w, h = (ue - us), (ve - vs)
        scale = min(d / w, d / h)
        size = (int(w * scale), int(h * scale))

        M = np.eye(3, dtype=np.float64)
        M[0, 0] = M[1, 1] = scale
        M[0, 2] = -us * scale + int(np.floor(d / 2.0 - size[0] / 2.0))
        M[1, 2] = -vs * scale + int(np.floor(d / 2.0 - size[1] / 2.0))
        return M.astype(np.float32)

    # --------------------------------------------------------- normalize
    @staticmethod
    def normalize(depth_max, img, center_z, cube_z):
        """Map depth (mm) to [-1, 1]; bg (max-depth and zero pixels) -> +1
        (reference loader.py:88-101)."""
        img = img.copy()
        bg = center_z + cube_z / 2.0
        img[img == depth_max] = bg
        img[img == 0] = bg
        img = np.clip(img, center_z - cube_z / 2.0, bg)
        return ((img - center_z) / (cube_z / 2.0)).astype(np.float32)

    # ------------------------------------------------------ augmentation
    def random_aug(self, rng: np.random.RandomState,
                   sigma_trans=10.0, sigma_scale=0.1, sigma_rot=180.0):
        """Draw (op, trans, scale, rot); exactly 4 draws per call so the
        RNG stream matches the reference order (loader.py:53-73)."""
        aug_op = AUG_OPS[rng.randint(0, len(AUG_OPS))]
        trans = rng.randn(3) * sigma_trans
        scale = abs(1.0 + rng.randn() * sigma_scale)
        rot = rng.uniform(-sigma_rot, sigma_rot)
        return aug_op, trans, scale, rot

    def augment(self, img, jt_xyz, center_uvd, cube, M,
                aug_op, trans, scale, rot):
        """Apply ONE augmentation, then normalize with the pre-augment max
        (reference loader.py:75-86).  Returns (img, jt_xyz, cube,
        center_uvd, M)."""
        depth_max = img.max()
        cube = np.asarray(cube, np.float64)
        if aug_op == "trans":
            img, jt_xyz, center_uvd, M = self.translate(
                img, jt_xyz, center_uvd, cube, M, trans)
        elif aug_op == "rot":
            img, jt_xyz = self.rotate(img, jt_xyz, center_uvd, rot)
        elif aug_op == "scale":
            img, cube, M = self.scale(img, center_uvd, cube, M, scale)
        img = self.normalize(depth_max, img, center_uvd[2], cube[2])
        return img, jt_xyz, cube, center_uvd, M

    def translate(self, img, jt_xyz, center_uvd, cube, M, trans):
        """World-shift the crop center and re-crop (reference
        loader.py:103-122)."""
        if np.allclose(trans, 0.0):
            return img, jt_xyz, center_uvd, M
        center_xyz = uvd2xyz_np(center_uvd, self.paras, self.flip)
        new_center = xyz2uvd_np(center_xyz + trans, self.paras, self.flip)
        if (not np.allclose(center_uvd[2], 0.0)
                or np.allclose(new_center[2], 0.0)):
            new_M = self.center2transmat(new_center, cube, img.shape[0])
            img = self.recrop(img, new_center, cube, new_M,
                              np.linalg.inv(M), img.shape,
                              thresh_z=True, bg=0,
                              nv_val=np.min(img[img > 0]) - 1)
        else:
            new_M = M
        jt_xyz = jt_xyz + center_xyz - uvd2xyz_np(new_center, self.paras,
                                                  self.flip)
        return img, jt_xyz, new_center, new_M

    def rotate(self, img, jt_xyz, center_uvd, rot):
        """In-plane rotation of the crop + uv-rotation of the joints
        (reference loader.py:141-160)."""
        if np.allclose(rot, 0.0):
            return img, jt_xyz
        rot = np.mod(rot, 360)
        rotM = cvwarp.rotation_matrix_2d(
            (img.shape[1] // 2, img.shape[0] // 2), -rot, 1)
        img = cvwarp.warp_affine(img, rotM, (img.shape[1], img.shape[0]),
                                 border_value=0)
        center_xyz = uvd2xyz_np(center_uvd, self.paras, self.flip)
        jt_uvd = xyz2uvd_np(jt_xyz + center_xyz, self.paras, self.flip)
        jt_uvd = rotate_pts_uv_np(jt_uvd, center_uvd, rot)
        jt_xyz = uvd2xyz_np(jt_uvd, self.paras, self.flip) - center_xyz
        return img, jt_xyz

    def scale(self, img, center_uvd, cube, M, scale):
        """Grow/shrink the crop cube and re-crop (reference
        loader.py:163-179)."""
        if np.allclose(scale, 1.0):
            return img, cube, M
        new_cube = cube * scale
        if not np.allclose(center_uvd[2], 0.0):
            new_M = self.center2transmat(center_uvd, new_cube, img.shape[0])
            img = self.recrop(img, center_uvd, new_cube, new_M,
                              np.linalg.inv(M), img.shape, thresh_z=True,
                              bg=0, nv_val=np.min(img[img > 0]) - 1)
        else:
            new_M = M
        return img, new_cube, new_M

    def recrop(self, img, center_uvd, cube, M, M_inv, dsize,
               thresh_z=True, bg=0.0, nv_val=0.0):
        """Re-warp a cropped image under a new transmat
        (reference loader.py:125-138)."""
        img = cvwarp.warp_perspective(
            img, np.dot(M, M_inv).astype(np.float64), (dsize[1], dsize[0]),
            border_value=float(bg))
        img[img < nv_val] = bg
        if thresh_z:
            _, _, _, _, zstart, zend = self.center2bounds(center_uvd, cube)
            nz = img != 0
            img[np.logical_and(img < zstart, nz)] = zstart
            img[np.logical_and(img > zend, nz)] = 0.0
        return img.astype(np.float32)


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
