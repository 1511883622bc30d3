"""Shared dataset base: the reference item chain, the host batcher and
the refined-center lookup (the JAX package's ``data/base.py``).

Subclasses provide raw frames plus ``paras/flip/img_size/cube/phase/val/
aug_para/rng/cropper/mode`` attributes.  In host mode an item goes
through the reference's crop -> augment|normalize -> label-normalize
chain here on the host (nyu_loader.py:38-66); in raw mode an item is the
raw frame, and crop, augmentation and normalization run on the device
(``data/device.py``).
"""

from __future__ import annotations

import os
import warnings
from typing import Optional

import numpy as np

from awr_tpu_torch.data.transforms import normalize_labels
from awr_tpu_torch.geometry import transform_uv_np, uvd2xyz_np, xyz2uvd_np

MODES = ("host", "raw")


def check_mode(mode: str) -> str:
    """``mode`` if it is "host" or "raw"; anything else raises."""
    if mode not in MODES:
        raise ValueError(f"unknown data mode {mode!r}; expected one of "
                         f"{MODES}")
    return mode


def _load_centers_or_centroids(root, phase, labels_xyz,
                               allow_centroid_centers: bool,
                               dataset_name: str) -> np.ndarray:
    """Refined-center file lookup with an EXPLICIT centroid fallback.

    The AWR family trains on refined hand centers produced by a separate
    2D CNN (reference README.md:31, nyu_loader.py:81,87).  Joint
    centroids are a *different crop distribution* and silently change
    results on real data, so substituting them requires
    ``allow_centroid_centers=True`` and still warns loudly (PARITY.md
    "Centroid-center fallback").
    """
    cpath = os.path.join(root, f"center_{phase}_refined.txt")
    if os.path.exists(cpath):
        return np.loadtxt(cpath, ndmin=2)
    if not allow_centroid_centers:
        raise FileNotFoundError(
            f"{dataset_name} refined hand centers not found at {cpath}. "
            f"The AWR pipeline crops around refined centers; training on "
            f"joint centroids changes the crop distribution and the "
            f"results.  Pass allow_centroid_centers=True to explicitly "
            f"accept centroid crops.")
    warnings.warn(
        f"{dataset_name}: no refined centers at {cpath}; using joint "
        f"CENTROIDS as crop centers (allow_centroid_centers=True).  "
        f"Results are NOT comparable to refined-center runs.",
        stacklevel=3)
    return labels_xyz.mean(axis=1)


class DepthDataset:
    def process(self, img, jt_xyz, center_xyz, cube):
        """The reference's host item chain (nyu_loader.py:38-66): a dict
        of the normalized crop ``img`` (S, S), ``jt_xyz`` and ``jt_uvd``
        (J, 3), and the ``center_xyz``, ``M`` and ``cube`` that undo the
        normalization, all float32.  Train items that are not ``val``
        draw one augmentation from ``self.rng``."""
        c = self.cropper
        center_uvd = xyz2uvd_np(center_xyz, self.paras, self.flip).astype(
            np.float64)
        jt_xyz = jt_xyz - center_xyz
        img, M = c.crop(img, center_uvd, cube, self.img_size)

        if self.phase == "train" and not self.val:
            aug_op, trans, scale, rot = c.random_aug(self.rng, *self.aug_para)
            img, jt_xyz, cube, center_uvd, M = c.augment(
                img, jt_xyz, center_uvd, cube, M, aug_op, trans, scale, rot)
            center_xyz = uvd2xyz_np(center_uvd, self.paras, self.flip)
        else:
            img = c.normalize(img.max(), img, center_xyz[2], cube[2])

        jt_uvd_px = transform_uv_np(
            xyz2uvd_np(jt_xyz + center_xyz, self.paras, self.flip), M)
        jt_xyz_n, jt_uvd_n = normalize_labels(
            jt_xyz, jt_uvd_px, center_xyz, cube, self.img_size)
        return dict(
            img=img.astype(np.float32),
            jt_xyz=jt_xyz_n,
            jt_uvd=jt_uvd_n,
            center_xyz=np.asarray(center_xyz, np.float32),
            M=np.asarray(M, np.float32),
            cube=np.asarray(cube, np.float32),
        )

    def item(self, img, jt_xyz, center_xyz, cube):
        """One item in the dataset's mode: the host chain's dict, or the
        raw frame with float32 joints and float64 center and cube (which
        keep the crop's ``int(x + 0.5)`` truncations, computed on the
        host, exact)."""
        if self.mode == "raw":
            return dict(img=img, jt_xyz=np.asarray(jt_xyz, np.float32),
                        center_xyz=np.asarray(center_xyz, np.float64),
                        cube=np.asarray(cube, np.float64))
        return self.process(img, jt_xyz, center_xyz, cube)

    def batches(self, batch_size: int, shuffle: bool = False,
                drop_last: bool = False,
                rng: Optional[np.random.RandomState] = None):
        """Host batcher yielding stacked dict batches."""
        order = np.arange(len(self))
        if shuffle:
            (rng or self.rng).shuffle(order)
        for i in range(0, len(order), batch_size):
            idx = order[i : i + batch_size]
            if drop_last and len(idx) < batch_size:
                return
            items = [self[int(j)] for j in idx]
            yield {k: np.stack([it[k] for it in items]) for k in items[0]}
