"""Shared dataset base: the host batcher and the refined-center lookup
(the JAX package's ``data/base.py``).

Subclasses provide raw frames plus ``paras/flip/img_size/cube/phase/
mode`` attributes.  The port serves raw mode only: items are raw frames,
and crop, augmentation and normalization run on the device
(``data/device.py``).  The host chain (the reference's cv2 crop ->
augment|normalize -> label-normalize, nyu_loader.py:38-66) waits for the
port's host ``CameraCrop``.
"""

from __future__ import annotations

import os
import warnings
from typing import Optional

import numpy as np

HOST_MODE_UNPORTED = (
    "host mode (the reference's cv2 crop and augmentation on the host) is "
    "not ported yet; use mode='raw', which crops and augments on the "
    "device")


def check_mode(mode: str) -> str:
    """``mode`` if the port serves it; host mode raises."""
    if mode == "host":
        raise NotImplementedError(HOST_MODE_UNPORTED)
    if mode != "raw":
        raise ValueError(f"unknown data mode {mode!r}")
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
        """The reference's host item chain (nyu_loader.py:38-66)."""
        raise NotImplementedError(HOST_MODE_UNPORTED)

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
