"""HANDS 2017 challenge dataset loader (the JAX package's
``data/hands17.py``).

The reference supports hands17 only via config tables (config.py:1-18:
21 joints, step 5, 10 epochs) and the skeleton table
(vis_tool.py:53-60).  This loader reads the challenge's published
layout:

    <root>/
      images/<name>.png                  16-bit depth PNGs, 640x480, mm
      Training_Annotation.txt            "<name>\tx1 y1 z1 ... x21 y21 z21"
                                         camera xyz mm (tab- or
                                         space-separated)
      center_train_refined.txt (joint-centroid fallback requires an
                                explicit allow_centroid_centers=True;
                                see PARITY.md)

Intrinsics: fx = fy = 475.065948, cx = 315.944855, cy = 245.287079
(the challenge's published calibration); no y flip.
"""

from __future__ import annotations

import os

import numpy as np

from awr_tpu_torch.config import DATASET_FLIP
from awr_tpu_torch.data import native_decode
from awr_tpu_torch.data.base import (DepthDataset, _load_centers_or_centroids,
                                     check_mode)
from awr_tpu_torch.data.transforms import CameraCrop

HANDS17_PARAS = (475.065948, 475.065857, 315.944855, 245.287079)
HANDS17_FLIP = DATASET_FLIP["hands17"]
HANDS17_JOINTS = 21


def decode_hands17_png(path: str) -> np.ndarray:
    """HANDS17 ships 16-bit single-channel depth PNGs (mm)."""
    return native_decode.decode_depth_png(path, "gray16")


class Hands17Dataset(DepthDataset):
    def __init__(self, root: str, phase: str = "train",
                 annotation: str = "Training_Annotation.txt",
                 val: bool = False, img_size: int = 128,
                 aug_para=(10.0, 0.1, 180.0),
                 cube=(300.0, 300.0, 300.0),
                 jt_num: int = HANDS17_JOINTS, mode: str = "host",
                 seed: int = 23455,
                 allow_centroid_centers: bool = False):
        if phase not in ("train", "test"):
            raise ValueError(f"phase must be 'train' or 'test', got "
                             f"{phase!r}")
        self.root = root
        self.allow_centroid_centers = allow_centroid_centers
        self.phase = phase
        self.val = val
        self.img_size = img_size
        self.aug_para = tuple(aug_para)
        self.cube = np.asarray(cube, np.float64)
        self.jt_num = jt_num
        self.mode = check_mode(mode)
        self.paras = HANDS17_PARAS
        self.flip = HANDS17_FLIP
        self.cropper = CameraCrop(self.paras, self.flip, img_size)
        self.rng = np.random.RandomState(seed)
        self._load(annotation)

    def _load(self, annotation: str):
        ann = os.path.join(self.root, annotation)
        if not os.path.exists(ann):
            raise FileNotFoundError(
                f"HANDS17 annotation not found: {ann} (see module "
                f"docstring for the expected layout)")
        paths, labels = [], []
        with open(ann) as fh:
            for line in fh:
                parts = line.split()
                if len(parts) != 1 + self.jt_num * 3:
                    continue
                paths.append(os.path.join(self.root, "images", parts[0]))
                labels.append(np.asarray(parts[1:], np.float64)
                              .reshape(self.jt_num, 3))
        self.image_paths = paths
        self.labels_xyz = (np.stack(labels) if labels
                           else np.zeros((0, self.jt_num, 3)))
        self.centers = _load_centers_or_centroids(
            self.root, self.phase, self.labels_xyz,
            self.allow_centroid_centers, "HANDS17")

    def __len__(self):
        return len(self.image_paths)

    def cube_for(self, index: int) -> np.ndarray:
        return self.cube

    def __getitem__(self, index: int):
        return self.item(decode_hands17_png(self.image_paths[index]),
                         self.labels_xyz[index].astype(np.float64).copy(),
                         self.centers[index].astype(np.float64).copy(),
                         self.cube_for(index))
