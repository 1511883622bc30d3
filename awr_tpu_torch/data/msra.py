"""MSRA-15K hand dataset loader, leave-one-subject-out (the JAX
package's ``data/msra.py``).

The reference supports MSRA only via config tables (config.py:1-18:
21 joints, step 10, 25 epochs) and the skeleton table
(vis_tool.py:71-78).  This loader reads the dataset's standard public
layout:

    <root>/P0..P8/<gesture>/
        joint.txt            first line: frame count; then per frame
                             21*3 floats, camera xyz mm (z negative in
                             the raw files; negated on load, the usual
                             convention)
        ??????_depth.bin     6 int32 header (img w, h, bbox left, top,
                             right, bottom) + float32 depth for the
                             bbox region only (rest of the frame is
                             background)

Intrinsics: fx = fy = 241.42, cx = 160, cy = 120 (320x240); no y flip.
Centers: center_{train,test}_refined.txt files; if absent, joint
centroids are substituted ONLY with an explicit
``allow_centroid_centers=True`` (a different crop distribution — see
PARITY.md).
"""

from __future__ import annotations

import os
import struct
from glob import glob

import numpy as np

from awr_tpu_torch.config import DATASET_FLIP, DATASET_PARAS
from awr_tpu_torch.data.base import (DepthDataset, _load_centers_or_centroids,
                                     check_mode)
from awr_tpu_torch.data.transforms import CameraCrop

MSRA_PARAS = DATASET_PARAS["msra"]
MSRA_FLIP = DATASET_FLIP["msra"]
MSRA_JOINTS = 21
MSRA_SHAPE = (240, 320)


def decode_msra_bin(path: str) -> np.ndarray:
    """Reassemble the full (240, 320) mm-depth frame from the bbox-packed
    .bin format."""
    with open(path, "rb") as fh:
        w, h, left, top, right, bottom = struct.unpack("<6i", fh.read(24))
        n = (right - left) * (bottom - top)
        patch = np.frombuffer(fh.read(4 * n), np.float32).reshape(
            bottom - top, right - left)
    img = np.zeros((h, w), np.float32)
    img[top:bottom, left:right] = patch
    return img


class MSRADataset(DepthDataset):
    def __init__(self, root: str, phase: str, test_subject: int = 0,
                 val: bool = False, img_size: int = 128,
                 aug_para=(10.0, 0.1, 180.0),
                 cube=(200.0, 200.0, 200.0), jt_num: int = MSRA_JOINTS,
                 mode: str = "host", seed: int = 23455,
                 allow_centroid_centers: bool = False):
        if phase not in ("train", "test"):
            raise ValueError(f"phase must be 'train' or 'test', got "
                             f"{phase!r}")
        self.root = root
        self.allow_centroid_centers = allow_centroid_centers
        self.phase = phase
        self.test_subject = test_subject
        self.val = val
        self.img_size = img_size
        self.aug_para = tuple(aug_para)
        self.cube = np.asarray(cube, np.float64)
        self.jt_num = jt_num
        self.mode = check_mode(mode)
        self.paras = MSRA_PARAS
        self.flip = MSRA_FLIP
        self.cropper = CameraCrop(self.paras, self.flip, img_size)
        self.rng = np.random.RandomState(seed)
        self._load()

    def _subjects(self):
        subs = sorted(
            d for d in os.listdir(self.root)
            if d.startswith("P") and
            os.path.isdir(os.path.join(self.root, d)))
        test = f"P{self.test_subject}"
        if self.phase == "test":
            return [s for s in subs if s == test]
        return [s for s in subs if s != test]

    def _load(self):
        paths, labels = [], []
        for sub in self._subjects():
            for gesture in sorted(os.listdir(os.path.join(self.root, sub))):
                gdir = os.path.join(self.root, sub, gesture)
                jfile = os.path.join(gdir, "joint.txt")
                if not os.path.isfile(jfile):
                    continue
                with open(jfile) as fh:
                    count = int(fh.readline())
                    arr = np.loadtxt(fh)
                arr = arr.reshape(count, self.jt_num, 3)
                arr[..., 2] *= -1  # raw files store negative z
                bins = sorted(glob(os.path.join(gdir, "*_depth.bin")))
                for i, b in enumerate(bins[:count]):
                    paths.append(b)
                    labels.append(arr[i])
        self.image_paths = paths
        self.labels_xyz = (np.stack(labels) if labels
                           else np.zeros((0, self.jt_num, 3)))
        self.centers = _load_centers_or_centroids(
            self.root, self.phase, self.labels_xyz,
            self.allow_centroid_centers, "MSRA")

    def __len__(self):
        return len(self.image_paths)

    def cube_for(self, index: int) -> np.ndarray:
        return self.cube

    def __getitem__(self, index: int):
        return self.item(decode_msra_bin(self.image_paths[index]),
                         self.labels_xyz[index].astype(np.float64).copy(),
                         self.centers[index].astype(np.float64).copy(),
                         self.cube_for(index))
