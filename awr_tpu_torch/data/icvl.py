"""ICVL hand dataset loader (the JAX package's ``data/icvl.py``).

The reference supports ICVL only via config tables (config.py:1-18:
16 joints, step 10, 40 epochs) and the skeleton table
(vis_tool.py:62-68).  This loader reads the dataset's standard public
layout:

    <root>/
      Depth/<line-path>.png            16-bit depth PNGs, 320x240, mm
      labels_train.txt / labels_test.txt
          "<relative path> u1 v1 d1 ... u16 v16 d16" per line
      center_train_refined.txt / center_test_refined.txt
          xyz mm hand centers (same convention as NYU's)

Intrinsics: fx = fy = 241.42, cx = 160, cy = 120; no y flip.
"""

from __future__ import annotations

import os

import numpy as np

from awr_tpu_torch.config import DATASET_FLIP, DATASET_PARAS
from awr_tpu_torch.data import native_decode
from awr_tpu_torch.data.base import DepthDataset, check_mode
from awr_tpu_torch.data.transforms import CameraCrop
from awr_tpu_torch.geometry import uvd2xyz_np

ICVL_PARAS = DATASET_PARAS["icvl"]
ICVL_FLIP = DATASET_FLIP["icvl"]
ICVL_JOINTS = 16


def decode_icvl_png(path: str) -> np.ndarray:
    """ICVL ships 16-bit single-channel depth PNGs (mm)."""
    return native_decode.decode_depth_png(path, "gray16")


class ICVLDataset(DepthDataset):
    def __init__(self, root: str, phase: str, val: bool = False,
                 img_size: int = 128, aug_para=(10.0, 0.1, 180.0),
                 cube=(250.0, 250.0, 250.0), jt_num: int = ICVL_JOINTS,
                 mode: str = "host", seed: int = 23455):
        if phase not in ("train", "test"):
            raise ValueError(f"phase must be 'train' or 'test', got "
                             f"{phase!r}")
        self.root = root
        self.phase = phase
        self.val = val
        self.img_size = img_size
        self.aug_para = tuple(aug_para)
        self.cube = np.asarray(cube, np.float64)
        self.jt_num = jt_num
        self.mode = check_mode(mode)
        self.paras = ICVL_PARAS
        self.flip = ICVL_FLIP
        self.cropper = CameraCrop(self.paras, self.flip, img_size)
        self.rng = np.random.RandomState(seed)
        self._load()

    def _load(self):
        label_path = os.path.join(self.root, f"labels_{self.phase}.txt")
        center_path = os.path.join(
            self.root, f"center_{self.phase}_refined.txt")
        for p in (label_path, center_path):
            if not os.path.exists(p):
                raise FileNotFoundError(
                    f"ICVL file not found: {p} (see module docstring "
                    f"for the expected layout)")
        paths, labels = [], []
        with open(label_path) as fh:
            for line in fh:
                parts = line.split()
                if len(parts) != 1 + self.jt_num * 3:
                    continue
                paths.append(os.path.join(self.root, "Depth", parts[0]))
                labels.append(np.asarray(parts[1:], np.float64)
                              .reshape(self.jt_num, 3))
        self.image_paths = paths
        self.labels_uvd = (np.stack(labels) if labels
                           else np.zeros((0, self.jt_num, 3)))
        # labels ship in uvd; convert to camera xyz once
        self.labels_xyz = uvd2xyz_np(self.labels_uvd, self.paras, self.flip)
        self.centers = np.loadtxt(center_path, ndmin=2)

    def __len__(self):
        return len(self.image_paths)

    def cube_for(self, index: int) -> np.ndarray:
        return self.cube

    def __getitem__(self, index: int):
        return self.item(decode_icvl_png(self.image_paths[index]),
                         self.labels_xyz[index].astype(np.float64).copy(),
                         self.centers[index].astype(np.float64).copy(),
                         self.cube_for(index))
