"""NYU hand dataset: file decoding, joint selection, and the per-sample
host pipeline (the JAX package's ``data/nyu.py``).

Reference parity: dataloader/nyu_loader.py — depth PNGs decode as
``blue + green*256`` (ref :71-74), 36->23->14 joint selection via the
JOINT/EVAL index tables (ref :9-11,85-86), intrinsics (588.03, 587.07,
320, 240) with y-flip (ref :23,34), test cubes shrunk x5/6 from frame
2440 on (second subject, ref :32-33), refined hand centers from
``center_{split}_refined.txt`` (ref :81,87), and the crop -> augment ->
normalize -> label-normalize item pipeline (ref :38-66).

Two item modes:
- ``mode='host'``: the reference's chain on the host (crop, one-of-four
  augmentation, normalize) -> ready-to-train normalized arrays.
- ``mode='raw'``: decode only; the raw (480, 640) frame and labels, for
  the device crop and augmentation (:mod:`awr_tpu_torch.data.device`).

``joint_data.mat`` is read with ``scipy.io``, imported in the label
loader alone.
"""

from __future__ import annotations

import os
from glob import glob

import numpy as np

from awr_tpu_torch.config import DATASET_FLIP
from awr_tpu_torch.config import NYU_PARAS  # noqa: F401  (re-exported)
from awr_tpu_torch.data import native_decode
from awr_tpu_torch.data.base import DepthDataset, check_mode
from awr_tpu_torch.data.transforms import CameraCrop

# 36 -> 23 keep list, then 23 -> 14 eval list (reference nyu_loader.py:9-11).
JOINT_SELECT = np.array(
    [0, 1, 3, 5, 6, 7, 9, 11, 12, 13, 15, 17, 18, 19, 21, 23, 24, 25, 27,
     28, 32, 30, 31]
)
EVAL_SELECT = np.array([0, 2, 4, 6, 8, 10, 12, 14, 16, 17, 18, 21, 22, 20])

NYU_FLIP = DATASET_FLIP["nyu"]
# Frames >= this index in the test split are the second subject with a
# smaller hand: cube scaled by 5/6 (reference nyu_loader.py:32-33).
SECOND_SUBJECT_START = 2440


def decode_depth_png(path: str) -> np.ndarray:
    """NYU PNG encoding: depth mm = blue + green * 256 (reference :71-74),
    8-bit RGB/RGBA only; anything else raises."""
    return native_decode.decode_depth_png(path, "nyu")


def load_labels(label_path: str):
    """(uvd, xyz) (N, 14, 3) float64 from ``joint_data.mat``: the first
    camera's 36 joints through the JOINT/EVAL selection."""
    import scipy.io as sio

    labels = sio.loadmat(label_path)
    uvd = labels["joint_uvd"][0][:, JOINT_SELECT, :][:, EVAL_SELECT, :]
    xyz = labels["joint_xyz"][0][:, JOINT_SELECT, :][:, EVAL_SELECT, :]
    return uvd, xyz


class NYUDataset(DepthDataset):
    """Indexable NYU split."""

    def __init__(self, root: str, phase: str, val: bool = False,
                 img_size: int = 128,
                 aug_para=(10.0, 0.1, 180.0),
                 cube=(300.0, 300.0, 300.0),
                 jt_num: int = 14,
                 mode: str = "host",
                 seed: int = 23455):
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
        self.paras = NYU_PARAS
        self.flip = NYU_FLIP
        self.cropper = CameraCrop(self.paras, self.flip, img_size)
        # the reference seeds a module-level RandomState(23455) (loader.py:11)
        self.rng = np.random.RandomState(seed)

        self.image_paths, self.labels_uvd, self.labels_xyz, self.centers = (
            self._make_dataset())
        n = len(self.image_paths)
        self.test_cube = np.ones((n, 3)) * self.cube
        if phase == "test":
            self.test_cube[SECOND_SUBJECT_START:] *= 5.0 / 6.0

    def _make_dataset(self):
        """File discovery + label decode (reference nyu_loader.py:76-90)."""
        data_path = os.path.join(self.root, self.phase)
        label_path = os.path.join(data_path, "joint_data.mat")
        center_path = os.path.join(
            self.root, f"center_{self.phase}_refined.txt")
        for p, what in ((data_path, "split directory"),
                        (label_path, "joint_data.mat ground truth"),
                        (center_path, "refined hand centers")):
            if not os.path.exists(p):
                raise FileNotFoundError(
                    f"NYU {what} not found at {p}; expected the reference "
                    f"layout <root>/{{train,test}}/depth_1*.png + "
                    f"joint_data.mat and <root>/center_{{split}}_refined"
                    f".txt (see README).  For offline runs use "
                    f"--synthetic / SyntheticHandDataset.")
        paths = sorted(glob(os.path.join(data_path, "depth_1*.png")))
        uvd, xyz = load_labels(label_path)
        centers = np.loadtxt(center_path)
        return paths, uvd, xyz, centers

    def __len__(self):
        return len(self.image_paths)

    def cube_for(self, index: int) -> np.ndarray:
        return (self.test_cube[index] if self.phase == "test"
                else self.cube).astype(np.float64)

    def __getitem__(self, index: int):
        return self.item(decode_depth_png(self.image_paths[index]),
                         self.labels_xyz[index].astype(np.float64).copy(),
                         self.centers[index].astype(np.float64).copy(),
                         self.cube_for(index))
