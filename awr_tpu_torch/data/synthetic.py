"""Synthetic raw depth frames: spheres ("palm" + "fingertips") rendered
into a (480, 640) mm frame with the NYU intrinsics.  GT joints are the
sphere centers, so the crop -> train -> decode -> mm-metric pipeline runs
on a learnable, geometrically consistent signal where no real dataset is
present (the reference ships neither NYU's frames nor its labels)."""

from __future__ import annotations

import numpy as np

from awr_tpu_torch.config import DATASET_FLIP, NYU_PARAS
from awr_tpu_torch.data.base import DepthDataset, check_mode

NYU_FLIP = DATASET_FLIP["nyu"]


def render_hand_depth(center_xyz, jt_xyz, paras, shape=(480, 640),
                      radii=None, bg=0.0):
    """Render spheres at ``jt_xyz`` (absolute mm) into a depth frame.

    Nearest-surface-wins z-buffer; background pixels are ``bg`` (the
    reference maps exact 0 to background).
    """
    h, w = shape
    fx, fy, u0, v0 = paras
    depth = np.full(shape, np.inf, np.float32)
    if radii is None:
        radii = [40.0] + [14.0] * (len(jt_xyz) - 1)
    for (x, y, z), r in zip(jt_xyz, radii):
        u = x * fx / z + u0
        v = y * NYU_FLIP * fy / z + v0
        pr = int(np.ceil(r * fx / z)) + 2
        uu0, uu1 = max(int(u) - pr, 0), min(int(u) + pr + 1, w)
        vv0, vv1 = max(int(v) - pr, 0), min(int(v) + pr + 1, h)
        if uu1 <= uu0 or vv1 <= vv0:
            continue
        uu, vv = np.meshgrid(np.arange(uu0, uu1), np.arange(vv0, vv1))
        # ray through pixel: direction ((u-u0)/fx, (v-v0)/fy, 1)
        dx = (uu - u0) / fx
        dy = (vv - v0) / fy
        cy = y * NYU_FLIP
        # smallest t > 0 with |t*(dx,dy,1) - (x,cy,z)|^2 = r^2
        a = dx * dx + dy * dy + 1.0
        b = -2.0 * (dx * x + dy * cy + z)
        c = x * x + cy * cy + z * z - r * r
        disc = b * b - 4 * a * c
        hit = disc > 0
        t = np.where(hit, (-b - np.sqrt(np.maximum(disc, 0.0))) / (2 * a),
                     np.inf)
        patch = depth[vv0:vv1, uu0:uu1]
        depth[vv0:vv1, uu0:uu1] = np.minimum(patch, t.astype(np.float32))
    depth[~np.isfinite(depth)] = bg
    return depth


def synthetic_frames(n: int, jt_num: int = 14, seed: int = 0,
                     shape=(480, 640)):
    """``n`` random hands: (frames (n, H, W) float32 mm, joints (n, J, 3)
    mm, centers (n, 3) mm), joints scattered within ~70 mm of the center
    (the JAX package's ``SyntheticHandDataset(layout="random")``)."""
    g = np.random.RandomState(seed)
    centers = np.stack([g.uniform(-80, 80, n), g.uniform(-60, 60, n),
                        g.uniform(650, 950, n)], axis=1)
    joints = centers[:, None, :] + g.uniform(-70, 70, (n, jt_num, 3))
    joints[..., 2] = centers[:, None, 2] + g.uniform(-40, 40, (n, jt_num))
    frames = np.stack([render_hand_depth(c, j, NYU_PARAS, shape)
                       for c, j in zip(centers, joints)])
    return frames, joints, centers


class SyntheticHandDataset(DepthDataset):
    """The JAX package's ``SyntheticHandDataset`` in raw mode: the same
    numpy draws in the same order, so the same items bit for bit.  The
    host-mode knobs (``aug_para``, ``val``) wait for host mode."""

    def __init__(self, num_samples: int = 64, jt_num: int = 14,
                 img_size: int = 128, cube=(300.0, 300.0, 300.0),
                 phase: str = "test", seed: int = 0, mode: str = "raw",
                 shape=(480, 640), layout: str = "random"):
        self.mode = check_mode(mode)
        self.n = num_samples
        self.jt_num = jt_num
        self.img_size = img_size
        self.cube = np.asarray(cube, np.float64)
        self.phase = phase
        self.shape = shape
        self.paras = NYU_PARAS
        self.flip = NYU_FLIP
        self.rng = np.random.RandomState(23455)

        g = np.random.RandomState(seed)
        self.layout = layout
        self.centers = np.stack(
            [g.uniform(-80, 80, num_samples),
             g.uniform(-60, 60, num_samples),
             g.uniform(650, 950, num_samples)], axis=1)
        if layout == "random":
            # joints scattered within ~70 mm of the center; rear spheres
            # can hide behind the big palm sphere, so some joints are
            # ill-posed from one depth view: an error floor, meant for
            # exercising the pipeline, not for convergence checks
            self.joints = (self.centers[:, None, :]
                           + g.uniform(-70, 70,
                                       (num_samples, jt_num, 3)))
            self.joints[..., 2] = (
                self.centers[:, None, 2]
                + g.uniform(-40, 40, (num_samples, jt_num)))
            self._radii = None  # render_hand_depth defaults (big palm)
        elif layout == "grid":
            # every joint visible: small equal spheres on a jittered xy
            # grid facing the camera, shallow z spread, so no error floor.
            # Disjoint by construction: the least xy center distance,
            # spacing - 2 * jitter, exceeds 2 * radius.  jt_num <= 16
            # keeps 35 mm / +-6 / r 10 (the convergence recipes use
            # them); larger grids shrink jitter and radius with the
            # spacing
            side = int(np.ceil(np.sqrt(jt_num)))
            spacing = 140.0 / side
            if side <= 4:
                jitter, radius = 6.0, 10.0
            else:
                jitter = spacing / 7.0
                radius = 0.45 * (spacing - 2.0 * jitter)
            if not spacing - 2 * jitter > 2 * radius:
                raise AssertionError("grid spheres overlap")
            gx, gy = np.meshgrid(np.arange(side), np.arange(side))
            grid = np.stack([gx.ravel(), gy.ravel()], 1)[:jt_num]
            grid = (grid - (side - 1) / 2.0) * spacing
            off = np.zeros((num_samples, jt_num, 3))
            off[..., :2] = grid[None] + g.uniform(
                -jitter, jitter, (num_samples, jt_num, 2))
            off[..., 2] = g.uniform(-10, 10, (num_samples, jt_num))
            self.joints = self.centers[:, None, :] + off
            self._radii = [radius] * jt_num
        else:
            raise ValueError(f"unknown layout {layout!r}")
        self._render_cache = {}

    def __len__(self):
        return self.n

    def cube_for(self, index: int) -> np.ndarray:
        return self.cube

    def raw_item(self, index: int):
        """(frame (H, W) float32 mm, joints (J, 3) mm, center (3,) mm),
        copies; the frame is rendered once and cached."""
        jt_xyz = self.joints[index]
        center_xyz = self.centers[index]
        img = self._render_cache.get(index)
        if img is None:
            img = render_hand_depth(center_xyz, jt_xyz, self.paras,
                                    self.shape, radii=self._radii)
            self._render_cache[index] = img
        return img.copy(), jt_xyz.copy(), center_xyz.copy()

    def __getitem__(self, index: int):
        img, jt_xyz, center_xyz = self.raw_item(index)
        # float64 center and cube keep the crop's int(x + 0.5)
        # truncations, computed on the host, exact
        return dict(img=img, jt_xyz=jt_xyz.astype(np.float32),
                    center_xyz=np.asarray(center_xyz, np.float64),
                    cube=self.cube_for(index))
