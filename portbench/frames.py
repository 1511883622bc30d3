"""Synthetic depth frames of a hand, made from the seed: spheres (a palm
and the joints) rendered into 480x640 mm frames with the configuration's
intrinsics, background 0.

The draws and the geometry are those of the program's
``data/synthetic.py`` (``synthetic_frames`` and ``render_hand_depth``):
centers uniform in x [-80, 80], y [-60, 60], z [650, 950] mm, joints
within 70 mm of the center in x and y and 40 mm in z; a ray through each
pixel meets each sphere (radius 40 mm for the palm, 14 mm for the rest)
within the sphere's bounding box of ``ceil(r fx / z) + 2`` pixels, and
the nearest surface wins.  Here the draws come from numpy's
``default_rng(seed)`` (any whole seed) and the frames are rendered on
the device in float64, many frames and one sphere at a time, then
copied to the host once.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def hand_poses(n: int, jt_num: int, seed: int):
    """(centers (n, 3), joints (n, J, 3)) in camera xyz mm, float64."""
    g = np.random.default_rng(seed)
    centers = np.stack([g.uniform(-80, 80, n), g.uniform(-60, 60, n),
                        g.uniform(650, 950, n)], axis=1)
    joints = centers[:, None, :] + g.uniform(-70, 70, (n, jt_num, 3))
    joints[..., 2] = centers[:, None, 2] + g.uniform(-40, 40, (n, jt_num))
    return centers, joints


def render(joints: np.ndarray, paras, flip: int, shape, device,
           chunk: int = 64) -> np.ndarray:
    """(n, H, W) float32 host frames of spheres at ``joints`` (n, J, 3)."""
    h, w = shape
    fx, fy, u0, v0 = (float(x) for x in paras)
    n, J, _ = joints.shape
    radii = [40.0] + [14.0] * (J - 1)
    dev = torch.device(device)
    vv, uu = torch.meshgrid(torch.arange(h, device=dev, dtype=torch.float64),
                            torch.arange(w, device=dev, dtype=torch.float64),
                            indexing="ij")
    dx, dy = (uu - u0) / fx, (vv - v0) / fy
    a = dx * dx + dy * dy + 1.0
    out = np.empty((n, h, w), np.float32)
    for s in range(0, n, chunk):
        jt = torch.from_numpy(joints[s:s + chunk]).to(dev)
        depth = torch.full((len(jt), h, w), math.inf, dtype=torch.float64,
                           device=dev)
        for k, r in enumerate(radii):
            x, y, z = (jt[:, k, i].view(-1, 1, 1) for i in range(3))
            cy = y * flip
            b = -2.0 * (dx * x + dy * cy + z)
            c = x * x + cy * cy + z * z - r * r
            disc = b * b - 4 * a * c
            t = (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / (2 * a)
            # the sphere's bounding box around its projected center
            u = torch.trunc(x * fx / z + u0)
            v = torch.trunc(cy * fy / z + v0)
            pr = torch.ceil(r * fx / z) + 2
            box = ((uu >= u - pr) & (uu <= u + pr)
                   & (vv >= v - pr) & (vv <= v + pr))
            hit = (disc > 0) & box
            # the frame is float32: the nearest surface in float32, as
            # the program's z-buffer keeps it
            depth = torch.minimum(depth, torch.where(
                hit, t.float().double(), torch.full_like(t, math.inf)))
        depth = torch.where(torch.isfinite(depth), depth,
                            torch.zeros_like(depth))
        out[s:s + len(jt)] = depth.float().cpu().numpy()
    return out


class Pool:
    """``n`` frames with their joints and hand centers, made from the
    seed: what every cell's traffic draws its inputs from."""

    def __init__(self, config: dict, n: int, seed: int, device):
        self.paras = tuple(config["paras"])
        self.flip = int(config["flip"])
        self.cube = np.asarray(config["cube"], np.float64)
        self.centers, self.joints = hand_poses(n, config["joint_num"], seed)
        self.frames = render(self.joints, self.paras, self.flip,
                             tuple(config["frame_shape"]), device)

    def __len__(self):
        return len(self.frames)

    def cubes(self, n: int) -> np.ndarray:
        return np.tile(self.cube, (n, 1))
