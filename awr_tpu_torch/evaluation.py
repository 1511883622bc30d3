"""mm-space evaluation: MPE / median / PCK / AUC + prediction dumps.

Reference parity: util/eval_tool.py — ``feed`` de-normalizes predictions
(uv -> pixels via (x+1)*size/2, d -> mm via *cube_z/2 + center_z, uncrop
via M^-1, ref :34-43), stores per-joint Euclidean mm distances
(ref :49-58); ``get_measures`` averages per-joint means/medians and a
PCK curve over thresholds linspace(0, 50, 100) with trapezoid AUC
normalized by 50 (ref :80-122).  The reference loops per sample and per
joint on host; here everything is vectorized numpy over (N, J) arrays
(feeds are batched), which is orders of magnitude faster for the
8,252-frame NYU split.  The PCK figure is drawn with numpy and written
by the port's own PNG writer (the JAX package's ``evaluation.py`` draws
it with matplotlib).
"""

from __future__ import annotations

import numpy as np

from awr_tpu_torch.geometry import uvd2xyz_np
from awr_tpu_torch.utils.png import write_png
from awr_tpu_torch.vis import draw_disk, draw_line


class Evaluator:
    """Accumulates batches of predictions; computes reference metrics."""

    def __init__(self, img_size, paras, flip, num_kp):
        self.img_size = img_size
        self.paras = paras
        self.flip = flip
        self.num_kp = num_kp
        self._dists = []  # list of (B, J) mm distances
        self._uvd_pred = []  # list of (B, J, 3) camera-coord uvd preds

    def feed_batch(self, jt_uvd_pred, jt_xyz_gt, center_xyz, M, cube):
        """Accumulate a batch.

        Args:
          jt_uvd_pred: (B, J, 3) normalized uvd predictions.
          jt_xyz_gt: (B, J, 3) normalized center-relative xyz GT.
          center_xyz: (B, 3) mm; M: (B, 3, 3); cube: (B, 3) mm.
        """
        pred = np.array(jt_uvd_pred, np.float32, copy=True)
        gt = np.asarray(jt_xyz_gt, np.float32)
        center = np.asarray(center_xyz, np.float32)
        M = np.asarray(M, np.float32)
        cube = np.asarray(cube, np.float32)

        # De-normalize (reference eval_tool.py:38-41).
        pred[..., :2] = (pred[..., :2] + 1) * self.img_size / 2.0
        pred[..., 2] = (pred[..., 2] * cube[:, None, 2] / 2.0
                        + center[:, None, 2])
        # Degenerate transmats fall back to pinv PER SAMPLE (the
        # reference's try/except is per-sample, eval_tool.py:33-36); valid
        # samples in the same batch keep their exact inverse.
        M64 = M.astype(np.float64)
        dets = np.linalg.det(M64)
        singular = (dets == 0.0) | ~np.isfinite(dets)
        M_inv = np.empty_like(M64)
        if singular.any():
            print(f"singular transmat in batch: {int(singular.sum())} "
                  f"sample(s) scored via pinv")
            M_inv[singular] = np.linalg.pinv(M64[singular])
        if (~singular).any():
            M_inv[~singular] = np.linalg.inv(M64[~singular])
        M_inv = M_inv.astype(np.float32)
        ones = np.ones_like(pred[..., :1])
        uv1 = np.concatenate([pred[..., :2], ones], axis=-1)
        uv = np.einsum("bij,bkj->bki", M_inv, uv1)
        pred[..., :2] = uv[..., :2]
        self._uvd_pred.append(pred.copy())

        xyz_pred = uvd2xyz_np(pred, self.paras, self.flip)
        xyz_gt = gt * (cube[:, None, :] / 2.0) + center[:, None, :]
        self._dists.append(
            np.sqrt(((xyz_gt - xyz_pred) ** 2).sum(-1))
        )

    # reference-compatible single-sample feed (eval_tool.py:20)
    def feed(self, jt_uvd_pred, jt_xyz_gt, center_xyz, M, cube):
        self.feed_batch(jt_uvd_pred[None], jt_xyz_gt[None],
                        np.asarray(center_xyz)[None], np.asarray(M)[None],
                        np.asarray(cube)[None])

    @property
    def distances(self) -> np.ndarray:
        """(N, J) mm distances accumulated so far."""
        if not self._dists:
            return np.zeros((0, self.num_kp), np.float32)
        return np.concatenate(self._dists, axis=0)

    @property
    def predictions_uvd(self) -> np.ndarray:
        """(N, J, 3) predictions in original camera uvd coordinates."""
        if not self._uvd_pred:
            return np.zeros((0, self.num_kp, 3), np.float32)
        return np.concatenate(self._uvd_pred, axis=0)

    def get_measures(self):
        """(mpe, median, auc, pck_curve, thresholds); reference
        eval_tool.py:80-122 semantics (per-joint means averaged)."""
        d = self.distances  # (N, J)
        thresholds = np.linspace(0, 50, 100)
        per_joint_mean = d.mean(axis=0)
        per_joint_median = np.median(d, axis=0)
        # pck[j, t] = fraction of frames with dist <= t
        pck = (d[..., None] <= thresholds[None, None, :]).mean(axis=0)
        trapz = getattr(np, "trapezoid", None) or np.trapz
        auc_per_joint = trapz(pck, thresholds, axis=-1) / 50.0
        return (
            float(per_joint_mean.mean()),
            float(per_joint_median.mean()),
            float(auc_per_joint.mean()),
            pck.mean(axis=0),
            thresholds,
        )

    def plot_pck(self, path, pck_curve=None, thresholds=None):
        """PCK curve PNG (reference eval_tool.py:124-135): % of correct
        keypoints (0-100) against the threshold in mm, on a 10 mm x 10 %
        grid, the curve in blue with a dot at each threshold.  No axis
        labels: the port draws without a font."""
        if pck_curve is None:
            _, _, _, pck_curve, thresholds = self.get_measures()
        h, w, margin = 480, 640, 40
        image = np.full((h, w, 3), 255.0)
        x_max = float(thresholds[-1]) or 1.0

        def px(t, pct):
            return (int(round(margin + (w - 2 * margin) * t / x_max)),
                    int(round(h - margin - (h - 2 * margin) * pct / 100.0)))

        gray, black, blue = (200, 200, 200), (0, 0, 0), (31, 119, 180)
        for t in np.arange(0.0, x_max + 1e-9, 10.0):
            draw_line(image, px(t, 0), px(t, 100), gray)
        for pct in range(0, 101, 10):
            draw_line(image, px(0, pct), px(x_max, pct), gray)
        for a, b in (((0, 0), (x_max, 0)), ((0, 0), (0, 100)),
                     ((x_max, 0), (x_max, 100)), ((0, 100), (x_max, 100))):
            draw_line(image, px(*a), px(*b), black)
        pts = [px(float(t), float(p) * 100)
               for t, p in zip(thresholds, pck_curve)]
        for a, b in zip(pts, pts[1:]):
            draw_line(image, a, b, blue)
        for p in pts:
            draw_disk(image, p, blue)
        write_png(path, image)

    def save_predictions(self, path: str):
        """Reference-format txt dump: N rows of J*3 '%.3f' floats
        (reference test.py:105-108) — comparable to results/*.txt."""
        uvd = self.predictions_uvd
        np.savetxt(path, uvd.reshape(uvd.shape[0], -1), fmt="%.3f")


def load_prediction_txt(path: str, jt_num: int = 14) -> np.ndarray:
    """Load a reference-format prediction dump -> (N, J, 3) uvd."""
    arr = np.loadtxt(path, dtype=np.float32)
    return arr.reshape(arr.shape[0], jt_num, 3)
