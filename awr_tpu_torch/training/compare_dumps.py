"""Frame-by-frame diff of two prediction dumps (data-arrival-day tool;
the JAX package's ``training/compare_dumps.py``).

The reference's regression artifact is the prediction txt dump —
``test_%.3f.txt``, N rows of J*3 '%.3f' camera-coord uvd floats, written
by reference test.py:105-108 and shipped as ``results/resnet_18.txt`` /
``results/hourglass_1.txt``.  This tool compares OUR dump against a
golden one in mm space:

- per-frame / per-joint 3D distances (uvd -> xyz via the dataset
  intrinsics, the same de-projection eval_tool.py:43 uses),
- overall mean/median/p99/max, per-joint means,
- the worst-K frames (index + error) for visual triage,
- a machine-readable JSON line, and an exit code gated on ``--tol-mm``
  so the recipe is scriptable (REPRO.md).

Usage::

    python -m awr_tpu_torch.training.compare_dumps \
        <reference>/results/resnet_18.txt output/.../test_8.123.txt \
        [--dataset nyu] [--tol-mm 0.1] [--worst 10] [--report out.json]

Both files must have the same frame count and order (the NYU test split
is glob-ordered by frame id in both frameworks, nyu_loader.py:76-83).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from awr_tpu_torch.evaluation import load_prediction_txt
from awr_tpu_torch.geometry import uvd2xyz_np

# dataset -> (intrinsics, flip); NYU values from reference
# nyu_loader.py:23,34
DATASET_CAMERA = {
    "nyu": ((588.03, 587.07, 320.0, 240.0), -1),
    "icvl": ((240.99, 240.96, 160.0, 120.0), 1),
    "msra": ((241.42, 241.42, 160.0, 120.0), 1),
    "hands17": ((475.065948, 475.065857, 315.944855, 245.287079), 1),
}


def compare(golden: np.ndarray, ours: np.ndarray, paras, flip):
    """(N, J, 3) uvd dumps -> dict of mm-space diff statistics."""
    if golden.shape != ours.shape:
        raise ValueError(
            f"shape mismatch: golden {golden.shape} vs ours {ours.shape}"
            " — different frame count or joint count")
    xyz_g = uvd2xyz_np(golden.astype(np.float64), paras, flip)
    xyz_o = uvd2xyz_np(ours.astype(np.float64), paras, flip)
    d = np.linalg.norm(xyz_o - xyz_g, axis=-1)  # (N, J) mm
    per_frame = d.mean(axis=1)
    order = np.argsort(per_frame)[::-1]
    return dict(
        frames=int(d.shape[0]),
        joints=int(d.shape[1]),
        mean_mm=float(d.mean()),
        median_mm=float(np.median(d)),
        p99_mm=float(np.percentile(d, 99)),
        max_mm=float(d.max()),
        per_joint_mean_mm=[round(float(x), 4) for x in d.mean(axis=0)],
        worst_frames=[
            dict(frame=int(i), mean_mm=round(float(per_frame[i]), 4))
            for i in order
        ],
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("golden", help="reference dump (results/*.txt)")
    ap.add_argument("ours", help="our dump (test_%%.3f.txt)")
    ap.add_argument("--dataset", default="nyu",
                    choices=sorted(DATASET_CAMERA))
    ap.add_argument("--jt-num", type=int, default=14)
    ap.add_argument("--tol-mm", type=float, default=None,
                    help="exit 1 if the mean frame error exceeds this")
    ap.add_argument("--worst", type=int, default=10,
                    help="how many worst frames to print")
    ap.add_argument("--report", default="",
                    help="write the full JSON report here")
    args = ap.parse_args(argv)

    paras, flip = DATASET_CAMERA[args.dataset]
    golden = load_prediction_txt(args.golden, args.jt_num)
    ours = load_prediction_txt(args.ours, args.jt_num)
    stats = compare(golden, ours, paras, flip)

    summary = {k: (round(v, 4) if isinstance(v, float) else v)
               for k, v in stats.items()
               if k not in ("per_joint_mean_mm", "worst_frames")}
    summary["worst_frames"] = stats["worst_frames"][: args.worst]
    print(json.dumps(summary))
    if args.report:
        with open(args.report, "w") as fh:
            json.dump(stats, fh, indent=1)
    if args.tol_mm is not None and stats["mean_mm"] > args.tol_mm:
        print(f"FAIL: mean diff {stats['mean_mm']:.4f} mm > "
              f"tolerance {args.tol_mm} mm", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
