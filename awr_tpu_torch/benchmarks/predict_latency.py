"""Time ``Predictor.predict`` on the card: hourglass_1 in float32 and
resnet_18 in bfloat16 (img 128, seeded random weights, 480x640 synthetic
frames) at batches 1, 32 and 256.  Each time is the host clock around one
call, which ends with the joints on the host; the median and range of
REPS calls after WARM.  :func:`predict_ms` is also how ``chip_smoke.py``
times its requests.

    python -m awr_tpu_torch.benchmarks.predict_latency [--out times.json]

Prints one JSON line with the card's name and power limit.  It imports the
first ``awr_tpu_torch`` on the path, so one call can time two trees in
turns: ``PYTHONPATH=<tree> python <path of this file>``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from awr_tpu_torch.config import hourglass_config, resnet_config
from awr_tpu_torch.data.synthetic import synthetic_frames
from awr_tpu_torch.models import build_model
from awr_tpu_torch.models.common import torch_default_init_
from awr_tpu_torch.serving import Predictor

BATCHES = (1, 32, 256)
WARM = 3
REPS = 15


def predict_ms(pred, imgs, centers, reps=REPS) -> dict:
    """Host ms of ``pred.predict(imgs, centers)``: the median, least and
    most of ``reps`` calls after WARM."""
    for _ in range(WARM):
        pred.predict(imgs, centers)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        pred.predict(imgs, centers)
        times.append((time.perf_counter() - t0) * 1e3)
    return {"median": float(np.median(times)), "min": float(np.min(times)),
            "max": float(np.max(times)), "reps": reps}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("predict_latency times the card: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    frames, _, centers = synthetic_frames(32, 14, seed=0)
    reps = -(-max(BATCHES) // len(frames))
    frames = np.tile(frames, (reps, 1, 1))
    centers = np.tile(centers, (reps, 1))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]
    out = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "torch": torch.__version__, "predict_ms": {}}
    for cfg in (hourglass_config(), resnet_config(compute_dtype="bfloat16")):
        model = build_model(cfg.net, cfg.jt_num, cfg.downsample)
        torch_default_init_(model, torch.Generator().manual_seed(0))
        pred = Predictor(cfg, model, device="cuda")
        out["predict_ms"][f"{cfg.net} {cfg.compute_dtype}"] = {
            str(b): predict_ms(pred, frames[:b], centers[:b])
            for b in BATCHES}
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
