"""The drift of bf16 compute (and of int8 under bf16) from float32 on
trained weights: one checkpoint served by a Predictor in each precision
on the convergence recipe's held-out frames (``SyntheticHandDataset(
layout="grid")``, seed 1, 64 frames).  Records numbers; gates nothing.

Per precision, the Predictor's MPE (mm) and its joints' distance (mm,
camera xyz) from the float32 Predictor's.  For a ResNet-deconv, also
int8 Predictors in float32 and bf16, calibrated on the recipe's first 64
train frames, and the bf16 int8 joints' distance from the float32 int8
ones.

Usage (on the GPU):
  python -m awr_tpu_torch.benchmarks.precision_drift --net hourglass_1 \\
      --checkpoint <workdir>/ckpt/200.pth \\
      --out runs/torch_precision_drift_hourglass_h100.json
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from awr_tpu_torch.benchmarks.convergence_run import device_label
from awr_tpu_torch.config import Config
from awr_tpu_torch.data.device import crop_normalize_batch
from awr_tpu_torch.data.synthetic import SyntheticHandDataset
from awr_tpu_torch.geometry import xyz2uvd_np
from awr_tpu_torch.serving import Predictor

DTYPES = ("float32", "bfloat16")
FRAMES = 64  # the recipe's test and calibration frames


def frames_of(ds):
    items = [ds.raw_item(i) for i in range(len(ds))]
    return tuple(np.stack([it[k] for it in items]) for k in range(3))


def mpe(pred_xyz, jt_xyz) -> float:
    return float(np.linalg.norm(pred_xyz - jt_xyz, axis=-1).mean())


def drift(a, b) -> dict:
    d = np.linalg.norm(a - b, axis=-1)
    return {"mean": float(d.mean()), "max": float(d.max())}


def _crops(pred, imgs, centers):
    """The normalized crops ``pred`` makes of raw frames."""
    img, _ = crop_normalize_batch(
        torch.from_numpy(imgs).to(pred.device),
        xyz2uvd_np(centers, pred.paras, pred.flip),
        np.tile(pred.cfg.cube, (len(imgs), 1)), pred.paras,
        pred.cfg.img_size)
    return img.cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--net", default="hourglass_1")
    ap.add_argument("--checkpoint", required=True, help="a Trainer .pth")
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    int8 = args.net.startswith("resnet")  # int8 serves the ResNet-deconv
    cfg = Config(net=args.net, kernel_size=1.0 if int8 else 0.4,
                 img_size=128)
    pth = torch.load(args.checkpoint, map_location="cpu", weights_only=True)
    state = pth.get("model", pth)
    test = SyntheticHandDataset(FRAMES, cfg.jt_num, 128, phase="test",
                                seed=1, layout="grid", mode="raw")
    imgs, jt_xyz, centers = frames_of(test)
    preds = {dt: Predictor(cfg.replace(compute_dtype=dt), state,
                           device=args.device) for dt in DTYPES}
    if int8:
        train = SyntheticHandDataset(FRAMES, cfg.jt_num, 128, phase="train",
                                     seed=0, layout="grid", mode="raw")
        cal_imgs, _, cal_centers = frames_of(train)
        for dt in DTYPES:
            p = preds[f"int8_{dt}"] = Predictor(
                cfg.replace(compute_dtype=dt), state, device=args.device)
            p.quantize(_crops(p, cal_imgs, cal_centers))
    xyz = {k: p.predict_xyz(imgs, centers) for k, p in preds.items()}
    result = dict(net=args.net, checkpoint=args.checkpoint,
                  device=device_label(args.device), frames=FRAMES,
                  predictor_mpe_mm={k: mpe(v, jt_xyz)
                                    for k, v in xyz.items()},
                  joint_drift_from_float32_mm={
                      k: drift(v, xyz["float32"])
                      for k, v in xyz.items() if k != "float32"})
    if int8:
        result["int8_bf16_drift_from_int8_float32_mm"] = drift(
            xyz["int8_bfloat16"], xyz["int8_float32"])
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(result, fh, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
