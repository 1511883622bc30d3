"""Sustained-convergence check through the port's Trainer: >= 10x
held-out MPE improvement (the JAX package's
``benchmarks/convergence_run.py``, without its int8 and QAT options).

Trains the raw-mode path (device crop and augmentation -> CUDA encode ->
backbone -> CUDA decode -> delta = 0.01 smooth-L1 -> Adam) on the fully
visible synthetic layout (``SyntheticHandDataset(layout="grid")``: every
joint's sphere is observable, so the task has no occlusion error floor)
and asserts that the held-out test MPE improves >= 10x from the
untrained baseline.

Usage:
  python -m awr_tpu_torch.benchmarks.convergence_run --net hourglass_1 \\
      --epochs 200 --coord-weight 0.1 \\
      --out runs/torch_convergence_hourglass_h100.json

The reference recipe analog: batch 32, Adam lr 1e-3 (reference
config.py:36-46); StepLR decay pushed late (step=100), since this run is
about optimization depth, not the NYU schedule.  Under
``awr_tpu_torch.training.supervise`` with ``--step-timeout``, a restarted
run resumes from the workdir's checkpoints and keeps the first run's
baseline.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

from awr_tpu_torch.config import Config
from awr_tpu_torch.data.synthetic import SyntheticHandDataset
from awr_tpu_torch.training.trainer import Trainer


def device_label(device: str) -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them,
    or the device's type where there is no card."""
    if not device.startswith("cuda"):
        return device
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.splitlines()[0]


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--net", default="resnet_18")
    ap.add_argument("--epochs", type=int, default=125)
    ap.add_argument("--train-size", type=int, default=512)
    ap.add_argument("--test-size", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--coord-weight", type=float, default=0.0,
                    help="direct joint-coordinate loss weight (reference "
                         "config.py:41); the hourglass needs it on this "
                         "task (0.1)")
    ap.add_argument("--out", default="runs/torch_convergence.json")
    ap.add_argument("--workdir", default="runs/torch_convergence")
    ap.add_argument("--step-timeout", type=float, default=0.0,
                    help="arm the stall watchdog (Config.step_timeout_s) "
                         "so a wedged device call exits 86 for "
                         "training.supervise to restart")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    ks = 1.0 if args.net.startswith("resnet") else 0.4
    cfg = Config(net=args.net, kernel_size=ks, img_size=128,
                 batch_size=32, vis_freq=0, print_freq=1000,
                 max_epoch=args.epochs, step=100, lr=args.lr,
                 coord_weight=args.coord_weight,
                 exp_id=f"convergence_{args.net}",
                 ckpt_max_to_keep=2,
                 step_timeout_s=args.step_timeout or None)
    train = SyntheticHandDataset(args.train_size, cfg.jt_num, 128,
                                 phase="train", seed=0, layout="grid")
    test = SyntheticHandDataset(args.test_size, cfg.jt_num, 128,
                                phase="test", seed=1, layout="grid")
    tr = Trainer(cfg, train, test, workdir=args.workdir, device=args.device)

    t0 = time.time()
    # The untrained baseline, measured once: a restarted run restores
    # the newest checkpoint at construction, so measuring again would
    # score trained weights as the baseline.
    init_path = os.path.join(tr.work_dir, "init_mpe.json")
    resumed_from = int(tr.best_records["epoch"])
    if os.path.exists(init_path):
        with open(init_path) as fh:
            init_mpe = json.load(fh)["init_test_mpe_mm"]
    else:
        if resumed_from != 0:
            raise RuntimeError(
                "workdir has a checkpoint but no recorded init MPE; point "
                "--workdir at a fresh directory")
        init_mpe, _ = tr.test(epoch=0)
        with open(init_path, "w") as fh:
            json.dump({"init_test_mpe_mm": float(init_mpe)}, fh)
    tr.train()
    final_mpe = tr.best_records["MPE"]
    wall = time.time() - t0
    tr.close()

    improvement = init_mpe / final_mpe
    result = dict(net=args.net, epochs=args.epochs,
                  steps=args.epochs * (args.train_size // 32),
                  coord_weight=args.coord_weight,
                  init_test_mpe_mm=float(init_mpe),
                  final_test_mpe_mm=float(final_mpe),
                  improvement_x=float(improvement),
                  best_epoch=tr.best_records["best_epoch"],
                  resumed_from_epoch=resumed_from,
                  wall_s=wall, device=device_label(args.device))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(result, fh, indent=1)
    print(json.dumps(result))
    if improvement < 10.0:
        raise SystemExit(
            f"convergence regression: only {improvement:.1f}x "
            f"({init_mpe:.1f} -> {final_mpe:.1f} mm)")


if __name__ == "__main__":
    main()
