"""Sustained-convergence check through the port's Trainer: >= 10x
held-out MPE improvement (the JAX package's
``benchmarks/convergence_run.py``), and with ``--int8-eval`` the
accuracy of int8 serving on the trained weights, after PTQ and after a
QAT fine-tune.

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
  # the same recipe with the backbone in bf16
  python -m awr_tpu_torch.benchmarks.convergence_run --net hourglass_1 \\
      --epochs 200 --coord-weight 0.1 --compute-dtype bfloat16 \\
      --out runs/torch_convergence_hourglass_bf16_h100.json
  # then int8: PTQ, and QAT with the gentle recipe (100 steps at 1e-5)
  python -m awr_tpu_torch.benchmarks.convergence_run --net resnet_18 \\
      --epochs 125 --compute-dtype bfloat16 --int8-eval --qat-auto \\
      --out runs/torch_convergence_qat_resnet18_h100.json

The reference recipe analog: batch 32, Adam lr 1e-3 (reference
config.py:36-46); StepLR decay pushed late (step=100), since this run is
about optimization depth, not the NYU schedule.  Under
``awr_tpu_torch.training.supervise`` with ``--step-timeout``, a restarted
run resumes from the workdir's checkpoints and keeps the first run's
baseline.

``--int8-eval`` calibrates int8 scales (p99.99) on 4 host-mode batches of
the train set, then reports the held-out MPE of the final weights in
float and in int8; ``--qat-auto`` then fine-tunes them for the
``training.qat.gap_scaled_recipe`` budget (100 steps at 1e-5) with the
same frozen scales on the train set's batches and reports the int8 MPE
again, with the fine-tune's first and last loss.  The keys are the JAX
package's (``runs/convergence_qat_*.json``).  The JAX script's
``--qat-steps``/``--qat-lr`` are left out: its runs and the port's use
the recipe, whose budget does not depend on the PTQ gap.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch

from awr_tpu_torch.config import Config
from awr_tpu_torch.data.synthetic import SyntheticHandDataset
from awr_tpu_torch.models.quant import calibrate, set_int8
from awr_tpu_torch.training import qat
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


def int8_eval(tr, cfg, args) -> dict:
    """Held-out MPE of the Trainer's final weights in float and in int8
    (PTQ), then, with ``args.qat_auto``, after the recipe's QAT; leaves
    the Trainer's model in int8 with the fine-tuned weights if QAT ran."""
    host = SyntheticHandDataset(args.train_size, cfg.jt_num, 128,
                                phase="train", seed=0, layout="grid",
                                mode="host")
    fp_mpe, _ = tr.test(epoch=-3)
    calib = [torch.from_numpy(b["img"]).to(tr.device)
             for b in qat.batches_from_dataset(host, 32, 4)]
    # p99.99: the serving default (Predictor.quantize)
    quant = calibrate(tr.model, calib, percentile=99.99)
    set_int8(tr.model, quant)
    int8_mpe, _ = tr.test(epoch=-2)
    out = dict(final_state_fp_mpe_mm=float(fp_mpe),
               final_state_int8_mpe_mm=float(int8_mpe),
               int8_mpe_delta_mm=float(int8_mpe - fp_mpe))
    if args.qat_auto:
        steps, lr = qat.gap_scaled_recipe()
        batches = qat.batches_from_dataset(host, 32, args.train_size // 32)
        tuned, _, losses = qat.finetune(cfg, tr.model, batches, steps=steps,
                                        lr=lr, quant=quant)
        tr.model.load_state_dict(tuned.state_dict())
        qat_mpe, _ = tr.test(epoch=-4)
        out.update(qat_recipe="gap_scaled", qat_steps=steps, qat_lr=lr,
                   qat_int8_mpe_mm=float(qat_mpe),
                   qat_mpe_delta_mm=float(qat_mpe - fp_mpe),
                   qat_loss_first=losses[0], qat_loss_last=losses[-1])
    return out


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
    ap.add_argument("--compute-dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--int8-eval", action="store_true",
                    help="after training, calibrate int8 on train batches "
                         "and report the int8 held-out MPE beside the "
                         "float one")
    ap.add_argument("--qat-auto", action="store_true",
                    help="with --int8-eval: then QAT fine-tune for the "
                         "training.qat.gap_scaled_recipe budget (frozen "
                         "scales) and report the int8 MPE again")
    args = ap.parse_args(argv)

    ks = 1.0 if args.net.startswith("resnet") else 0.4
    cfg = Config(net=args.net, kernel_size=ks, img_size=128,
                 batch_size=32, vis_freq=0, print_freq=1000,
                 max_epoch=args.epochs, step=100, lr=args.lr,
                 coord_weight=args.coord_weight,
                 compute_dtype=args.compute_dtype,
                 exp_id=f"convergence_{args.net}",
                 ckpt_max_to_keep=2,
                 step_timeout_s=args.step_timeout or None)
    train = SyntheticHandDataset(args.train_size, cfg.jt_num, 128,
                                 phase="train", seed=0, layout="grid",
                                 mode="raw")
    test = SyntheticHandDataset(args.test_size, cfg.jt_num, 128,
                                phase="test", seed=1, layout="grid",
                                mode="raw")
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
    int8_metrics = int8_eval(tr, cfg, args) if args.int8_eval else {}
    tr.close()

    improvement = init_mpe / final_mpe
    result = dict(net=args.net, epochs=args.epochs,
                  steps=args.epochs * (args.train_size // 32),
                  coord_weight=args.coord_weight,
                  compute_dtype=args.compute_dtype,
                  init_test_mpe_mm=float(init_mpe),
                  final_test_mpe_mm=float(final_mpe),
                  improvement_x=float(improvement),
                  best_epoch=tr.best_records["best_epoch"],
                  resumed_from_epoch=resumed_from,
                  wall_s=wall, device=device_label(args.device),
                  **int8_metrics)
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
