"""Training CLI (reference train.py equivalent; the JAX package's
``training/train.py``).

Usage (on the GPU; add ``--device cpu`` on the CPU):
  python -m awr_tpu_torch.training.train --synthetic --epochs 2

Trains, tests and checkpoints every epoch under
``<output-dir>/<dataset>/checkpoint_<exp_id>/``; rerun with more
``--epochs`` to resume from the newest checkpoint there.
"""

from __future__ import annotations

import argparse

from awr_tpu_torch.training.evaluate import (add_common_args, build_config,
                                             make_datasets)


def main(argv=None):
    """Returns the (closed) Trainer, whose ``model`` and ``best_records``
    stay readable."""
    ap = argparse.ArgumentParser(description=__doc__)
    add_common_args(ap)
    ap.add_argument("--epochs", type=int, default=0,
                    help="override max_epoch (default: dataset recipe)")
    ap.add_argument("--lr", type=float, default=0.0)
    ap.add_argument("--optimizer", default="")
    ap.add_argument("--scheduler", default="")
    ap.add_argument("--grad-accum", type=int, default=1,
                    help="split each batch into N microbatches (one "
                         "optimizer update, ~N-fold lower peak "
                         "activation memory)")
    ap.add_argument("--remat", action="store_true",
                    help="rematerialize backbone blocks in the backward "
                         "pass (recompute instead of store activations)")
    ap.add_argument("--step-timeout", type=float, default=0.0,
                    help="stall watchdog: exit 86 if no train/eval step "
                         "completes for this many seconds (run under "
                         "awr_tpu_torch.training.supervise to auto-resume "
                         "from the last checkpoint); 0 = off")
    args = ap.parse_args(argv)
    cfg = build_config(args)
    over = {}
    if args.epochs:
        over["max_epoch"] = args.epochs
    if args.lr:
        over["lr"] = args.lr
    if args.optimizer:
        over["optimizer"] = args.optimizer
    if args.scheduler:
        over["scheduler"] = args.scheduler
    if args.grad_accum > 1:
        over["grad_accum"] = args.grad_accum
    if args.remat:
        over["remat"] = True
    if args.step_timeout:
        over["step_timeout_s"] = args.step_timeout
    cfg = cfg.replace(**over)

    from awr_tpu_torch.training.trainer import Trainer

    train, test = make_datasets(args, cfg, train=True)
    trainer = Trainer(cfg, train_data=train, test_data=test,
                      device=args.device)
    if args.profile_dir:
        from awr_tpu_torch.utils.profiling import trace

        with trace(args.profile_dir):
            trainer.train()
    else:
        trainer.train()
    trainer.close()
    return trainer


if __name__ == "__main__":
    main()
