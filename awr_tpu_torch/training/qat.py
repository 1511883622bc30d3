"""Quantization-aware fine-tuning (QAT) for int8 serving (the JAX
package's ``training/qat.py``).

Post-training int8 (``models/quant.py``, ``Predictor.quantize``) costs
accuracy.  QAT recovers it: starting from trained float weights, a short
fine-tune runs the forward fake-quantized (mode "qat": the int8 rounding
of weights and activations in the forward, straight-through gradients),
so the weights move onto the int8 grid.  The activation scales are
calibrated once and frozen during the fine-tune; serving then runs mode
"int8" with the same scales, so the int8 forward computes what the
fine-tune optimized.

The default budget is the gentle recipe, 100 steps at 1e-5
(:func:`gap_scaled_recipe`).  The defense that needs no budget rule is
validated QAT: ``Predictor.quantize_qat`` with ``holdout_batches`` keeps
the fine-tune only if it beats plain PTQ on held-out joint error.
"""

from __future__ import annotations

import copy
import itertools
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from awr_tpu_torch.config import Config
from awr_tpu_torch.models.quant import calibrate, set_int8, set_quant_mode
from awr_tpu_torch.training.optim import make_optimizer
from awr_tpu_torch.training.steps import make_eval_step, make_train_step


def gap_scaled_recipe() -> tuple:
    """The default QAT budget, ``(steps, lr)``: 100 steps at 1e-5, for
    any PTQ gap (the JAX package's function takes the gap and ignores
    it).

    The JAX package's TPU runs that chose it (its
    ``runs/convergence_qat_*.json``; MPE deltas in mm against float,
    measured on a TPU v5e, not by this port):

    | model       | PTQ gap  | 500 @ 1e-4 (aggressive) | 100 @ 1e-5 (gentle) |
    |-------------|----------|-------------------------|---------------------|
    | resnet_18   | +0.129   | closed gap, beat fp     | beat fp too: -0.057 |
    |             | / +0.018 |                         | (r04 retrain)       |
    | hourglass_1 | +0.072   | overfit: +0.060 WORSE   | +0.003              |
    | resnet_50   | +0.48-87 | DESTABILIZED: +1.565,   | +0.176 (80% of gap  |
    |             |          | tune loss itself ROSE   | recovered)          |

    The gentle budget never hurt and twice ended below the float model;
    the aggressive one hurt 2 of 3.  Gap size did not predict the safe
    budget (resnet_50's gap was 4-7x resnet_18's, and 1e-4 made its int8
    worse than no QAT).  Prefer ``Predictor.quantize_qat`` with
    ``holdout_batches``, which falls back to PTQ when the fine-tune
    regressed.
    """
    return 100, 1e-5


def _device_batches(batches, device) -> list:
    return [{k: torch.from_numpy(np.ascontiguousarray(b[k], np.float32))
             .to(device)
             for k in ("img", "jt_uvd")} for b in batches]


def finetune(cfg: Config, model: nn.Module,
             batches: Sequence[Dict[str, np.ndarray]], *,
             steps: int = 300, lr: float = 1e-4, percentile: float = 99.99,
             quant: Optional[Dict[str, torch.Tensor]] = None):
    """QAT fine-tune a copy of trained ``model`` to the int8 grid.

    Args:
      cfg: the model and loss config the weights were trained with.
      model: the trained backbone, in its compute dtype; left unchanged.
      batches: dicts of ``img`` (B, S, S) normalized depth and ``jt_uvd``
        (B, J, 3) normalized targets, cycled if ``steps`` exceeds their
        number; they are the calibration set too.
      steps: optimizer updates.
      lr: the learning rate; :func:`gap_scaled_recipe`'s (100, 1e-5) is
        the measured-safe default, this function's are for explicit
        callers.
      percentile: the calibration statistic (``Predictor.quantize``'s).
      quant: activation scales by layer name; skips the calibration
        (e.g. a PTQ Predictor's).

    Returns ``(model, quant, losses)``: the fine-tuned copy in mode
    "int8" with the frozen scales ``quant``, in eval mode; and the loss
    of every step as Python floats.  The copy trains with a fresh
    ``make_optimizer`` Adam through the port's own train step.
    """
    if not batches:
        raise ValueError("QAT fine-tune needs at least one batch")
    device = next(model.parameters()).device
    dev_batches = _device_batches(batches, device)
    qat = copy.deepcopy(model)
    if quant is None:
        quant = calibrate(qat, [b["img"] for b in dev_batches],
                          percentile=percentile)
    set_quant_mode(set_int8(qat, quant), "qat")
    optimizer = make_optimizer(qat.parameters(), cfg.optimizer, lr,
                               cfg.weight_decay)
    step = make_train_step(qat, optimizer, cfg)
    losses = [step(batch)["loss"]
              for _, batch in zip(range(steps), itertools.cycle(dev_batches))]
    losses = [float(x) for x in losses]
    set_quant_mode(qat, "int8")
    return qat.eval(), quant, losses


def batches_from_dataset(dataset, batch_size: int = 32,
                         n_batches: Optional[int] = None) -> list:
    """Host-mode ``img``/``jt_uvd`` batches of a dataset (the
    ``data/base.py`` protocol) for :func:`finetune`."""
    if getattr(dataset, "mode", "host") != "host":
        raise ValueError("QAT batches come from a host-mode dataset")
    out = []
    for batch in dataset.batches(batch_size):
        out.append({"img": np.asarray(batch["img"], np.float32),
                    "jt_uvd": np.asarray(batch["jt_uvd"], np.float32)})
        if n_batches is not None and len(out) >= n_batches:
            break
    return out


@torch.no_grad()
def int8_holdout_metrics(cfg: Config, quant,
                         batches: Sequence[Dict[str, np.ndarray]],
                         *candidates: nn.Module) -> list:
    """Eval-mode int8 metrics over labeled holdout batches, one
    ``{"loss", "joint_err"}`` dict per candidate model.  Each candidate
    is switched to int8 with the same frozen scales ``quant`` (in place)
    and scored by the port's eval step.

    ``joint_err`` is the mean L2 error of the decoded joints in
    normalized uvd, the linear proxy for the mm MPE, and the metric
    ``Predictor.quantize_qat``'s fallback gates on; ``loss`` (the
    smooth-L1 objective) is recorded beside it: a fine-tune can lower
    the loss while the joints get worse."""
    out = []
    for model in candidates:
        device = next(model.parameters()).device
        step = make_eval_step(set_int8(model, quant), cfg)
        tot_loss, tot_err, n = 0.0, 0.0, 0
        for batch in _device_batches(batches, device):
            m = step(batch)
            nb = len(batch["img"])
            err = np.linalg.norm(
                m["jt_uvd_pred"].cpu().numpy().astype(np.float64)
                - batch["jt_uvd"].cpu().numpy().astype(np.float64), axis=-1)
            tot_loss += float(m["loss"]) * nb
            tot_err += float(err.mean()) * nb
            n += nb
        out.append(dict(loss=tot_loss / max(n, 1),
                        joint_err=tot_err / max(n, 1)))
    return out


def int8_holdout_loss(cfg: Config, quant,
                      batches: Sequence[Dict[str, np.ndarray]],
                      *candidates: nn.Module) -> list:
    """The mean eval-mode loss of each candidate
    (:func:`int8_holdout_metrics`' ``loss``)."""
    return [m["loss"] for m in
            int8_holdout_metrics(cfg, quant, batches, *candidates)]
