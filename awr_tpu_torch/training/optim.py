"""Optimizers and learning-rate schedules (reference train.py:66-69,
89-92): Adam or SGD(momentum 0.9), both with coupled L2 weight decay,
and StepLR(gamma 0.1) or ReduceLROnPlateau('min', patience 2, min_lr
1e-8) as host-side rules that set the learning rate between epochs."""

from __future__ import annotations

import torch


def make_optimizer(params, name: str, lr: float,
                   weight_decay: float = 0.0) -> torch.optim.Optimizer:
    """``torch.optim.Adam(betas=(0.9, 0.999), eps=1e-8)`` or
    ``torch.optim.SGD(momentum=0.9)``.  Their ``weight_decay`` adds
    ``wd * p`` to the gradient before the adaptive scaling or momentum,
    the coupled decay the reference trains with (not AdamW's)."""
    if name == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=weight_decay)
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=0.9,
                               weight_decay=weight_decay)
    raise ValueError(f"unknown optimizer {name!r}")


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float):
    """Set every parameter group's learning rate (between steps)."""
    for group in optimizer.param_groups:
        group["lr"] = lr
    return optimizer


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


def step_lr(base_lr: float, epoch: int, step_size: int,
            gamma: float = 0.1) -> float:
    """torch StepLR as the reference schedules it: ``scheduler.step(e)``
    runs at the end of epoch e (train.py:160), so 1-based epoch E trains
    at ``base * gamma^((E-1) // step_size)``: with the NYU step of 30,
    epoch 30 still runs at the full rate and epoch 31 is the first
    decayed one."""
    return base_lr * gamma ** ((epoch - 1) // step_size)


class PlateauScheduler:
    """torch ReduceLROnPlateau('min', patience=2, factor=0.1, min_lr=1e-8,
    relative threshold 1e-4) (reference train.py:90): after more than
    ``patience`` epochs without improvement the rate is multiplied by
    ``factor``."""

    def __init__(self, base_lr: float, factor: float = 0.1,
                 patience: int = 2, min_lr: float = 1e-8,
                 threshold: float = 1e-4):
        self.lr = base_lr
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.threshold = threshold
        self.best = float("inf")
        self.num_bad = 0

    def step(self, metric: float) -> float:
        if metric < self.best * (1 - self.threshold):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad = 0
        return self.lr
