"""The train step and the inference step in plain PyTorch, with a plain
Adam (reference train.py:107-131, test.py:67-97).

Training: the target map from the labels, one forward of every stack,
``dense_weight`` x smooth-L1(map, target) + ``coord_weight`` x
smooth-L1(decoded joints, labels) summed over the stacks, the backward,
and Adam(betas (0.9, 0.999), eps 1e-8, no weight decay).
"""

from __future__ import annotations

import torch

from portbench.reference import awr
from portbench.reference.models import stacked


class Adam:
    """``p -= lr * m_hat / (sqrt(v_hat) + eps)`` with the bias-corrected
    first and second moments of the gradient."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps=1e-8):
        self.params = [p for p in params if p.requires_grad]
        self.lr, self.betas, self.eps = lr, betas, eps
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self):
        self.t += 1
        b1, b2 = self.betas
        for p, m, v in zip(self.params, self.m, self.v):
            g = p.grad
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            m_hat = m / (1 - b1 ** self.t)
            v_hat = v / (1 - b2 ** self.t)
            p.sub_(self.lr * m_hat / (v_hat.sqrt() + self.eps))


def train_step(model, opt: Adam, img, jt_uvd, cfg: dict):
    """One step on normalized crops ``img`` (B, S, S) and labels
    ``jt_uvd`` (B, J, 3).  Returns (loss, (B, J, 3) joints decoded from
    the last stack), detached."""
    k, F = cfg["kernel_size"], cfg["feature_size"]
    model.train()
    for p in opt.params:
        p.grad = None
    target = awr.encode(jt_uvd, img, k, F)
    preds = stacked(model(img[:, None]))
    loss = 0.0
    for s in range(preds.shape[0]):
        jt_pred = awr.decode(preds[s], img, k)
        loss = (loss + cfg["dense_weight"] * awr.smooth_l1(preds[s], target)
                + cfg["coord_weight"] * awr.smooth_l1(jt_pred, jt_uvd))
    loss.backward()
    opt.step()
    return loss.detach(), jt_pred.detach()


@torch.no_grad()
def infer(model, img, kernel_size: float):
    """(B, S, S) normalized crops -> (B, J, 3) normalized joints decoded
    from the last stack, the model in eval mode."""
    model.eval()
    return awr.decode(stacked(model(img[:, None]))[-1], img, kernel_size)
