"""Seeded random weights, made on the device in a few large calls and
handed to the program and to the reference alike.

Convolution and transposed-convolution weights are N(0, 2 / fan_in),
their biases N(0, 0.01^2); BatchNorm scales 1 + N(0, 0.1^2) and shifts
N(0, 0.1^2), all from one ``torch.Generator`` on the device seeded by
``--seed``.  Then the BatchNorm running statistics are set to those of
the first frames' crops (one train-mode forward of the reference with
cuDNN's deterministic algorithms), so that eval-mode activations keep
unit scale, and the two heads are rescaled so that on those crops the
offset channels have a standard deviation of 0.3 and the heatmap
channels 0.05: a softmax over ``30 * heatmap`` that weighs many pixels
and still follows the map.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch import nn

from portbench.reference import data, models

OFFSET_STD = 0.3
HEATMAP_STD = 0.05
CALIB_FRAMES = 16


@contextlib.contextmanager
def deterministic():
    was = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = was


@torch.no_grad()
def make(config: dict, seed: int, pool, device) -> dict:
    """The state dict (reference key layout, float32 on ``device``) of
    the configuration's backbone for ``seed``; ``pool``'s first frames
    set the BatchNorm statistics and the heads' scale."""
    with torch.device("meta"):
        model = models.build(config)
    model = model.to_empty(device=device)
    g = torch.Generator(device).manual_seed(seed % 2 ** 63)
    convs = [m for m in model.modules()
             if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d))]
    bns = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
    # every conv weight in one draw, scaled leaf by leaf
    ws = [m.weight for m in convs]
    fan_in = [(w.shape[1] if isinstance(m, nn.Conv2d) else w.shape[0])
              * w[0, 0].numel() for m, w in zip(convs, ws)]
    flat = torch.randn(sum(w.numel() for w in ws), generator=g,
                       device=device)
    scale = torch.repeat_interleave(
        torch.tensor([(2.0 / f) ** 0.5 for f in fan_in], device=device),
        torch.tensor([w.numel() for w in ws], device=device))
    torch._foreach_copy_(ws, [v.view_as(w) for v, w in zip(
        (flat * scale).split([w.numel() for w in ws]), ws)])
    biases = [m.bias for m in convs if m.bias is not None]
    flat = torch.randn(sum(b.numel() for b in biases), generator=g,
                       device=device) * 0.01
    torch._foreach_copy_(biases, list(flat.split([b.numel()
                                                   for b in biases])))
    n_bn = sum(m.num_features for m in bns)
    flat = torch.randn(2 * n_bn, generator=g, device=device) * 0.1
    parts = list(flat.split([m.num_features for m in bns] * 2))
    torch._foreach_copy_([m.weight for m in bns], [1.0 + p for p in
                                                   parts[:len(bns)]])
    torch._foreach_copy_([m.bias for m in bns], parts[len(bns):])

    # BatchNorm statistics of the first frames' crops, then the heads'
    # scale on them
    crops = _crops(pool, config, CALIB_FRAMES, device)
    for m in bns:
        m.reset_running_stats()
        m.momentum = None  # a cumulative average: one batch's statistics
    with deterministic():
        model.train()(crops[:, None])
        for m in bns:
            m.momentum = 0.1
        out = models.stacked(model.eval()(crops[:, None]))[-1]
    J = config["joint_num"]
    for head, want, part in zip(models.heads(config, model), (OFFSET_STD, HEATMAP_STD),
                                (out[:, :3 * J], out[:, 3 * J:])):
        f = want / float(part.std())
        head.weight.mul_(f)
        head.bias.mul_(f)
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def reference_model(config: dict, state: dict, device) -> nn.Module:
    """The reference backbone holding ``state``."""
    with torch.device("meta"):
        model = models.build(config)
    model = model.to_empty(device=device)
    model.load_state_dict(state)
    return model


def _crops(pool, config: dict, n: int, device) -> torch.Tensor:
    """Normalized crops of the pool's first ``n`` frames, on ``device``."""
    n = min(n, len(pool))
    frames = torch.from_numpy(pool.frames[:n]).to(device)
    centers_uvd = data.xyz2uvd_np(pool.centers[:n], pool.paras, pool.flip)
    return data.eval_crops(frames, centers_uvd, pool.cubes(n), pool.paras,
                           config["img_size"])[0]


def calib_crops(pool, config: dict, n: int, device) -> np.ndarray:
    """Normalized crops of the pool's first ``n`` frames, on the host."""
    return _crops(pool, config, n, device).cpu().numpy()
