"""Training: the program's raw-mode train step at a fixed batch, driven
as ``Trainer._train_impl`` drives it, without the epoch's end.

Parameters: ``batch``, ``pool`` (frames rendered from the seed, with
their joints), ``num_workers`` (``PrefetchLoader``'s), ``device_prefetch``
(the staging thread's depth), ``augment_para``, ``lr`` (Adam),
``checked_steps`` and ``warm_steps``.

The program's ``Trainer`` is built on the benchmark's weights; a
``PrefetchLoader`` reads the pool, reshuffled each pass from the seed,
through the dataset interface; ``prefetch_to_device`` stages each batch
through the Trainer's ``_stage``; each step draws its augmentation from
the Trainer's device generator under ``augment_seed(seed, 1, step)`` and
runs ``_raw_train_step`` (crop, augmentation, normalization, encode,
forward, decode, loss, backward, Adam).  The set-up runs the first
``checked_steps + warm_steps`` steps through that same loop; the window
goes on with it.  The reference replays the first ``checked_steps``.

Faults (``--fault``): ``half_batch`` runs each step on the first half of
its rows; ``stale_state`` skips the optimizer's update.  Control
(``--control``): the program with TF32 on.
"""

from __future__ import annotations

import math
import time
from types import SimpleNamespace

import numpy as np
import torch

from portbench import frames, harness, weights
from portbench.reference import data, steps

FAULTS = ("half_batch", "stale_state")
EPOCH = 1
# the fastest a step could go, frames/s: how many passes to queue
MAX_FPS = 2000


class Passes:
    """The pool as the program's raw-mode dataset: item ``i`` is frame
    ``order[i]``, the pool reshuffled for each pass from the seed."""

    mode = "raw"

    def __init__(self, pool, passes: int, seed: int):
        self.pool, self.paras, self.flip = pool, pool.paras, pool.flip
        n = len(pool)
        self.order = np.concatenate([
            np.random.default_rng([seed, 3, q]).permutation(n)
            for q in range(passes)])

    def __len__(self):
        return len(self.order)

    def __getitem__(self, i):
        k, p = self.order[i], self.pool
        return dict(img=p.frames[k], jt_xyz=p.joints[k].astype(np.float32),
                    center_xyz=p.centers[k], cube=p.cube)


def setup(run):
    from awr_tpu_torch.data.pipeline import PrefetchLoader, prefetch_to_device
    from awr_tpu_torch.training.trainer import Trainer

    p = run.params
    if run.fault is not None and run.fault not in FAULTS:
        raise ValueError(f"fault {run.fault!r}: one of {FAULTS}")
    pool = frames.Pool(run.cfg, p["pool"], run.seed, run.device)
    run.mark("frames")
    state = weights.make(run.cfg, run.seed, pool, run.device)
    run.mark("weights")
    cfg = harness.port_config(
        run, batch_size=p["batch"], num_workers=p["num_workers"],
        device_prefetch=p["device_prefetch"],
        augment_para=tuple(p["augment_para"]), lr=p["lr"],
        dense_weight=run.cfg["dense_weight"],
        coord_weight=run.cfg["coord_weight"], seed=run.seed)
    steps_needed = (p["checked_steps"] + p["warm_steps"]
                    + math.ceil((run.seconds + 30) * MAX_FPS / p["batch"]))
    ds = Passes(pool, math.ceil(steps_needed * p["batch"] / len(pool)),
                run.seed)
    trainer = Trainer(cfg, train_data=ds, workdir=f"{run.tmp}/trainer",
                      device=run.device)
    trainer.model.load_state_dict(state)
    harness.set_tf32(bool(run.control))
    if run.fault == "stale_state":
        trainer.optimizer.step = lambda *a, **k: None
    elif run.fault == "half_batch":
        inner = trainer._raw_train_step

        def half(raw, crop, aug):
            h = raw["img"].shape[0] // 2
            return inner({k: v[:h] for k, v in raw.items()},
                         {k: v[:h] for k, v in crop.items()},
                         tuple(a[:h] for a in aug))
        trainer._raw_train_step = half

    def stage(raw):
        with run.span("stage"):
            return trainer._stage(raw, ds)

    loader = PrefetchLoader(ds, p["batch"], shuffle=False,
                            num_workers=p["num_workers"])
    st = SimpleNamespace(pool=pool, state=state, ds=ds, trainer=trainer,
                         cfg=cfg, step=0, staged=prefetch_to_device(
                             iter(loader), stage, p["device_prefetch"]))
    run.mark("program")
    names = dict(trainer.model.named_parameters())
    opt = trainer.optimizer
    st.losses, st.joints = [], []
    for k in range(p["checked_steps"] + p["warm_steps"]):
        m = _step(run, st, next(st.staged))[1]
        if k == 0:
            # the first gradient as Adam got it: m_1 = (1 - beta1) g
            b1 = opt.param_groups[0]["betas"][0]
            st.grad1 = {n: opt.state[q]["exp_avg"] / (1 - b1)
                        if q in opt.state else torch.zeros_like(q)
                        for n, q in names.items()}
        if k < p["checked_steps"]:
            st.losses.append(m["loss"])
            st.joints.append(m["jt_uvd_pred"])
        if k == p["checked_steps"] - 1:
            st.params = {n: q.detach().clone() for n, q in names.items()}
    return st


def _step(run, st, item):
    """One train step on a staged batch: (real frames, metrics)."""
    from awr_tpu_torch.data.device import draw_augment_params
    from awr_tpu_torch.training.trainer import augment_seed

    dev, x, n = item
    tr, cfg = st.trainer, st.cfg
    with run.span("step"):
        tr._gen.manual_seed(augment_seed(cfg.seed, EPOCH, st.step))
        aug = draw_augment_params(tr._gen, tr._padded(n), *cfg.augment_para)
        metrics = tr._raw_train_step(dev, x, aug)
    st.step += 1
    return n, metrics


def window(run, st):
    end = time.perf_counter_ns() + int(run.seconds * 1e9)
    t0 = time.perf_counter_ns()
    frames_done = steps_done = 0
    while True:
        with run.span("wait"):
            item = next(st.staged)
        n, _ = _step(run, st, item)
        frames_done += n
        steps_done += 1
        if time.perf_counter_ns() >= end:
            break
    run.sync()
    t1 = time.perf_counter_ns()
    return dict(t0=t0, t1=t1, attempted=steps_done, failed=0,
                e2e={"train_fps": frames_done / ((t1 - t0) / 1e9)},
                frames=frames_done, steps=steps_done)


def release(run, st):
    st.staged.close()
    st.losses = [float(v) for v in st.losses]
    st.joints = [v.double().cpu().numpy() for v in st.joints]
    st.grad1 = {k: v.double() for k, v in st.grad1.items()}
    del st.trainer, st.staged
    if run.cuda:
        torch.cuda.empty_cache()


def _leaf_gap(prog: dict, ref: dict, keep) -> float:
    """The worst leaf's gap between the program's norm and the
    reference's, over the larger of the leaf's and the median leaf's
    reference norm."""
    r = {k: float(ref[k].norm()) for k in keep}
    p = {k: float(prog[k].double().norm()) for k in keep}
    med = float(np.median(list(r.values())))
    return max(abs(p[k] - r[k]) / max(r[k], med) for k in keep)


def check(run, st):
    p, cfg = run.params, run.cfg
    harness.set_tf32(False)
    model = weights.reference_model(cfg, st.state, run.device)
    names = [n for n, _ in model.named_parameters()]
    opt = steps.Adam(model.parameters(), p["lr"])
    B, pool, losses, joints = p["batch"], st.pool, [], []
    for k in range(p["checked_steps"]):
        rows = st.ds.order[k * B:(k + 1) * B]
        gen = torch.Generator(run.device).manual_seed(
            data.augment_seed(run.seed, EPOCH, k))
        aug = data.draw_augment_params(gen, B, *p["augment_para"])
        img, jt_uvd = data.train_batch(
            torch.from_numpy(pool.frames[rows]).to(run.device),
            pool.joints[rows], pool.centers[rows], pool.cubes(B),
            pool.paras, pool.flip, aug, cfg["img_size"])
        loss, jt = steps.train_step(model, opt, img, jt_uvd, cfg)
        losses.append(float(loss))
        joints.append(jt.double().cpu().numpy())
        if k == 0:
            grad1 = {n: m.double() / (1 - opt.betas[0])
                     for n, m in zip(names, opt.m)}
    change = {n: q.detach().double() - st.state[n].double()
              for n, q in model.named_parameters()}
    prog_change = {n: st.params[n].double() - st.state[n].double()
                   for n in names}
    norms = {n: float(g.norm()) for n, g in grad1.items()}
    floor = 1e-3 * float(np.median(list(norms.values())))
    keep = [n for n in names if norms[n] >= floor]
    joints_gap = max(
        float(np.abs(a - b).max()) if a.shape == b.shape else math.inf
        for a, b in zip(st.joints, joints))
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(st.losses,
                                                             losses)),
        "joints_gap": joints_gap,
        "grad_gap": _leaf_gap(st.grad1, grad1, keep),
        "update_gap": _leaf_gap(prog_change, change, keep),
    }
