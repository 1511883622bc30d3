"""Ranks of a ``torch.distributed`` process group for the port's
data-parallel tests, run as processes of their own on the CPU (gloo).

The parent calls :func:`run_ranks`, which starts ``world`` processes of
this file and waits for them with a timeout: a hung collective fails
the test instead of stalling the suite.  Each rank joins the group
through a ``file://`` rendezvous in the test's directory (no TCP port
for concurrent test workers to race for), runs PyTorch on one thread,
runs each named scenario, and saves what it computed to
``<out>/<scenario>_<rank>.pt`` (or the scenario's error).  A rank
imports torch, numpy and the port only; the parent holds the JAX side.
"""

import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120.0


def run_ranks(scenarios, world, root, spec=None, timeout=TIMEOUT_S):
    """Run ``scenarios`` (names of functions below) on ``world`` ranks;
    returns ``{scenario: [rank 0's result, rank 1's, ...]}``.  ``spec``
    (JSON) is passed to every scenario.  Fails if a rank exits non-zero
    or outlives ``timeout`` seconds (all ranks are then killed)."""
    root = str(root)
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "spec.json"), "w") as fh:
        json.dump(spec or {}, fh)
    init = os.path.join(root, f"rendezvous_{time.monotonic_ns()}")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [REPO, os.path.dirname(os.path.abspath(__file__))]))
    logs = [open(os.path.join(root, f"rank{r}.log"), "w+")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), ",".join(scenarios),
         str(r), str(world), init, root], cwd=REPO, env=env,
        stdout=logs[r], stderr=subprocess.STDOUT) for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        hung = [r for r, p in enumerate(procs) if p.poll() is None]
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out = []
    for log in logs:
        log.seek(0)
        out.append(log.read()[-3000:])
        log.close()
    if hung:
        raise AssertionError(f"ranks {hung} outlived {timeout} s:\n" +
                             "\n".join(out))
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise AssertionError(f"ranks {bad} failed:\n" + "\n".join(out))
    results = {}
    for name in scenarios:
        results[name] = []
        for r in range(world):
            res = torch.load(os.path.join(root, f"{name}_{r}.pt"),
                             weights_only=False)
            if "error" in res:
                raise AssertionError(f"{name} failed on rank {r}:\n"
                                     f"{res['error']}")
            results[name].append(res)
    return results


# ------------------------------------------------------------- scenarios


def _rows(n, accum=1):
    from awr_tpu_torch.parallel.multihost import rank_rows, world
    rank, size = world()
    return torch.from_numpy(rank_rows(n, size, rank, accum))


def bn_inputs(seed=0, n=6, ch=3, hw=5):
    """The global float64 batch, a seeded output gradient and BatchNorm
    parameters and statistics (the parent builds the same)."""
    g = np.random.RandomState(seed)
    return dict(x=torch.from_numpy(g.randn(n, ch, hw, hw) * 2 + 0.5),
                gy=torch.from_numpy(g.randn(n, ch, hw, hw)),
                weight=torch.from_numpy(1 + 0.2 * g.randn(ch)),
                bias=torch.from_numpy(0.1 * g.randn(ch)),
                mean=torch.from_numpy(0.1 * g.randn(ch)),
                var=torch.from_numpy(g.uniform(0.5, 1.5, ch)))


def bn_module(global_bn: bool, ch=3, conv_seed=None):
    """BatchNorm (a conv before it with ``conv_seed``) in float64 with
    :func:`bn_inputs`' parameters and statistics."""
    from torch import nn

    from awr_tpu_torch.models.common import batch_norm, global_batch_norm
    inp = bn_inputs()
    bn = batch_norm(ch).double()
    with torch.no_grad():
        bn.weight.copy_(inp["weight"])
        bn.bias.copy_(inp["bias"])
        bn.running_mean.copy_(inp["mean"])
        bn.running_var.copy_(inp["var"])
    module = nn.Sequential(bn)
    if conv_seed is not None:
        conv = nn.Conv2d(ch, ch, 3, padding=1).double()
        g = torch.Generator().manual_seed(conv_seed)
        with torch.no_grad():
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=g,
                                          dtype=torch.float64) * 0.3)
            conv.bias.zero_()
        module = nn.Sequential(conv, bn)
    return global_batch_norm(module) if global_bn else module


def bn_run(module, x, gy, remat):
    """Train-mode forward and backward of ``sum(module(x) * gy)``."""
    from awr_tpu_torch.models.common import rematerialized
    x = x.clone().requires_grad_(True)
    module.train()
    y = rematerialized(module, x) if remat else module(x)
    (y * gy).sum().backward()
    bn = module[-1]
    grads = {k: p.grad.clone() for k, p in module.named_parameters()}
    return dict(y=y.detach(), x_grad=x.grad, grads=grads,
                running_mean=bn.running_mean.clone(),
                running_var=bn.running_var.clone(),
                num_batches_tracked=int(bn.num_batches_tracked),
                kind=type(bn).__name__)


def bn(spec):
    inp = bn_inputs()
    rows = _rows(len(inp["x"]))
    return bn_run(bn_module(True), inp["x"][rows], inp["gy"][rows], False)


def bn_remat(spec):
    inp = bn_inputs()
    rows = _rows(len(inp["x"]))
    return bn_run(bn_module(True, conv_seed=1), inp["x"][rows],
                  inp["gy"][rows], True)


def loss(spec):
    """A global batch of 5 rows padded to 8 over the ranks: this rank's
    loss term and gradient, divided by the global batch's valid rows."""
    from awr_tpu_torch.ops.loss import smooth_l1_loss
    from awr_tpu_torch.training.steps import _global_weight_sums
    g = np.random.RandomState(1)
    x = torch.from_numpy(g.randn(8, 14, 3) * 0.02)
    y = torch.from_numpy(g.randn(8, 14, 3) * 0.02)
    w = torch.tensor([1, 1, 1, 1, 1, 0, 0, 0], dtype=torch.float32)
    rows = _rows(8)
    xr = x[rows].clone().requires_grad_(True)
    w_r, (w_sum,) = _global_weight_sums(w[rows], xr, 1)
    val = smooth_l1_loss(xr, y[rows], w_r, w_sum)
    val.backward()
    return dict(loss=val.detach(), grad=xr.grad, rows=rows)


def rows(spec):
    """This rank's rows by ``host_local_batch_to_global``; the
    initializer a second time (a no-op)."""
    from awr_tpu_torch.parallel import multihost
    multihost.initialize_distributed(num_processes=2, process_id=0,
                                     coordinator_address="file:///absent")
    batch = {"a": np.arange(24, dtype=np.float32).reshape(8, 3),
             "b": np.arange(8)}
    return multihost.host_local_batch_to_global(
        batch, multihost.global_mesh(device="cpu"))


def _port_model(spec, dtype):
    from torch.nn.parallel import DistributedDataParallel

    from awr_tpu_torch.models import build_model
    from awr_tpu_torch.models.common import global_batch_norm
    model = build_model(spec["net"], 14, remat=spec.get("remat", False))
    model.load_state_dict(torch.load(spec["weights"], weights_only=True))
    model = global_batch_norm(model.to(dtype))
    return model, DistributedDataParallel(model, broadcast_buffers=False)


def train_steps(spec):
    """K train steps on this rank's rows of the parent's global batches:
    the losses, the first step's gradients and the final state."""
    from awr_tpu_torch.config import Config
    from awr_tpu_torch.training.optim import make_optimizer
    from awr_tpu_torch.training.steps import make_train_step
    dtype = getattr(torch, spec["dtype"])
    model, ddp = _port_model(spec, dtype)
    opt = make_optimizer(model.parameters(), spec["optimizer"], spec["lr"])
    cfg = Config(**spec["config"])
    step = make_train_step(ddp, opt, cfg)
    data = np.load(spec["batches"])
    accum = cfg.grad_accum
    losses, grads = [], None
    for k in range(spec["steps"]):
        batch = {key: torch.from_numpy(data[f"{key}{k}"]).to(
            dtype if key != "w" else torch.float32)
            for key in ("img", "jt_uvd", "w") if f"{key}{k}" in data}
        r = _rows(len(batch["img"]), accum)
        m = step({key: v[r] for key, v in batch.items()})
        losses.append(float(m["loss"]))
        if grads is None:
            grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return dict(losses=losses, grads=grads, state=model.state_dict(),
                jt_shape=tuple(m["jt_uvd_pred"].shape))


step_hg = step_resnet_remat = step_accum2_pad = jax_sgd = train_steps


def no_augmentation(generator, batch, *sigmas):
    """``draw_augment_params`` with every sample's op 3 (none), as
    tests/test_torch_trainer.py patches it."""
    dev = generator.device
    return (torch.full((batch,), 3, dtype=torch.int64, device=dev),
            torch.zeros((batch, 3), device=dev),
            torch.ones((batch,), device=dev),
            torch.zeros((batch,), device=dev))


def writes_seen(root):
    """Record every file this process opens for writing, and every
    directory it makes, under ``root`` (Python's audit events)."""
    seen = []

    def hook(event, args):
        if event == "open" and args[0] is not None and isinstance(
                args[0], (str, bytes, os.PathLike)):
            path, mode = os.fsdecode(args[0]), args[1] or "r"
            flags = args[2] if len(args) > 2 else 0
            writing = (any(c in str(mode) for c in "wax+")
                       or flags & (os.O_WRONLY | os.O_RDWR | os.O_CREAT))
            if writing and path.startswith(root):
                seen.append(path)
        elif event in ("os.mkdir", "os.rename", "os.remove") and \
                os.fsdecode(args[0]).startswith(root):
            seen.append(os.fsdecode(args[0]))

    sys.addaudithook(hook)
    return seen


def _trainer(spec, workdir, max_epoch, load=True, record=None):
    from awr_tpu_torch.config import hourglass_config
    from awr_tpu_torch.data.synthetic import SyntheticHandDataset
    from awr_tpu_torch.training.trainer import Trainer
    cfg = hourglass_config(**spec["config"], max_epoch=max_epoch)
    train = SyntheticHandDataset(spec["n_train"], 14, cfg.img_size,
                                 phase="train", seed=0, mode="raw")
    test = SyntheticHandDataset(spec["n_test"], 14, cfg.img_size,
                                phase="test", seed=1, mode="raw")
    tr = Trainer(cfg, train, test, workdir=workdir, device="cpu")
    if load:
        tr.model.load_state_dict(torch.load(spec["weights"],
                                            weights_only=True))
    if record is not None:
        losses, tests = record
        step, test_fn = tr._raw_train_step, tr.test

        def step_spy(*args):
            out = step(*args)
            losses.append(float(out["loss"]))
            return out

        def test_spy(epoch=0):
            tests.append(test_fn(epoch))
            return tests[-1]

        tr._raw_train_step, tr.test = step_spy, test_spy
    return tr


def trainer(spec):
    """Two un-augmented epochs straight (per-step losses, per-epoch test
    results, ``best_records``, the weights), then one epoch and a resume
    to the second in another directory, and the train and evaluate CLIs
    for one epoch; rank 1 records what it wrote."""
    from awr_tpu_torch.models.common import GlobalBatchNorm2d
    from awr_tpu_torch.parallel.multihost import world
    from awr_tpu_torch.training import evaluate as evaluate_cli
    from awr_tpu_torch.training import train as train_cli
    from awr_tpu_torch.data import device as port_device
    port_device.draw_augment_params = no_augmentation
    root = spec["root"]
    seen = writes_seen(root) if world()[0] != 0 else None
    losses, tests = [], []
    tr = _trainer(spec, os.path.join(root, "straight"), 2,
                  record=(losses, tests))
    tr.train()
    tr.close()
    straight = {k: v.clone() for k, v in tr.model.state_dict().items()}
    tr = _trainer(spec, os.path.join(root, "resumed"), 1)
    tr.train()
    tr.close()
    tr = _trainer(spec, os.path.join(root, "resumed"), 2, load=False)
    resumed_from = tr.best_records["epoch"]
    tr.train()
    tr.close()
    out = os.path.join(root, "cli")
    args = spec["cli"] + ["--output-dir", out, "--device", "cpu"]
    cli_tr = train_cli.main(args + ["--epochs", "1"])
    mpe = evaluate_cli.main(args + ["--load-model", os.path.join(
        cli_tr.work_dir, "ckpt", "1.pth")])
    return dict(losses=losses, tests=tests, best_records=tr.best_records,
                straight=straight, resumed=tr.model.state_dict(),
                resumed_from=resumed_from, cli_best=cli_tr.best_records,
                cli_work_dir=cli_tr.work_dir, eval_mpe=mpe,
                global_bn=sum(isinstance(m, GlobalBatchNorm2d)
                              for m in tr.model.modules()),
                writes=list(seen) if seen is not None else None)


def main(argv):
    import torch.distributed as dist

    from awr_tpu_torch.parallel.multihost import initialize_distributed
    names, rank, world_size, init, root = argv
    torch.set_num_threads(1)
    initialize_distributed("file://" + init, int(world_size), int(rank),
                           device="cpu")
    with open(os.path.join(root, "spec.json")) as fh:
        spec = json.load(fh)
    try:
        for name in names.split(","):
            try:
                res = globals()[name](spec.get(name, {}))
            except Exception:  # noqa: BLE001 - reported to the parent
                res = {"error": traceback.format_exc()}
            torch.save(res, os.path.join(root, f"{name}_{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
