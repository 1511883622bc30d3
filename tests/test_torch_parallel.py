"""The port's data parallelism, model summary and profiling on the CPU.

Ranks run as processes of their own under gloo (``torch_ddp_worker``:
a ``file://`` rendezvous, one thread a rank, a 120 s limit), on their
rows of a global batch; the single-process port and the JAX package run
here, in the pytest process.  The ranks of one world size are started
once for the module and run every scenario in turn.

- ``GlobalBatchNorm2d`` at W = 2 in float64 against ``nn.BatchNorm2d``
  on the whole global batch, also under ``rematerialized``;
- the loss of a global batch of 5 rows padded to 8 over W = 4 (the last
  rank holds padding only) against the unpadded batch's;
- the train step at W = 2 (DDP, global BatchNorm, global loss
  normalization) against the port's single-process step on the global
  batch, K = 3 Adam steps in float64 at ``assert_train_parity``'s bars,
  and one float32 SGD step against the JAX Trainer at ``mesh_devices=2``
  at tests/test_training.py's bars for a mesh against one device;
- the mesh and multihost helpers, the model summary and profiling.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_ddp_worker as worker
from torch_port_weights import IMG, random_variables, resnet_variables
from torch_port_weights import one_thread  # noqa: F401

from awr_tpu.config import Config as JaxConfig
from awr_tpu.models import build_model as jax_build_model
from awr_tpu.models.torch_import import import_posenet
from awr_tpu.parallel.mesh import replicated as jax_replicated
from awr_tpu.training.trainer import Trainer as JaxTrainer
from awr_tpu_torch.config import Config
from awr_tpu_torch.models import build_model
from awr_tpu_torch.models.common import GlobalBatchNorm2d, global_batch_norm
from awr_tpu_torch.models.summary import summarize
from awr_tpu_torch.models.weights import load_flax_variables
from awr_tpu_torch.ops.loss import smooth_l1_loss
from awr_tpu_torch.parallel import multihost
from awr_tpu_torch.parallel.mesh import (Mesh, data_sharding, make_mesh,
                                         replicated, shard_batch)
from awr_tpu_torch.training.optim import make_optimizer
from awr_tpu_torch.training.steps import make_train_step
from awr_tpu_torch.utils import profiling
from test_torch_train import make_batches

J = 14
LR = 1e-3
STEPS = 3
STEP_CASES = {
    "step_hg": dict(net="hourglass_1", remat=False, accum=1, pad=False),
    "step_resnet_remat": dict(net="resnet_18", remat=True, accum=1,
                              pad=False),
    "step_accum2_pad": dict(net="hourglass_1", remat=False, accum=2,
                            pad=True),
}
PAD_W = np.array([1, 1, 1, 0], np.float32)


def port_weights(net, seed=3):
    """The port's model (float32) with seeded JAX-package weights."""
    if net == "hourglass_1":
        variables = random_variables(1, seed=seed)[1]
    else:
        variables = resnet_variables(18, 2, IMG, seed=seed)[1]
    return load_flax_variables(build_model(net, J), variables), variables


def step_config(case):
    net = case["net"]
    return dict(net=net, img_size=IMG, coord_weight=1.0,
                kernel_size=0.4 if net.startswith("hourglass") else 1.0,
                grad_accum=case["accum"], remat=case["remat"])


def save_batches(path, batches, w=None):
    arrays = {}
    for k, (img, jt) in enumerate(batches):
        arrays[f"img{k}"], arrays[f"jt_uvd{k}"] = img, jt
        if w is not None:
            arrays[f"w{k}"] = w
    np.savez(path, **arrays)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every W = 2 scenario in one start of the ranks, the W = 4 loss in
    another; the specs hold what the parent checks them against."""
    root = tmp_path_factory.mktemp("ddp")
    spec, local = {}, {}
    for name, case in STEP_CASES.items():
        model, _ = port_weights(case["net"])
        torch.save(model.state_dict(), root / f"{name}.pt")
        save_batches(root / f"{name}.npz", make_batches(STEPS),
                     PAD_W if case["pad"] else None)
        spec[name] = dict(net=case["net"], remat=case["remat"],
                          weights=str(root / f"{name}.pt"),
                          batches=str(root / f"{name}.npz"),
                          dtype="float64", optimizer="adam", lr=LR,
                          steps=STEPS, config=step_config(case))
    model, variables = port_weights("hourglass_1", seed=5)
    torch.save(model.state_dict(), root / "jax_sgd.pt")
    (img, jt), = make_batches(1, seed=9, dtype=np.float32)
    save_batches(root / "jax_sgd.npz", [(img, jt)], PAD_W)
    spec["jax_sgd"] = dict(net="hourglass_1", weights=str(root / "jax_sgd.pt"),
                           batches=str(root / "jax_sgd.npz"), dtype="float32",
                           optimizer="sgd", lr=LR, steps=1,
                           config=step_config(STEP_CASES["step_hg"]))
    local["jax_sgd"] = dict(variables=variables, img=img, jt=jt)
    names = ["bn", "bn_remat", "rows"] + list(STEP_CASES) + ["jax_sgd"]
    out = worker.run_ranks(names, 2, root / "w2", spec)
    out.update(worker.run_ranks(["loss"], 4, root / "w4"))
    return out, spec, local


# --------------------------------------------------------- global BatchNorm


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_global_batch_norm_matches_batch_norm_on_global_batch(ranks, remat):
    """W = 2, float64: the output, the running statistics, the batch
    counter (one update a step under ``rematerialized`` too), the input
    gradient and the summed parameter gradients of
    ``sum(BN(x) * g)`` equal ``nn.BatchNorm2d``'s on the whole batch to
    1e-12."""
    got = ranks[0]["bn_remat" if remat else "bn"]
    inp = worker.bn_inputs()
    module = worker.bn_module(False, conv_seed=1 if remat else None)
    want = worker.bn_run(module, inp["x"], inp["gy"], remat)
    assert [r["kind"] for r in got] == ["GlobalBatchNorm2d"] * 2
    assert want["kind"] == "BatchNorm2d"
    close = dict(rtol=0, atol=1e-12)
    torch.testing.assert_close(torch.cat([r["y"] for r in got]), want["y"],
                               **close)
    torch.testing.assert_close(torch.cat([r["x_grad"] for r in got]),
                               want["x_grad"], **close)
    for k, g in want["grads"].items():
        torch.testing.assert_close(got[0]["grads"][k] + got[1]["grads"][k],
                                   g, **close, msg=k)
    for r in got:
        for k in ("running_mean", "running_var"):
            torch.testing.assert_close(r[k], want[k], **close, msg=k)
        assert r["num_batches_tracked"] == want["num_batches_tracked"] == 1


def test_global_batch_norm_swap_keeps_tensors_and_eval_rule():
    """The swap keeps the parameters and buffers (the same tensors) and
    the state dict's keys; eval mode is ``BatchNorm2d``'s, with no
    collective (no process group here)."""
    model = build_model("hourglass_1", J)
    before = {k: v for k, v in model.state_dict(keep_vars=True).items()}
    n_bn = sum(type(m) is torch.nn.BatchNorm2d for m in model.modules())
    global_batch_norm(model)
    after = model.state_dict(keep_vars=True)
    assert list(after) == list(before)
    assert all(after[k] is before[k] for k in before)
    assert sum(isinstance(m, GlobalBatchNorm2d)
               for m in model.modules()) == n_bn > 0
    x = torch.randn(2, 1, IMG, IMG)
    plain = build_model("hourglass_1", J)
    plain.load_state_dict(model.state_dict())
    with torch.no_grad():
        torch.testing.assert_close(model.eval()(x), plain.eval()(x),
                                   rtol=0, atol=0)


# -------------------------------------------------------------- the loss


def test_padding_only_rank_adds_nothing(ranks):
    """5 rows padded to 8 over W = 4, ``w`` = [1,1 | 1,1 | 1,0 | 0,0]: the
    ranks' loss terms sum to the unpadded batch's loss and their
    gradients are its gradient (the padding rows' 0); the last rank,
    padding only, contributes exactly 0 (the port's counterpart of
    tests/test_training.py::test_padded_batch_loss_matches_unpadded)."""
    got = ranks[0]["loss"]
    assert torch.equal(torch.cat([r["rows"] for r in got]),
                       torch.arange(8))
    g = np.random.RandomState(1)
    x = torch.from_numpy(g.randn(8, 14, 3) * 0.02)
    y = torch.from_numpy(g.randn(8, 14, 3) * 0.02)
    x5 = x[:5].clone().requires_grad_(True)
    want = smooth_l1_loss(x5, y[:5])
    want.backward()
    np.testing.assert_allclose(sum(float(r["loss"]) for r in got),
                               float(want.detach()), rtol=1e-6)
    grad = torch.cat([r["grad"] for r in got])
    torch.testing.assert_close(grad[:5], x5.grad, rtol=1e-6, atol=0)
    assert not grad[5:].any()
    assert float(got[3]["loss"]) == 0.0


# ------------------------------------------------------------ train steps


def flat_diff(want: dict, got: dict):
    """(max, median) |diff| over every element of two dicts of tensors."""
    assert want.keys() == got.keys()
    d = torch.cat([(got[k].double() - want[k].double()).abs().ravel()
                   for k in want])
    return float(d.max()), float(d.median())


def single_process_steps(spec):
    """The port's one-device step on the global batches, float64."""
    model = build_model(spec["net"], J, remat=spec["remat"])
    model.load_state_dict(torch.load(spec["weights"], weights_only=True))
    model = model.double()
    opt = make_optimizer(model.parameters(), spec["optimizer"], spec["lr"])
    step = make_train_step(model, opt, Config(**spec["config"]))
    data = np.load(spec["batches"])
    losses, grads = [], None
    for k in range(spec["steps"]):
        batch = dict(img=torch.from_numpy(data[f"img{k}"]),
                     jt_uvd=torch.from_numpy(data[f"jt_uvd{k}"]))
        if f"w{k}" in data:
            batch["w"] = torch.from_numpy(data[f"w{k}"])
        losses.append(float(step(batch)["loss"]))
        if grads is None:
            grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return losses, grads, model.state_dict()


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_step_w2_matches_single_process(ranks, case):
    """K = 3 Adam steps at W = 2 against the single-process step on the
    global batch of 4, float64, at ``assert_train_parity``'s bars: the
    first loss rtol 1e-5, the rest 3e-2; first-step gradients max 1e-4,
    median 1e-9; parameters max 2.5 K lr, median 1e-3; BatchNorm running
    statistics max 3e-2, median 1e-3.  Both ranks hold equal weights and
    statistics after the steps, and each returned its own rows' joints.
    ``step_accum2_pad``: ``grad_accum`` 2 with ``w`` = [1, 1, 1, 0], so a
    rank's microbatch is its block of the global microbatch and rank 1's
    second microbatch is padding only.

    Measured (CPU; hourglass_1, resnet_18 remat, accum 2): losses within
    9e-8, 1.1e-7, 3.8e-7 relative (the loss's float32 cast); first-step
    gradients max 1.6e-12, 4.6e-15, 1.6e-10; parameters max 1.2e-9,
    3.7e-11, 1.1e-3 (Adam's lr-sized step where a gradient near 0 flips
    sign), median at most 3.5e-8; statistics max at most 1.8e-6."""
    results, spec = ranks[0][case], ranks[1][case]
    losses, grads, state = single_process_steps(spec)
    r0, r1 = results
    for k, v in r0["state"].items():
        assert torch.equal(v, r1["state"][k]), k
    assert r0["jt_shape"] == (2, J, 3)
    np.testing.assert_allclose(r0["losses"][:1], losses[:1], rtol=1e-5)
    np.testing.assert_allclose(r0["losses"], losses, rtol=3e-2)
    np.testing.assert_allclose(r1["losses"], r0["losses"], rtol=0)
    g_max, g_med = flat_diff(grads, r0["grads"])
    assert g_max <= 1e-4 and g_med <= 1e-9, (g_max, g_med)
    params = {k for k, _ in build_model(spec["net"], J).named_parameters()}
    stats = {k for k in state if not k.endswith("num_batches_tracked")
             and k not in params}
    p_max, p_med = flat_diff({k: state[k] for k in params},
                             {k: r0["state"][k] for k in params})
    assert p_max <= 2.5 * STEPS * LR and p_med <= 1e-3, (p_max, p_med)
    s_max, s_med = flat_diff({k: state[k] for k in stats},
                             {k: r0["state"][k] for k in stats})
    assert s_max <= 3e-2 and s_med <= 1e-3, (s_max, s_med)


def test_train_step_w2_matches_jax_mesh2(ranks, tmp_path):
    """One float32 SGD step at W = 2 against the JAX Trainer's step at
    ``mesh_devices=2`` from identical weights, on a batch of 4 with one
    padding row, at tests/test_training.py's bars for a mesh against one
    device: loss rtol 1e-3 (atol 1e-7), parameters rtol 1e-3, atol
    1e-5 (the loss measured 3.3e-6 relative on the CPU)."""
    got = ranks[0]["jax_sgd"][0]
    local = ranks[2]["jax_sgd"]
    cfg = JaxConfig(net="hourglass_1", img_size=IMG, kernel_size=0.4,
                    coord_weight=1.0, use_pallas=False, mesh_devices=2,
                    optimizer="sgd", lr=LR, batch_size=4, vis_freq=0)
    tr = JaxTrainer(cfg, workdir=str(tmp_path / "jax"))
    tr.state = jax.device_put(tr.state._replace(
        params=local["variables"]["params"],
        batch_stats=local["variables"]["batch_stats"],
        opt_state=tr.optimizer.init(local["variables"]["params"])),
        jax_replicated(tr.mesh))
    batch = dict(img=local["img"], jt_uvd=local["jt"], w=PAD_W)
    state, m = tr._train_step(tr.state, tr._put(batch))
    tr.close()
    np.testing.assert_allclose(got["losses"][0], float(m["loss"]),
                               rtol=1e-3, atol=1e-7)
    sd = {k: v for k, v in got["state"].items()
          if not k.endswith("num_batches_tracked")}
    port = import_posenet(sd, 1)["params"]
    want = jax.tree_util.tree_leaves_with_path(state.params)
    have = dict(jax.tree_util.tree_leaves_with_path(port))
    for path, leaf in want:
        np.testing.assert_allclose(np.asarray(have[path]), np.asarray(leaf),
                                   rtol=1e-3, atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))


# --------------------------------------------------- mesh and multihost


def test_mesh_repeats_devices_and_shards_contiguous_blocks():
    mesh = make_mesh(devices=["cpu"] * 4)
    assert mesh.size == 4 and mesh.axis_name == "data"
    assert mesh.devices == (torch.device("cpu"),) * 4
    x = torch.arange(0, 24, 3)
    blocks = shard_batch({"x": x}, mesh)["x"]
    assert [b.tolist() for b in blocks] == [[0, 3], [6, 9], [12, 15],
                                            [18, 21]]
    assert all(torch.equal(b, x) for b in replicated(mesh).put(x))
    assert data_sharding(mesh).slices(8)[1] == slice(2, 4)
    with pytest.raises(ValueError, match="does not split"):
        shard_batch({"x": torch.zeros(6)}, mesh)
    with pytest.raises(ValueError):
        Mesh(())


def test_make_mesh_without_gpu_asks_for_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="devices="):
        make_mesh()


def test_initialize_distributed_is_a_noop_for_one_process(monkeypatch):
    """One process (argument or environment): no process group, and a
    second call is as much a no-op."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    for _ in range(2):
        multihost.initialize_distributed(num_processes=1)
        multihost.initialize_distributed()
    assert not torch.distributed.is_initialized()
    assert multihost.world() == (0, 1)
    mesh = multihost.global_mesh(device="cpu")
    assert mesh.devices == (torch.device("cpu"),)
    batch = {"a": np.arange(6.0)}
    assert torch.equal(multihost.host_local_batch_to_global(batch, mesh)["a"],
                       torch.arange(6.0, dtype=torch.float64))


def test_rank_rows_are_shard_batch_blocks(ranks):
    """W = 2: the rows ``host_local_batch_to_global`` hands each rank are
    ``shard_batch``'s blocks on a 2-device mesh (and the initializer,
    called again under a group, is a no-op)."""
    got = ranks[0]["rows"]
    batch = {"a": np.arange(24, dtype=np.float32).reshape(8, 3),
             "b": np.arange(8)}
    want = shard_batch(batch, make_mesh(devices=["cpu"] * 2))
    for r, res in enumerate(got):
        for k in batch:
            assert torch.equal(res[k], want[k][r]), (r, k)


def test_rank_rows_follow_the_microbatch_layout():
    """With ``grad_accum`` a rank's microbatch i is its block of global
    microbatch i (the JAX step shards each microbatch over the mesh), and
    a microbatch that does not divide raises the JAX package's error."""
    rows = [multihost.rank_rows(8, 2, r, grad_accum=2) for r in range(2)]
    assert [r.tolist() for r in rows] == [[0, 1, 4, 5], [2, 3, 6, 7]]
    assert multihost.rank_rows(6, 3, 1).tolist() == [2, 3]
    with pytest.raises(ValueError, match="not divisible by the 4-device"):
        multihost.rank_rows(8, 4, 0, grad_accum=4)
    with pytest.raises(ValueError, match="grad_accum"):
        multihost.rank_rows(6, 1, 0, grad_accum=4)


# --------------------------------------------------- summary, profiling


@pytest.mark.parametrize("net,ratio", [("resnet_18", 1.0568),
                                       ("hourglass_1", 1.0061)])
def test_summary_matches_jax(net, ratio):
    """The parameter count equals the JAX package's; the forward FLOPs at
    img 128 lie within [1.0, 1.06] of XLA's cost model (of the lowered
    program, 0.05 % under the compiled one's count that the JAX
    ``summarize`` prints: 7.146e9 and 11.368e9), near the ratio measured
    against the compiled count (the models' docstring says why they
    differ)."""
    n_params, flops = summarize(net, 128)
    model = jax_build_model(net, J, 2)
    x = jax.ShapeDtypeStruct((1, 128, 128, 1), jnp.float32)
    variables = jax.eval_shape(
        lambda x: model.init(jax.random.PRNGKey(0), x, train=True), x)
    assert n_params == sum(p.size for p in
                           jax.tree_util.tree_leaves(variables["params"]))
    cost = jax.jit(lambda v, x: model.apply(v, x, train=False)).lower(
        variables, x).cost_analysis()
    got = flops / float(cost["flops"])
    assert 1.0 <= got <= 1.06, got
    assert abs(got - ratio) < 1e-3, got


def test_step_timer_summary_has_jax_keys():
    timer = profiling.StepTimer(window=3)
    assert timer.summary() == {}
    timer.start()
    for _ in range(5):
        timer.tick({"loss": torch.zeros(())})
    assert len(timer.times) == 3
    assert set(timer.summary()) == {"mean_s", "p50_s", "p95_s",
                                    "steps_per_s"}


def test_flops_of_counts_a_conv():
    conv = torch.nn.Conv2d(3, 8, 3, padding=1, bias=False)
    x = torch.zeros(2, 3, 16, 16, device="meta")
    assert profiling.flops_of(conv.to("meta"), x) == 2 * 2 * 16 * 16 * 8 * 27


def test_chip_peaks_and_implied_mfu():
    """One table: the H100 variants' dense bf16 rates are half the
    with-sparsity figures, as the int8 rates are; an implied MFU of 1 or
    more is refused."""
    sxm = profiling.chip_peaks("NVIDIA H100 80GB HBM3")
    assert (sxm.bf16_flops, sxm.int8_ops) == (989e12, 1979e12)
    assert profiling.chip_peak("NVIDIA H100 PCIe") == 756e12
    assert profiling.chip_peak("NVIDIA H100 NVL") == 835e12
    with pytest.raises(ValueError, match="no peak rates"):
        profiling.chip_peaks("a CPU")
    name = "NVIDIA H100 80GB HBM3"
    assert profiling.implied_mfu(1000.0, 1e10, name) == pytest.approx(
        1e13 / 989e12)
    with pytest.raises(ValueError, match=">= 1"):
        profiling.implied_mfu(98.9e3, 1e10, name)
