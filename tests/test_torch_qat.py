"""The port's quantization-aware fine-tune against the JAX package's
(``awr_tpu.training.qat``): one QAT train step's loss and gradients,
``finetune``'s losses, and ``Predictor.quantize_qat``'s validated
fallback, its joint-error gate and its atomicity.

The step and ``finetune`` are compared in float64, from the same weights,
batches and frozen activation scales, on an exact grid: every activation
scale and every int8 weight scale a power of two, so the fake-quantized
operands are small integers times powers of two and each QAT conv (float32
on both sides) sums them exactly, in any order.  In float32 the QAT train
step is chaotic at these sizes (measured: a 1e-7 relative change of the
BatchNorm weights moves the port's own first-step gradient by 0.7-1.7 of
its L2 norm, and the loss by 0.3-1.5 %, at B = 4-16 and img 32-64; the
float step moves by 1e-4 to 2e-2 and 1e-7): train-mode BatchNorm over a
few values a channel turns each one-code flip, which the two sides'
BatchNorm roundings cause, into a shift of the whole channel, and so into
more flips.  On the grid, float64 BatchNorms round alike to float32, the
codes agree, and no flip starts.

The JAX package's ``finetune`` runs once a family (one compile), in
float64 (its model dtype table pointed at float64), with coupled weight
decay, over two batches that its loop cycles, with the states its loop
produces recorded: its first step's gradients are read from Adam's first
moment (``mu = 0.1 (g + wd p)`` after one step), its first update and
BatchNorm statistics from the first state."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_weights import IMG, random_variables, resnet_variables
from torch_port_weights import one_thread  # noqa: F401

from awr_tpu.config import Config as JaxConfig
from awr_tpu.training import qat as jax_qat
from awr_tpu_torch.config import hourglass_config, resnet_config
from awr_tpu_torch.data.synthetic import SyntheticHandDataset
from awr_tpu_torch.models import build_model
from awr_tpu_torch.models.common import torch_default_init_
from awr_tpu_torch.models.quant import (calibrate, quant_layers, set_int8,
                                        set_quant_mode)
from awr_tpu_torch.models.weights import (_layout, _param_tensors,
                                          load_flax_variables)
from awr_tpu_torch.ops.decode import decode_offsets
from awr_tpu_torch.serving import Predictor
from awr_tpu_torch.training import qat
from awr_tpu_torch.training.optim import make_optimizer
from awr_tpu_torch.training.steps import make_train_step

J = 14
B = 4
LR = 1e-4
WD = 1e-3
STEPS = 3
NETS = ["hourglass_1", "resnet_18"]


def make_batches(n, seed):
    """Depth-like (B, IMG, IMG) batches (a foreground patch in [-1, 0.9]
    on background 1.0) with joints in [-0.8, 0.8]."""
    g = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        img = np.ones((B, IMG, IMG), np.float32)
        for b in range(B):
            u0, v0 = g.randint(2, IMG // 3, size=2)
            img[b, v0:v0 + IMG // 2, u0:u0 + IMG // 2] = g.uniform(
                -1.0, 0.9, (IMG // 2, IMG // 2))
        out.append({"img": img, "jt_uvd": g.uniform(
            -0.8, 0.8, (B, J, 3)).astype(np.float32)})
    return out


def port_config(net, **kw):
    """``net`` at IMG with its convergence recipe's coordinate weight (0.1
    for the hourglass, 0 for the ResNet)."""
    kw.setdefault("weight_decay", WD)
    if net.startswith("hourglass"):
        kw.setdefault("coord_weight", 0.1)
        return hourglass_config(img_size=IMG, **kw)
    kw.setdefault("coord_weight", 0.0)
    return resnet_config(img_size=IMG, **kw)


def port_model(net, variables):
    """The port's model of ``net`` holding ``variables``, in float64."""
    cfg = port_config(net)
    return load_flax_variables(
        build_model(cfg.net, cfg.jt_num, cfg.downsample).double(), variables)


def jax_quant_tree(model, scales):
    """The port's scales as the JAX package's ``quant`` collection."""
    tree = {}
    for _, key, path in _layout(model):
        if key in scales:
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node["act_scale"] = np.float32(scales[key])
    return tree


def pow2_weights(params):
    """Every conv and deconv kernel, float64, with each output channel
    scaled so its max |w| is 127 * 2**k: its int8 scale is 2**k."""
    def fix(path, a):
        a = np.asarray(a, np.float64)
        name = jax.tree_util.keystr(path)
        if not name.endswith("['kernel']"):
            return a
        axis = 2 if "deconv" in name else 3  # flax deconv: (kh, kw, out, in)
        amax = np.abs(a).max(axis=tuple(i for i in range(4) if i != axis),
                             keepdims=True)
        return a * (127.0 * 2.0 ** np.round(np.log2(amax / 127.0)) / amax)
    return jax.tree_util.tree_map_with_path(fix, params)


@pytest.fixture(scope="module", params=NETS)
def family(request):
    """Weights on the exact grid, two batches, power-of-two frozen scales,
    and the JAX package's ``finetune`` over them in float64: its per-step
    losses, first-step gradients, the port's model at its first step's
    variables, and its fine-tuned variables."""
    net = request.param
    if net.startswith("hourglass"):
        _, variables = random_variables(1, seed=3)
    else:
        _, variables = resnet_variables(18, 2, IMG, seed=7)
    variables = {"params": pow2_weights(variables["params"]),
                 "batch_stats": jax.tree_util.tree_map(
                     lambda a: np.asarray(a, np.float64),
                     variables["batch_stats"])}
    batches = make_batches(2, seed=11)  # cycled: 0, 1, 0
    model = port_model(net, variables)
    scales = {k: 2.0 ** torch.round(torch.log2(v)) for k, v in calibrate(
        model, [torch.from_numpy(b["img"]).double() for b in batches],
        percentile=99.99).items()}
    cfg = port_config(net)
    jcfg = JaxConfig(net=net, img_size=IMG, kernel_size=cfg.kernel_size,
                     coord_weight=cfg.coord_weight, weight_decay=WD,
                     use_pallas=False)
    states = []

    def recording_jit(fn):
        step = jax.jit(fn)

        def call(state, batch):
            out = step(state, batch)
            states.append(out[0])
            return out
        return call

    with jax.enable_x64(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_qat, "jax", types.SimpleNamespace(jit=recording_jit))
        mp.setattr(jax_qat, "DTYPES", {"float32": jnp.float64})
        params, stats, _, losses = jax_qat.finetune(
            jcfg, jax.tree_util.tree_map(jnp.asarray, variables["params"]),
            jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
            batches, steps=STEPS, lr=LR, quant=jax_quant_tree(model, scales))
        # the chain is decay, Adam, lr: Adam's state is the second to last
        mu = states[0].opt_state.inner_state[-2].mu
        grads = _param_tensors(model, jax.tree_util.tree_map(
            lambda m, p: np.asarray(m) / 0.1 - WD * np.asarray(p), mu,
            variables["params"]))
        first = load_flax_variables(
            port_model(net, variables), {"params": states[0].params,
                                         "batch_stats": states[0].batch_stats})
        tuned = load_flax_variables(port_model(net, variables),
                                    {"params": params, "batch_stats": stats})
    return dict(net=net, variables=variables, batches=batches, scales=scales,
                losses=losses, grads=grads, first=first, tuned=tuned)


def zero_grad_biases(model) -> set:
    """Conv biases whose exact gradient is 0: every conv but the heads
    feeds a train-mode BatchNorm, which subtracts a channel constant."""
    return {f"{n}.bias" for n, m in model.named_modules()
            if isinstance(m, torch.nn.Conv2d) and m.bias is not None
            and not n.startswith(("outs_", "final"))}


# One QAT step on the exact grid, float64.  The forward's codes agree, so
# what is left is the float32 loss and backward convs' summation order:
# measured loss 7.1e-7 (hourglass_1) and 7.5e-7 (resnet_18) relative, the
# worst gradient tensor 6.9e-6 and 9.5e-6 of its max |value|.  The update:
# Adam's first is lr (g + wd p) / (|g + wd p| + eps) an element, so an
# element whose decayed gradient lies within the two sides' gradient
# agreement of 0 may take any value in +-lr; measured 5.4e-4 and 8.8e-4
# of the update's norm in the worst tensor, 1e-8 to 3e-8 in the median
# one, where a doubled lr reads 1 and a step without the decay 0.8 to 1.
# The BatchNorm statistics: float64 on both sides, of the same exact conv
# outputs, measured 2e-14 of their change.
STEP_LOSS_RTOL = 1e-5
GRAD_RTOL_OF_MAX = 5e-5
UPDATE_RTOL = 1e-2
STATS_RTOL = 1e-10


def assert_first_step(model, family):
    """``model``'s change from the family's start by one step, against the
    JAX package's first step: each parameter's update relative to its
    norm, each BatchNorm statistic's change relative to its norm, and the
    batch counters one up."""
    start = port_model(family["net"], family["variables"]).state_dict()
    want = family["first"].state_dict()
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            assert int(v) == int(start[k]) + 1, k
            continue
        d_want, d_got = want[k] - start[k], v - start[k]
        scale = float(d_want.norm())
        assert scale > 0, k
        err = float((d_got - d_want).norm()) / scale
        assert err <= (STATS_RTOL if "running" in k else UPDATE_RTOL), (
            k, err)


def test_qat_train_step_matches_jax(family):
    net = family["net"]
    model = port_model(net, family["variables"])
    set_quant_mode(set_int8(model, family["scales"]), "qat")
    opt = make_optimizer(model.parameters(), "adam", LR, WD)
    batch = {k: torch.from_numpy(v) for k, v in family["batches"][0].items()}
    loss = float(make_train_step(model, opt, port_config(net))(batch)["loss"])
    np.testing.assert_allclose(loss, family["losses"][0],
                               rtol=STEP_LOSS_RTOL)
    skip = zero_grad_biases(model)
    for name, p in model.named_parameters():
        if name in skip:
            continue
        got, want = p.grad, family["grads"][name]
        scale = float(want.abs().max())
        assert scale > 0, name
        err = float((got - want).abs().max())
        assert err <= GRAD_RTOL_OF_MAX * scale, (name, err, scale)
    assert_first_step(model, family)


# finetune's losses against the JAX package's.  The first step is on the
# exact grid (STEP_LOSS_RTOL); its update moves the weight scales off
# powers of two, so later steps' QAT convs round, the two sides' codes
# start to differ, and the chaos the module docstring measures sets in:
# measured 1.0e-3 (hourglass_1) and 2.2e-3 (resnet_18) relative by step
# 3, where the parameters' updates already differ by 0.06 to 0.37 of
# their norm (median tensor), a wrong lr or batch order by about as
# much.  So the loop is held to the JAX package's in its first step
# (above) and in its losses, and bit for bit to the loop the JAX
# package's ``finetune`` runs, written out here: a fresh Adam with the
# config's coupled decay, the train step on a QAT copy, the batches
# cycled in order.
FINETUNE_LOSS_RTOL = 3e-2


def test_finetune_matches_jax(family):
    net = family["net"]
    cfg = port_config(net)
    model = port_model(net, family["variables"])
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tuned, scales, losses = qat.finetune(
        cfg, model, family["batches"], steps=STEPS, lr=LR,
        quant=family["scales"])
    assert all(isinstance(x, float) for x in losses)
    np.testing.assert_allclose(losses[0], family["losses"][0],
                               rtol=STEP_LOSS_RTOL)
    np.testing.assert_allclose(losses, family["losses"],
                               rtol=FINETUNE_LOSS_RTOL)
    assert losses[-1] < losses[0]
    # the caller's model is left alone; the copy serves int8 with the
    # frozen scales
    assert all(torch.equal(v, before[k])
               for k, v in model.state_dict().items())
    assert all(m.mode == "off" for m in quant_layers(model).values())
    assert not tuned.training
    for name, m in quant_layers(tuned).items():
        assert m.mode == "int8"
        assert float(m.act_scale) == float(family["scales"][name])
    assert scales is family["scales"]

    ref = set_quant_mode(set_int8(port_model(net, family["variables"]),
                                  family["scales"]), "qat")
    step = make_train_step(ref, torch.optim.Adam(
        ref.parameters(), lr=LR, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=WD), cfg)
    batches = family["batches"]
    want = [float(step({k: torch.from_numpy(v) for k, v in
                        batches[i % len(batches)].items()})["loss"])
            for i in range(STEPS)]
    assert losses == want
    got = tuned.state_dict()
    assert all(torch.equal(got[k], v) for k, v in ref.state_dict().items())


def test_finetune_calibrates_without_scales():
    cfg = resnet_config(img_size=IMG)
    model = torch_default_init_(build_model(cfg.net, J),
                                torch.Generator().manual_seed(0))
    batches = make_batches(2, seed=3)
    want = calibrate(model, [torch.from_numpy(b["img"]) for b in batches],
                     percentile=99.99)
    _, scales, losses = qat.finetune(cfg, model, batches, steps=1, lr=LR)
    assert scales.keys() == want.keys() and len(losses) == 1
    assert all(torch.equal(scales[k], want[k]) for k in want)
    with pytest.raises(ValueError, match="at least one batch"):
        qat.finetune(cfg, model, [], steps=1)


def test_gap_scaled_recipe_matches_jax():
    for gap in (0.129, 0.072, 0.481, -0.05, 5.0):
        assert qat.gap_scaled_recipe() == jax_qat.gap_scaled_recipe(gap)


def test_batches_from_dataset():
    ds = SyntheticHandDataset(12, J, IMG, seed=2)
    got = qat.batches_from_dataset(ds, batch_size=4, n_batches=2)
    assert len(got) == 2
    want = next(ds.batches(4))
    for k in ("img", "jt_uvd"):
        assert got[0][k].dtype == np.float32
        np.testing.assert_array_equal(got[0][k], want[k])
    assert len(qat.batches_from_dataset(ds, batch_size=5)) == 3
    with pytest.raises(ValueError, match="host-mode"):
        qat.batches_from_dataset(SyntheticHandDataset(4, J, IMG, mode="raw"))


# --- Predictor.quantize_qat

def predictor(net, seed=0):
    cfg = port_config(net)
    model = torch_default_init_(build_model(cfg.net, J, cfg.downsample),
                                torch.Generator().manual_seed(seed))
    return Predictor(cfg, model, device="cpu")


def snapshot(pred):
    return ({k: v.clone() for k, v in pred.model.state_dict().items()},
            {n: (m.mode, m.act_scale.clone())
             for n, m in quant_layers(pred.model).items()})


def assert_unchanged(pred, snap):
    sd, modes = snap
    got = pred.model.state_dict()
    assert got.keys() == sd.keys()
    assert all(torch.equal(got[k], v) for k, v in sd.items())
    assert {n: m.mode for n, m in quant_layers(pred.model).items()} == {
        n: mode for n, (mode, _) in modes.items()}
    assert all(torch.equal(quant_layers(pred.model)[n].act_scale, s)
               for n, (_, s) in modes.items())


@pytest.mark.parametrize("lr", [50.0, 1.0])
@pytest.mark.parametrize("net", NETS)
def test_ruinous_qat_falls_back_to_ptq_bit_equal(net, lr):
    """A deliberately ruinous lr wrecks the fine-tune; the holdout gate
    serves the PTQ weights and BatchNorm statistics, bit for bit.  After
    3 steps at lr 50 the fine-tuned joints are NaN (a gate that keeps the
    fine-tune unless it scores worse would keep it: NaN compares false),
    at lr 1 finite and far off.  The holdout's targets are the PTQ
    Predictor's own int8 joints, so PTQ scores a joint error of 0 and any
    fine-tune that moved them scores worse (random weights decode
    near-random joints, which a wrecked net can match by chance)."""
    tune = make_batches(1, seed=1)[0]
    pred = predictor(net)
    pred.quantize(tune["img"])
    img = make_batches(1, seed=2)[0]["img"]
    ptq_out = pred.predict_normalized(img)
    holdout = {"img": img, "jt_uvd": ptq_out}
    snap = snapshot(pred)
    pred.quantize_qat([tune], steps=3, lr=lr, holdout_batches=[holdout])
    v = pred.qat_validation
    assert v["fell_back"] is True and v["ptq_joint_err"] == 0.0
    assert np.isnan(v["qat_joint_err"]) == (lr == 50.0)
    assert not v["qat_joint_err"] <= v["ptq_joint_err"]
    assert_unchanged(pred, snap)
    np.testing.assert_array_equal(pred.predict_normalized(img), ptq_out)


@pytest.mark.parametrize("net", NETS)
def test_sane_qat_is_kept(net):
    """A fine-tune validated on its own tuning batch (the objective it
    optimized) is kept, and the Predictor serves it in int8."""
    tune = make_batches(1, seed=1)[0]
    pred = predictor(net)
    pred.quantize_qat([tune], steps=2, lr=1e-3, holdout_batches=[tune])
    assert pred.qat_validation["fell_back"] is False
    assert not pred.qat_validation["qat_joint_err"] > \
        pred.qat_validation["ptq_joint_err"]
    assert all(m.mode == "int8" for m in quant_layers(pred.model).values())


def test_gate_is_joint_error_not_loss(monkeypatch):
    """A fine-tune that halves the holdout loss while doubling the joint
    error falls back."""
    tune = make_batches(1, seed=7)[0]
    pred = predictor("resnet_18")
    pred.quantize(tune["img"])
    snap = snapshot(pred)
    monkeypatch.setattr(qat, "int8_holdout_metrics", lambda *a, **k: [
        dict(loss=1.0, joint_err=0.10), dict(loss=0.5, joint_err=0.20)])
    pred.quantize_qat([tune], steps=2, lr=1e-4, holdout_batches=[tune])
    assert pred.qat_validation["fell_back"] is True
    assert pred.qat_validation["qat_loss"] < pred.qat_validation["ptq_loss"]
    assert_unchanged(pred, snap)


@pytest.mark.parametrize("where", ["finetune", "holdout"])
def test_exception_leaves_the_predictor_serving(monkeypatch, where):
    """An exception in the second fine-tune step (after the first has
    moved the copy's weights and BatchNorm statistics) or in the holdout
    scoring leaves the model, its modes, ``quant`` and ``qat_validation``
    as they were."""
    tune = make_batches(1, seed=5)[0]
    pred = predictor("hourglass_1")
    pred.quantize(tune["img"])
    out = pred.predict_normalized(tune["img"])
    snap, model, quant = snapshot(pred), pred.model, pred.quant
    real = qat.make_train_step

    def failing(*a, **k):
        step = real(*a, **k)
        calls = []

        def train_step(batch):
            calls.append(1)
            if len(calls) == 2:
                raise RuntimeError("device fault")
            return step(batch)
        return train_step

    if where == "finetune":
        monkeypatch.setattr(qat, "make_train_step", failing)
    else:
        def fail(*a, **k):
            raise RuntimeError("malformed holdout batch")
        monkeypatch.setattr(qat, "int8_holdout_metrics", fail)
    with pytest.raises(RuntimeError):
        pred.quantize_qat([tune], steps=2, lr=1.0, holdout_batches=[tune])
    assert pred.model is model and pred.quant is quant
    assert pred.qat_validation is None
    assert_unchanged(pred, snap)
    np.testing.assert_array_equal(pred.predict_normalized(tune["img"]), out)


@pytest.mark.parametrize("net", NETS)
def test_qat_forward_matches_int8_forward(net):
    """Mode "qat" in eval computes the int8 forward's values (the JAX
    package's bars: 0.05 of max |map| on the map, 0.02 on the joints; a
    code flip between float and integer sums may cascade)."""
    pred = predictor(net)
    img = make_batches(1, seed=9)[0]["img"]
    pred.quantize(img)
    x = torch.from_numpy(img)
    with torch.no_grad():
        q8 = pred.model(x[:, None])
        set_quant_mode(pred.model, "qat")
        fq = pred.model(x[:, None])
    q8, fq = (m if m.dim() == 4 else m[-1] for m in (q8, fq))
    assert float((q8 - fq).abs().max()) < 0.05 * float(q8.abs().max())
    k = pred.cfg.kernel_size
    jt = float((decode_offsets(q8, x, k) - decode_offsets(fq, x, k))
               .abs().max())
    assert jt < 0.02


def test_holdout_metrics_score_each_candidate():
    """``joint_err`` is the mean L2 of the decoded joints in normalized
    uvd; the loss the eval step's, both weighted by batch size; the loss
    helper returns the losses."""
    cfg = port_config("resnet_18")
    model = torch_default_init_(build_model(cfg.net, J),
                                torch.Generator().manual_seed(4))
    batches = make_batches(2, seed=4)
    batches[1] = {k: v[:2] for k, v in batches[1].items()}
    scales = calibrate(model, [torch.from_numpy(batches[0]["img"])])
    (m,) = qat.int8_holdout_metrics(cfg, scales, batches, model)
    with torch.no_grad():
        preds = [decode_offsets(model(torch.from_numpy(b["img"])[:, None]),
                                torch.from_numpy(b["img"]), cfg.kernel_size)
                 for b in batches]
    errs = np.concatenate([np.linalg.norm(
        p.numpy().astype(np.float64) - b["jt_uvd"], axis=-1).mean(-1)
        for p, b in zip(preds, batches)])
    np.testing.assert_allclose(m["joint_err"], errs.mean(), rtol=1e-6)
    assert qat.int8_holdout_loss(cfg, scales, batches, model) == [m["loss"]]
