"""The port's bfloat16 compute against the JAX package's, on the CPU:

- each backbone's forward (the map and the joints decoded from it);
- ``Predictor.predict`` (hourglass_1) and ``from_checkpoint``;
- ``Predictor.quantize`` (int8 resnet_18 under bf16) and weight-only int8
  (``int8_w``) in float32 and bf16;
- one train step of each family with ``remat`` off and on, remat's
  BatchNorm rule, and the bf16 Trainer and CLIs;
- the plain int8 deconv's bf16 output against the Pallas kernel in
  interpret mode (bit-equal).

**The 2x rule.**  XLA and PyTorch round bf16 convolutions and their
neighbours at other places, so the port is not held to a float32
tolerance.  Each check first measures the JAX package's own distance
between its bfloat16 and float32 results on the same inputs and weights,
and asserts that the port's bfloat16 result lies within twice that
distance of the JAX package's bfloat16 result.  The distance is the
root-mean-square difference over the tensor: a maximum is the one
element that sits nearest a bf16 rounding boundary, and between two
independent roundings it swings by a factor of 2 from seed to seed.
Each check also asserts an absolute bound on the maximum difference,
stated beside it.  The train step's gradients are held tensor by tensor
in their own scale, with the 2x rule over the whole model (the rules
stand above ``grad_faults``).  The JAX side compiles with XLA's excess
precision off (``tests/torch_bf16_reference.py`` says why).

One file: the suite's scheduler starts files with more tests first, and
the JAX compiles here are best started early.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_bf16_reference as ref
from torch_bf16_reference import assert_within_twice, flat, seeded_state

from awr_tpu.models.torch_import import import_posenet, import_resnet_deconv
from awr_tpu.ops.pallas_int8 import deconv4x4s2_int8 as jax_deconv
from awr_tpu_torch.config import Config, hourglass_config, resnet_config
from awr_tpu_torch.data.device import crop_normalize_batch
from awr_tpu_torch.data.synthetic import synthetic_frames
from awr_tpu_torch.geometry import xyz2uvd_np
from awr_tpu_torch.models import build_model
from awr_tpu_torch.models.quant import set_quant_mode
from awr_tpu_torch.models.weights import load_flax_quant, load_flax_variables
from awr_tpu_torch.ops import int8
from awr_tpu_torch.ops.decode import decode_offsets
from awr_tpu_torch.serving import Predictor
from awr_tpu_torch.training import evaluate, train
from awr_tpu_torch.training.checkpoints import CheckpointManager
from awr_tpu_torch.training.optim import make_optimizer
from awr_tpu_torch.training.steps import make_train_step
from test_torch_train import make_batches
from torch_port_weights import one_thread  # noqa: F401

IMG = 32  # F = 16: the depth-4 hourglass needs F % 16 == 0
FORWARD = {"hourglass_1": 1, "resnet_18": 3}  # net: weight seed


def port_model(net, sd, dtype="bfloat16", **kw):
    model = build_model(net, 14, compute_dtype=Config(
        compute_dtype=dtype).torch_compute_dtype, **kw)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                          strict=False)
    return model


def crops_of(frames, centers, cfg):
    crops, _ = crop_normalize_batch(
        torch.from_numpy(frames), xyz2uvd_np(centers, cfg.paras, cfg.flip),
        np.tile(cfg.cube, (len(frames), 1)), cfg.paras, IMG)
    return crops.numpy()


# --- the forward --------------------------------------------------------

@pytest.fixture(scope="module")
def forward_case():
    img = np.random.RandomState(2).uniform(-1, 1, (2, IMG, IMG)).astype(
        np.float32)
    img[:, :4] = 1.0  # background rows for the decode's mask
    states = {net: seeded_state(net, seed, "serve")
              for net, seed in FORWARD.items()}
    return states, img, ref.forward(states, img)


# Absolute bounds on max |port bf16 - JAX bf16|.  A bf16 value carries 8
# bits, a relative step of 2**-8 = 0.0039: maps of magnitude ~1 after a
# few dozen rounded layers differ by a few steps; joints are
# softmax(30 ht)-weighted means, where a map's rounding moves the weights
# by 30x its size (normalized uvd, whose cube spans 2).
MAP_ATOL = 0.05
JOINT_ATOL = 0.15


@pytest.mark.parametrize("net", sorted(FORWARD))
def test_forward_matches_jax_bf16(forward_case, net):
    """The map, float32 as it leaves the model, and the joints the port's
    decode takes from it; the parameters and statistics stay float32."""
    states, img, want = forward_case
    model = port_model(net, states[net]).eval()
    x = torch.from_numpy(img)
    with torch.no_grad():
        out = model(x[:, None])
        last = out[-1] if out.dim() == 5 else out
        joints = decode_offsets(last, x, 1.0 if net.startswith("resnet")
                                else 0.4)
    assert out.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(b.dtype in (torch.float32, torch.int64)
               for b in model.buffers())
    perm = (0, 2, 3, 1) if out.dim() == 4 else (0, 1, 3, 4, 2)
    assert_within_twice(out.numpy().transpose(perm),
                        want[("map", net, "bfloat16")],
                        want[("map", net, "float32")], MAP_ATOL,
                        f"{net} map")
    assert_within_twice(joints.numpy(), want[("joints", net, "bfloat16")],
                        want[("joints", net, "float32")], JOINT_ATOL,
                        f"{net} joints")


# --- serving ------------------------------------------------------------

@pytest.fixture(scope="module")
def predict_case():
    frames, _, centers = synthetic_frames(3, 14, seed=11)
    state = seeded_state("hourglass_1", 4, "serve")
    return (frames, centers, state,
            ref.predict(state, frames, centers, IMG))


# Camera (u px, v px, d mm) joints: the normalized joint bound (0.15)
# times the crop's half-width (64 px at img 32 from a 300 mm cube at
# 650-950 mm) and half depth (150 mm).
PREDICT_ATOL = JOINT_ATOL * 150


def test_predictor_predict_matches_jax_bf16(predict_case):
    frames, centers, state, want = predict_case
    cfg = hourglass_config(img_size=IMG, compute_dtype="bfloat16")
    pred = Predictor(cfg, port_model(cfg.net, state, "float32"),
                     device="cpu")
    assert pred.model.compute_dtype == torch.bfloat16  # from the config
    got = pred.predict(frames, centers)
    assert got.shape == (3, 14, 3) and np.isfinite(got).all()
    assert_within_twice(got, want["bfloat16"], want["float32"],
                        PREDICT_ATOL, "predict")


def test_from_checkpoint_loads_float32_weights_into_bf16(predict_case,
                                                         tmp_path):
    """A float32 checkpoint serves in bf16: the weights stay float32."""
    frames, centers, state, _ = predict_case
    cfg = hourglass_config(img_size=IMG)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"model": {k: torch.from_numpy(v) for k, v in state.items()}},
             block=True)
    mgr.close()
    bf16 = Predictor.from_checkpoint(cfg.replace(compute_dtype="bfloat16"),
                                     str(tmp_path), device="cpu")
    fp32 = Predictor.from_checkpoint(cfg, str(tmp_path), device="cpu")
    assert bf16.model.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in bf16.model.parameters())
    crops = crops_of(frames, centers, cfg)
    drift = np.abs(bf16.predict_normalized(crops)
                   - fp32.predict_normalized(crops)).max()
    assert 0 < drift < JOINT_ATOL


# --- int8 under bf16 ----------------------------------------------------

@pytest.fixture(scope="module")
def quant_case():
    """8 normalized synthetic crops (one calibration batch, one request
    bucket) and seeded resnet_18 weights."""
    frames, _, centers = synthetic_frames(8, 14, seed=5)
    crops = crops_of(frames, centers, resnet_config(img_size=IMG))
    state = seeded_state("resnet_18", 7, "serve")
    return crops, state, ref.quantize(state, crops)


# int8 joints under bf16, normalized uvd: the int8 bar of
# tests/test_torch_quant.py (1e-3, where a flipped activation code moves
# the joints by up to 3.9e-4) plus the bf16 layers' own rounding.
INT8_ATOL = 0.02


def test_predictor_quantize_matches_jax_bf16(quant_case):
    """Calibration and the int8 forward in bf16, with the port's own
    scales and with the JAX package's carried across."""
    crops, state, want = quant_case
    pred = Predictor(resnet_config(img_size=IMG, compute_dtype="bfloat16"),
                     port_model("resnet_18", state), device="cpu")
    fp = pred.predict_normalized(crops[:8])
    pred.quantize(crops)
    got = pred.predict_normalized(crops[:8])
    want_int8 = want[("int8", "bfloat16")], want[("int8", "float32")]
    assert 0 < np.abs(got - fp).max() < 0.05
    assert_within_twice(got, *want_int8, INT8_ATOL, "int8, own scales")
    pred.quant = load_flax_quant(pred.model,
                                 want[("int8_scales", "bfloat16")])
    pred._switch_int8()
    assert_within_twice(pred.predict_normalized(crops[:8]), *want_int8,
                        INT8_ATOL, "int8, JAX scales")


# int8_w float32: the float32 forward bar of tests/test_torch_models.py
# (the same weight codes through float convs); bf16: MAP_ATOL
INT8_W_ATOL = {"float32": 1e-4, "bfloat16": MAP_ATOL}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_w_matches_jax(quant_case, dtype):
    """Weight-only int8: the weight's codes times their scales through
    the float layers (the JAX package's ``quant_mode="int8_w"``)."""
    crops, state, want = quant_case
    model = port_model("resnet_18", state, dtype).eval()
    x = torch.from_numpy(crops[:2, None])
    with torch.no_grad():
        fp = model(x).numpy()
        got = set_quant_mode(model, "int8_w")(x).numpy()
    assert not np.array_equal(got, fp)  # the weights were rounded
    got = got.transpose(0, 2, 3, 1)
    if dtype == "float32":
        np.testing.assert_allclose(got, want[("int8_w", dtype)], rtol=0,
                                   atol=INT8_W_ATOL[dtype])
    else:
        assert_within_twice(got, want[("int8_w", dtype)],
                            want[("int8_w", "float32")], INT8_W_ATOL[dtype],
                            "int8_w")


# --- the train step -----------------------------------------------------

# One train step of each family (B = 4, img 32, coord weight 1 so the
# decode's gradient carries weight).  At freshly drawn weights a bf16
# gradient of these tiny nets is mostly rounding noise (the JAX package's
# own hourglass_1 bf16 gradients stood at cosine -0.43 to its float32
# ones: the train-mode BatchNorms at 1x1 and 2x2 amplify the rounding),
# and no rule can then tell a right gradient from a zeroed one.  So the
# weights are first moved by K float32 Adam steps (lr 1e-2) of the JAX
# package's own train step on seeded batches; its bf16 gradients then
# follow its float32 ones (cosine at least 0.908 for hourglass_1, 0.974
# for resnet_18, over the tensors held below).  net: (weight seed, K)
TRAIN = {"hourglass_1": (5, 25), "resnet_18": (6, 30)}
COORD_WEIGHT = 1.0
# The loss's absolute bound, a float32 mean of terms each a few bf16
# steps (2**-8 relative) off: within two steps relative (measured
# 5.6e-4 and 2.2e-5 relative).  A loss is one number, one draw of each
# rounding (its distance from the JAX package's bf16 loss stood at 1.99x
# the JAX package's own distance on hourglass_1), so the 2x rule holds it
# as one more tensor of the model's below.
LOSS_RTOL = 2.0 ** -7

# The gradient rules, each tensor in its own scale (s = RMS of the JAX
# package's float32 gradient; d = RMS of its bf16 - float32 distance);
# measured values for hourglass_1 and resnet_18 in brackets:
# - FOLLOWS: d within half the RMS of the JAX package's bf16 gradient,
#   so that the setup is one where a fault shows (at most 0.43, 0.27);
# - COARSE, the absolute bound, per tensor: RMS(port - JAX bf16) within
#   3/4 of the JAX bf16 gradient's RMS.  A zeroed gradient stands at 1,
#   a sign-flipped one at 2 (at most 0.38, 0.27);
# - the 2x rule, over the model: the root sum of squares over tensors of
#   RMS(port - JAX bf16) / s within twice that of d / s (0.87, 0.51).
#   Per tensor the two distances are heavy-tailed draws (nudging the
#   input below bf16's step moves a BatchNorm bias's bf16 distance by
#   several times), so their ratio is held over the model;
# - bf16 computed, over the model: the same sum of RMS(port bf16 - port
#   float32) / s at least OWN_MIN of that of d / s (0.93, 0.86; a port
#   that runs float32 stands at 0).  Not per tensor: the port's conv
#   backward sums a head bias's gradient in float32, so its bf16 and
#   float32 gradients there agree to 1e-3, where the JAX package sums in
#   bf16;
# - NOISE: a conv bias that reaches the loss only through a train-mode
#   BatchNorm (every hourglass conv bias but the two heads') has an exact
#   gradient of 0 (float32: below 1e-6 of the largest tensor's RMS,
#   measured 1.3e-8); its bf16 gradient is rounding noise, held by the 2x
#   rule with 0 for float32: RMS(port) within twice RMS(JAX bf16) (0.68).
FOLLOWS = 0.5
COARSE = 0.75
OWN_MIN = 0.1
NOISE_REL = 1e-6


def _rms(a) -> float:
    a = np.ravel(a).astype(np.float32, copy=False)
    return float(np.linalg.norm(a)) / np.sqrt(a.size)


def noise_only(j32) -> set:
    """The hourglass's conv biases but the heads': their float32
    gradient is 0 but for rounding."""
    top = max(_rms(g) for g in j32.values())
    noise = {k for k in j32 if k.endswith("['Conv_0']['bias']")
             and not k.startswith("['out_")}
    assert all(_rms(j32[k]) <= NOISE_REL * top for k in noise)
    return noise


def grad_faults(p16, p32, j16, j32) -> list:
    """The gradient rules above broken by the port's bf16 gradients
    ``p16`` (its float32 ones ``p32``) against the JAX package's ``j16``
    and ``j32``: one string each, empty if none."""
    noise = noise_only(j32)
    faults, agg = [], {"port": 0.0, "own": 0.0, "jax": 0.0}
    for k in j32:
        if k in noise:
            if _rms(p16[k]) > 2 * _rms(j16[k]):
                faults.append(f"noise {k}")
            continue
        s, d = _rms(j32[k]), _rms(j16[k] - j32[k])
        assert d <= FOLLOWS * _rms(j16[k]), (k, d, _rms(j16[k]))
        if _rms(p16[k] - j16[k]) > COARSE * _rms(j16[k]):
            faults.append(f"coarse {k}")
        agg["port"] += (_rms(p16[k] - j16[k]) / s) ** 2
        agg["own"] += (_rms(p16[k] - p32[k]) / s) ** 2
        agg["jax"] += (d / s) ** 2
    if agg["port"] > 4 * agg["jax"]:
        faults.append("2x rule")
    if agg["own"] < OWN_MIN ** 2 * agg["jax"]:
        faults.append("float32")
    return faults


@pytest.fixture(scope="module")
def train_case():
    img, jt = make_batches(1, seed=2, dtype=np.float32)[0]
    pre = make_batches(8, seed=9, dtype=np.float32)
    states = {net: seeded_state(net, seed, "train")
              for net, (seed, _) in TRAIN.items()}
    want = ref.train(states, img, jt, COORD_WEIGHT,
                     {net: (k, pre) for net, (_, k) in TRAIN.items()})
    moved = {}
    for net in TRAIN:
        model = load_flax_variables(build_model(net, 14),
                                    want[("variables", net)])
        moved[net] = {k: v.numpy() for k, v in model.state_dict().items()
                      if not k.endswith("num_batches_tracked")}
    return moved, dict(img=img, jt_uvd=jt), want


def port_step(net, sd, batch, remat=False, dtype="bfloat16"):
    model = port_model(net, sd, dtype, remat=remat)
    cfg = (resnet_config if net.startswith("resnet") else hourglass_config)(
        img_size=IMG, coord_weight=COORD_WEIGHT)
    m = make_train_step(model, make_optimizer(model.parameters(), "adam",
                                              1e-3), cfg)(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    return model, float(m["loss"])


def flax_grads(net, model):
    """The port's gradients in the JAX package's flax layout."""
    sd = {k: v for k, v in model.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    sd.update({k: p.grad for k, p in model.named_parameters()})
    sd = {k: v.numpy() for k, v in sd.items()}
    tree = (import_resnet_deconv(sd, downsample=2)
            if net.startswith("resnet") else import_posenet(sd, nstack=1))
    return flat(tree["params"])


@pytest.fixture(scope="module")
def port_steps(train_case):
    """The port's bf16 step of a (net, remat), each taken once."""
    moved, batch, _ = train_case
    done = {}

    def step(net, remat):
        if (net, remat) not in done:
            done[net, remat] = port_step(net, moved[net], batch, remat)
        return done[net, remat]
    return step


@pytest.fixture(scope="module")
def port_float32_grads(train_case):
    """The port's float32 gradients and loss (``loss``)."""
    moved, batch, _ = train_case
    out = {}
    for net in TRAIN:
        model, loss = port_step(net, moved[net], batch, dtype="float32")
        out[net] = dict(flax_grads(net, model), loss=np.float32([loss]))
    return out


@pytest.mark.parametrize("remat", [False, True], ids=["remat_off",
                                                      "remat_on"])
@pytest.mark.parametrize("net", sorted(TRAIN))
def test_train_step_matches_jax_bf16(train_case, port_steps,
                                     port_float32_grads, net, remat):
    """The loss and every parameter's gradient under the gradient rules
    above (the loss as one more tensor), the loss within LOSS_RTOL; a
    zeroed, a sign-flipped and a float32 gradient break the rules."""
    want = train_case[2]
    model, loss = port_steps(net, remat)
    assert all(p.dtype == p.grad.dtype == torch.float32
               for p in model.parameters())
    grads, p32 = flax_grads(net, model), port_float32_grads[net]
    j16, j32 = (dict(want[("grads", net, dt)],
                     loss=np.float32([want[("loss", net, dt)]]))
                for dt in ("bfloat16", "float32"))
    assert abs(loss - j16["loss"][0]) <= LOSS_RTOL * abs(j32["loss"][0])
    grads["loss"] = np.float32([loss])
    assert grads.keys() == j16.keys()
    assert grad_faults(grads, p32, j16, j32) == []
    # planted faults: every tensor but the noise-only ones breaks the
    # coarse bound when zeroed or sign-flipped; float32 breaks the model's
    held = {f"coarse {k}" for k in set(j32) - noise_only(j32)}
    zero = {k: 0 * g for k, g in grads.items()}
    flip = {k: -g for k, g in grads.items()}
    assert held <= set(grad_faults(zero, p32, j16, j32))
    assert held <= set(grad_faults(flip, p32, j16, j32))
    assert "float32" in grad_faults(p32, p32, j16, j32)


@pytest.mark.parametrize("net", sorted(TRAIN))
def test_remat_keeps_its_batch_norm_rule_under_bf16(port_steps, net):
    """With remat the bf16 step's loss, gradients and running statistics
    equal those without it, bit for bit on the CPU, and every batch
    counter is 1: the recompute does not update the statistics again."""
    (off, l_off), (on, l_on) = (port_steps(net, r) for r in (False, True))
    assert l_on == l_off
    for (k, a), b in zip(off.named_parameters(), on.parameters()):
        assert torch.equal(a.grad, b.grad), k
    for (k, a), b in zip(off.named_buffers(), on.buffers()):
        assert torch.equal(a, b), k
        if k.endswith("num_batches_tracked"):
            assert int(b) == 1, k


CLI = ["--net", "hourglass_1", "--synthetic", "--data-mode", "raw",
       "--img-size", "32", "--batch-size", "4", "--synthetic-size", "8",
       "--device", "cpu", "--compute-dtype", "bfloat16"]


def test_bf16_trainer_and_clis_keep_float32_state(tmp_path, capsys):
    """The train CLI in bf16 for one epoch, then the evaluate CLI on its
    checkpoint: the model computes in bf16; parameters, running
    statistics, Adam's moments and the checkpoint stay float32."""
    out = ["--output-dir", str(tmp_path)]
    tr = train.main(CLI + out + ["--epochs", "1"])
    assert tr.model.compute_dtype == torch.bfloat16
    assert np.isfinite(tr.best_records["MPE"])
    assert all(p.dtype == torch.float32 for p in tr.model.parameters())
    assert all(v.dtype == torch.float32
               for s in tr.optimizer.state.values() for v in s.values()
               if torch.is_tensor(v) and v.dim())
    ckpt = os.path.join(tr.work_dir, "ckpt", "1.pth")
    saved = torch.load(ckpt, map_location="cpu", weights_only=True)
    assert all(v.dtype in (torch.float32, torch.int64)
               for v in saved["model"].values())
    mpe = evaluate.main(CLI + out + ["--load-model", ckpt])
    assert np.isfinite(mpe) and "results: [MPE" in capsys.readouterr().out


# --- the int8 deconv's bf16 output --------------------------------------

@pytest.mark.parametrize("B,H,W,cin,cout", [
    (2, 4, 4, 8, 16), (3, 5, 7, 8, 8), (1, 2, 3, 512, 8)])
def test_plain_deconv_bf16_equals_pallas(B, H, W, cin, cout):
    """Both round the same float32 product to bf16 once: bit-equal."""
    rng = np.random.RandomState(B * 100 + H)
    xq = rng.randint(-127, 128, (B, H, W, cin)).astype(np.int8)
    wq = rng.randint(-127, 128, (4, 4, cout, cin)).astype(np.int8)
    scale = rng.uniform(0.5, 2.0, (cout,)).astype(np.float32)
    want = np.asarray(jax_deconv(jnp.asarray(xq), jnp.asarray(wq),
                                 jnp.asarray(scale), out_dtype=jnp.bfloat16,
                                 interpret=True).astype(jnp.float32))
    args = (torch.from_numpy(xq), torch.from_numpy(wq.transpose(3, 2, 0, 1)),
            torch.from_numpy(scale))
    got = int8.deconv4x4s2_int8(*args, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  want.transpose(0, 3, 1, 2))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        int8.deconv4x4s2_int8(*args, out_dtype=torch.float16)


def test_compute_dtype_names():
    assert Config(compute_dtype="bfloat16").torch_compute_dtype == \
        torch.bfloat16
    assert Config().torch_compute_dtype == torch.float32
    with pytest.raises(ValueError, match="float16"):
        Config(compute_dtype="float16")
