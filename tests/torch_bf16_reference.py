"""The JAX package's float32 and bfloat16 results for the port's bf16
parity tests (tests/test_torch_bf16.py), and the 2x rule they are held
to.

XLA on the CPU is allowed "excess precision" by default: it then drops
the bfloat16 roundings between fused operations of a jitted program (a
bf16 -> f32 -> bf16 convert pair is simplified away), so its jitted
"bf16" train step keeps some cotangents in float32 that PyTorch, and the
JAX package's own semantics, round.  Every JAX program here is compiled
with ``xla_allow_excess_precision`` off (:func:`rounding_jit`), so each
bf16 operation rounds, as it does op by op.

- :func:`forward`: each backbone's map and decoded joints;
- :func:`predict`: the hourglass Predictor's ``predict``;
- :func:`quantize`: the resnet_18 int8 Predictor's joints after
  ``quantize`` and its scales, and the ``int8_w`` resnet_18 map;
- :func:`train`: one train step of each family, at weights a few float32
  train steps have moved: loss and gradients.

Each in float32 and bfloat16.  The weights are the port's state dicts
that :func:`seeded_state` draws, carried into flax by the JAX package's
own importers (no flax init, which costs seconds of JAX compiles a
model).
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax.core import unfreeze

from awr_tpu.config import Config, hourglass_config, resnet_config
from awr_tpu.models import build_model as jax_build_model
from awr_tpu.models.torch_import import import_posenet, import_resnet_deconv
from awr_tpu.ops import offset2joint_softmax
from awr_tpu.serving import Predictor
from awr_tpu.training import optim
from awr_tpu.training.steps import TrainState, make_train_step
from awr_tpu_torch.models import build_model
from awr_tpu_torch.models.common import torch_default_init_

DTYPES = ("float32", "bfloat16")


@contextlib.contextmanager
def rounding_jit():
    """While open, every ``jax.jit`` (the JAX package's too, which call it
    at run time) compiles with XLA's excess precision off, on one thread
    and for one thread (the suite's workers share the machine's cores)."""
    jit = jax.jit

    def no_excess(fun=None, **kw):
        kw["compiler_options"] = {"xla_allow_excess_precision": False,
                                  "xla_cpu_parallel_codegen_split_count": 1,
                                  "xla_cpu_multi_thread_eigen": False,
                                  **(kw.get("compiler_options") or {})}
        if fun is None:
            return functools.partial(no_excess, **kw)
        return jit(fun, **kw)

    jax.jit = no_excess
    try:
        yield
    finally:
        jax.jit = jit


def rms(a, b) -> float:
    return float(np.sqrt(np.mean((np.asarray(a, np.float64)
                                  - np.asarray(b, np.float64)) ** 2)))


def assert_within_twice(port, want_bf16, want_f32, atol, what):
    """The 2x rule of the bf16 parity tests (tests/test_torch_bf16.py):
    RMS(port - want_bf16) <= 2 RMS(want_bf16 - want_f32), and
    ``max |port - want_bf16| <= atol``."""
    jax_dist, port_dist = rms(want_bf16, want_f32), rms(port, want_bf16)
    assert jax_dist > 0, what
    assert port_dist <= 2 * jax_dist, (what, port_dist, jax_dist)
    err = float(np.abs(np.asarray(port, np.float64) - want_bf16).max())
    assert err <= atol, (what, err, atol)


def seeded_state(net: str, seed: int, style: str) -> dict:
    """The port's state dict of ``net`` (numpy, without batch counters)
    from ``seed``.  ``style`` "serve": PyTorch's default init (the
    reference's) with every BatchNorm's affine parameters and running
    statistics randomized, so eval-mode BatchNorm is not the identity;
    "train": every parameter and running mean N(0, 0.05^2), every running
    var |N(0, 1)| + 0.5, the distribution tests/torch_port_weights.py's
    ``random_variables`` gives, whose gradients stand above the float
    noise floor."""
    model = build_model(net, 14)
    rng = np.random.RandomState(seed)
    if style == "serve":
        torch_default_init_(model, torch.Generator().manual_seed(seed))
    own = model.state_dict()
    sd = {}
    for k, v in own.items():
        if k.endswith("num_batches_tracked"):
            continue
        a, name = v.numpy(), k.rsplit(".", 1)[-1]
        bn = k.replace(name, "running_mean") in own
        if style == "train":
            a = (np.abs(rng.randn(*a.shape)) + 0.5 if name == "running_var"
                 else 0.05 * rng.randn(*a.shape))
        elif name == "running_var":
            a = rng.uniform(0.5, 1.5, a.shape)
        elif name == "running_mean" or (bn and name == "bias"):
            a = 0.1 * rng.randn(*a.shape)
        elif bn and name == "weight":
            a = 1 + 0.2 * rng.randn(*a.shape)
        sd[k] = np.asarray(a, np.float32)
    return sd


def flax_from_state(net: str, sd: dict) -> dict:
    """The JAX package's variables of the port's state dict ``sd``."""
    if net.startswith("hourglass"):
        return import_posenet(sd, nstack=int(net.split("_")[1]))
    return import_resnet_deconv(sd, downsample=2)


def flat(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _apply(model, v, x):
    """``model`` on (B, S, S) ``x`` in eval mode, jitted."""
    return jax.jit(lambda v, x: model.apply(v, x[..., None], train=False))(
        v, jnp.asarray(x))


@rounding_jit()
def forward(states: dict, img) -> dict:
    out = {}
    x = jnp.asarray(img)
    for net, sd in states.items():
        v = flax_from_state(net, sd)
        ks = 0.4 if net.startswith("hourglass") else 1.0
        for dt in DTYPES:
            o = _apply(jax_build_model(net, 14, 2, dtype=jnp.dtype(dt)), v, x)
            out[("map", net, dt)] = np.asarray(o)
            out[("joints", net, dt)] = np.asarray(offset2joint_softmax(
                o[-1] if o.ndim == 5 else o, x, ks))
    return out


@rounding_jit()
def predict(hourglass_state, frames, centers, img: int) -> dict:
    variables = flax_from_state("hourglass_1", hourglass_state)
    return {dt: Predictor(hourglass_config(img_size=img, use_pallas=False,
                                           compute_dtype=dt),
                          variables).predict(frames, centers)
            for dt in DTYPES}


@rounding_jit()
def quantize(resnet_state, crops) -> dict:
    out = {}
    img = crops.shape[-1]
    resnet = flax_from_state("resnet_18", resnet_state)
    for dt in DTYPES:
        pred = Predictor(resnet_config(img_size=img, use_pallas=False,
                                       compute_dtype=dt), resnet)
        pred.quantize(crops)
        out[("int8", dt)] = pred.predict_normalized(crops[:8])
        out[("int8_scales", dt)] = unfreeze(
            jax.tree_util.tree_map(np.asarray, pred.quant))
        out[("int8_w", dt)] = np.asarray(_apply(jax_build_model(
            "resnet_18", 14, 2, dtype=jnp.dtype(dt), quant_mode="int8_w"),
            resnet, crops[:2]))
    return out


# The pretraining's learning rate (Adam; the measured step's gradients do
# not depend on it)
PRETRAIN_LR = 1e-2


@rounding_jit()
def train(states: dict, img, jt_uvd, coord_weight: float,
          pretrain: dict) -> dict:
    """One train step of each net in float32 and bfloat16, at weights the
    JAX package's own float32 train step has moved first: ``pretrain``
    maps each net to (K, batches), K Adam steps at PRETRAIN_LR over the
    (img, jt_uvd) batches.  Returns those weights (``variables``) and the
    measured step's loss and gradients (a fresh Adam state: its first
    moment after one step is 0.1 * the gradient)."""
    out = {}
    batch = {"img": jnp.asarray(img), "jt_uvd": jnp.asarray(jt_uvd)}
    for net, sd in states.items():
        v = flax_from_state(net, sd)
        cfg = Config(net=net, img_size=img.shape[-1], use_pallas=False,
                     kernel_size=0.4 if net.startswith("hourglass") else 1.0,
                     coord_weight=coord_weight)
        adam = optim.make_optimizer("adam")(learning_rate=PRETRAIN_LR)
        steps = {dt: jax.jit(make_train_step(
            jax_build_model(net, 14, 2, dtype=jnp.dtype(dt)), adam, cfg))
            for dt in DTYPES}

        def fresh(params, stats):
            return TrainState(params, stats, adam.init(params),
                              jnp.zeros((), jnp.int32))

        st = fresh(v["params"], v["batch_stats"])
        n, batches = pretrain[net]
        for i in range(n):
            a, j = batches[i % len(batches)]
            st, _ = steps["float32"](st, {"img": jnp.asarray(a),
                                          "jt_uvd": jnp.asarray(j)})
        out[("variables", net)] = jax.tree_util.tree_map(
            np.asarray, {"params": st.params, "batch_stats": st.batch_stats})
        for dt in DTYPES:
            s, m = steps[dt](fresh(st.params, st.batch_stats), batch)
            out[("loss", net, dt)] = float(m["loss"])
            out[("grads", net, dt)] = {
                k: g / np.float32(0.1) for k, g in flat(
                    s.opt_state.inner_state[0].mu).items()}
    return out
