"""resnet_18's train step against the JAX package's, and ``remat``.

- K = 3 Adam steps of resnet_18 at img 64 (B = 4, coord weight 1) in
  float64 on both sides (the template of
  tests/test_train_dynamics_oracle.py), the port with ``remat`` off and
  on, held to that file's resnet_18 bounds (two of them wider; the test
  says why).
- ``remat`` and BatchNorm: the checkpoint's recompute reruns train-mode
  BatchNorm, which must not update the running statistics a second
  time.  After one step, the running statistics, the batch counters and
  the gradients equal those of the same step without ``remat``, for both
  families.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_weights import resnet_variables

from awr_tpu.models import build_model as jax_build_model
from awr_tpu.models.torch_import import import_resnet_deconv
from awr_tpu.training import optim as jax_optim
from awr_tpu.training.steps import TrainState
from awr_tpu.training.steps import make_train_step as jax_make_train_step
from awr_tpu_torch.config import hourglass_config, resnet_config
from awr_tpu_torch.models import build_model
from awr_tpu_torch.models.common import torch_default_init_
from awr_tpu_torch.models.weights import load_flax_variables
from awr_tpu_torch.training.optim import make_optimizer
from awr_tpu_torch.training.steps import make_train_step
from test_torch_train import f64_tree, make_batches

J = 14
IMG = 64
B = 4
LR = 1e-3
STEPS = 3


def flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def tiered(want, got):
    """(max, median) |diff| over all elements of two flax trees."""
    want, got = flat(want), flat(got)
    assert want.keys() == got.keys()
    d = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    return float(d.max()), float(np.median(d))


def port_tree(model, grads=False):
    sd = {k: v for k, v in model.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    if grads:
        sd.update({k: p.grad for k, p in model.named_parameters()})
    return f64_tree(import_resnet_deconv(sd, downsample=2))


def batches():
    """Depth-like frames at img 64 (a foreground patch in [-1, 0.9] on
    background 1.0) and joints in [-0.8, 0.8], as
    tests/test_torch_train.py makes them at img 32."""
    g = np.random.RandomState(11)
    out = []
    for _ in range(STEPS):
        img = np.ones((B, IMG, IMG))
        for b in range(B):
            u0, v0 = g.randint(4, IMG // 2, size=2)
            du, dv = g.randint(8, IMG - 8, size=2)
            patch = g.uniform(-1.0, 0.9, (min(dv, IMG - v0),
                                          min(du, IMG - u0)))
            img[b, v0:v0 + patch.shape[0], u0:u0 + patch.shape[1]] = patch
        out.append((img, g.uniform(-0.8, 0.8, (B, J, 3))))
    return out


@pytest.fixture(scope="module")
def jax_run():
    """The JAX package's K steps: first-step gradients (from Adam's
    first moment, mu = 0.1 g), the final state and the losses."""
    _, variables = resnet_variables(18, 2, IMG, seed=18)
    data = batches()
    with jax.enable_x64():
        model = jax_build_model("resnet_18", J, 2, dtype=jnp.float64)
        cfg = jax_cfg()
        adam = jax_optim.make_optimizer("adam")(learning_rate=LR)
        params = f64_tree(variables["params"])
        st = TrainState(params, f64_tree(variables["batch_stats"]),
                        adam.init(params), jnp.zeros((), jnp.int32))
        losses, grads = [], None
        with jax.default_matmul_precision("highest"):
            step = jax.jit(jax_make_train_step(model, adam, cfg))
            for img, jt in data:
                st, m = step(st, dict(img=jnp.asarray(img),
                                      jt_uvd=jnp.asarray(jt)))
                losses.append(float(m["loss"]))
                if grads is None:
                    grads = jax.tree_util.tree_map(
                        lambda a: a / 0.1, st.opt_state.inner_state[0].mu)
    return variables, data, losses, grads, st


def jax_cfg():
    from awr_tpu.config import Config

    return Config(net="resnet_18", img_size=IMG, downsample=2,
                  kernel_size=1.0, coord_weight=1.0, use_pallas=False)


@pytest.mark.parametrize("remat", [False, True], ids=["remat_off",
                                                      "remat_on"])
def test_resnet18_train_steps_fp64_match_jax(jax_run, remat):
    """The bounds of tests/test_train_dynamics_oracle.py's resnet_18 test
    where they discriminate: first-step loss rtol 1e-5 (measured 1.4e-6,
    the loss's float32 cast), first-step gradients max 1e-5 and median
    1e-9 (2.8e-8, 1.1e-10), parameters after K steps max 2.5 K lr and
    median 1e-5 (2.8e-3, 8.8e-7), running statistics median 2e-5
    (1.4e-5).  Two bounds are wider here, at img 64: later-step losses
    rtol 1e-3 (3.8e-4 at step 3) and running statistics max 1e-2
    (3.6e-3).  Both come from Adam's sign noise: the parameters that
    moved most apart are elements whose first-step gradient is 10 to
    1000 times below their tensor's median, where the float32 loss
    cast's roundoff decides the sign of an lr-sized update."""
    variables, data, losses, grads, st = jax_run
    with jax.enable_x64():
        model = load_flax_variables(build_model("resnet_18", J, 2,
                                                remat=remat),
                                    variables).double()
        opt = make_optimizer(model.parameters(), "adam", LR)
        step = make_train_step(model, opt, resnet_config(
            img_size=IMG, coord_weight=1.0))
        port_losses, port_grads = [], None
        for img, jt in data:
            m = step(dict(img=torch.from_numpy(img),
                          jt_uvd=torch.from_numpy(jt)))
            port_losses.append(float(m["loss"]))
            if port_grads is None:
                port_grads = port_tree(model, grads=True)["params"]
        np.testing.assert_allclose(port_losses[:1], losses[:1], rtol=1e-5)
        np.testing.assert_allclose(port_losses, losses, rtol=1e-3)
        g_max, g_med = tiered(grads, port_grads)
        assert g_max <= 1e-5 and g_med <= 1e-9, (g_max, g_med)
        final = port_tree(model)
        p_max, p_med = tiered(st.params, final["params"])
        assert p_max <= 2.5 * STEPS * LR and p_med <= 1e-5, (p_max, p_med)
        s_max, s_med = tiered(st.batch_stats, final["batch_stats"])
        assert s_max <= 1e-2 and s_med <= 2e-5, (s_max, s_med)


def one_step(net, remat):
    model = build_model(net, J, 2, remat=remat)
    torch_default_init_(model, torch.Generator().manual_seed(0))
    cfg = (resnet_config if net.startswith("resnet") else hourglass_config)(
        img_size=32, coord_weight=1.0)
    img, jt = make_batches(1, seed=2, dtype=np.float32)[0]  # img 32
    m = make_train_step(model, make_optimizer(model.parameters(), "adam",
                                              LR), cfg)(
        dict(img=torch.from_numpy(img), jt_uvd=torch.from_numpy(jt)))
    return (float(m["loss"]),
            {k: p.grad.clone() for k, p in model.named_parameters()},
            {k: b.clone() for k, b in model.named_buffers()},
            {k: p.detach().clone() for k, p in model.named_parameters()})


@pytest.mark.parametrize("net", ["hourglass_1", "resnet_18"])
def test_remat_leaves_batch_norm_statistics_and_gradients_alone(net):
    """One train step with and without remat, from the same weights: the
    same loss, gradients, updated weights, running statistics and
    ``num_batches_tracked`` (all 1), bit for bit on the CPU."""
    off, on = one_step(net, False), one_step(net, True)
    assert on[0] == off[0]
    for a, b in zip(off[1:], on[1:]):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
    counters = [v for k, v in on[2].items()
                if k.endswith("num_batches_tracked")]
    assert counters and all(int(c) == 1 for c in counters)


@pytest.mark.parametrize("net", ["hourglass_2", "resnet_18"])
def test_remat_wraps_the_blocks_jax_rematerializes(net, monkeypatch):
    """Each hourglass stack's encoder-decoder, or each ResNet block, runs
    under the checkpoint, as the JAX package wraps them in ``nn.remat``;
    outside training nothing is checkpointed."""
    from awr_tpu_torch.models import common

    wrapped = []
    real = common.checkpoint

    def spy(fn, *args, **kw):
        wrapped.append(type(fn).__name__)
        return real(fn, *args, **kw)

    monkeypatch.setattr(common, "checkpoint", spy)
    model = build_model(net, J, remat=True)
    x = torch.rand(2, 1, 32, 32)
    model.eval()
    with torch.no_grad():
        model(x)
    assert wrapped == []
    model.train()
    model(x).sum().backward()
    if net.startswith("hourglass"):
        assert wrapped == ["Sequential"] * 2
        assert all(type(hg[0]).__name__ == "HourglassBlock"
                   for hg in model.hgs)
    else:
        assert wrapped == ["BasicBlock"] * 8
