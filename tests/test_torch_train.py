"""The port's train and eval steps, loss and optimizer schedules against
the JAX package, from identical weights and identical seeded numpy
batches.

The train-step parity runs in float64 on both sides (``.double()`` here,
``jax.enable_x64`` there, as tests/test_train_dynamics_oracle.py does),
with ``coord_weight`` 1 so the decode's gradient carries weight, and
holds the port to that file's hourglass bounds.  They are ceilings: 50
train-mode BatchNorm layers renormalize per batch and Adam normalizes
each gradient, so float roundoff that starts at the loss's float32 cast
grows over the steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_weights import IMG, random_variables
from torch_port_weights import one_thread  # noqa: F401

from awr_tpu.config import Config as JaxConfig
from awr_tpu.data import device as jax_device
from awr_tpu.models import PoseNet as JaxPoseNet
from awr_tpu.models.torch_import import import_posenet
from awr_tpu.ops import smooth_l1_loss as jax_smooth_l1
from awr_tpu.training import optim as jax_optim
from awr_tpu.training.steps import TrainState
from awr_tpu.training.steps import make_eval_step as jax_make_eval_step
from awr_tpu.training.steps import make_raw_eval_step as jax_make_raw_eval
from awr_tpu.training.steps import make_raw_train_step as jax_make_raw_train
from awr_tpu.training.steps import make_train_step as jax_make_train_step
from awr_tpu_torch import kernels
from awr_tpu_torch.config import NYU_PARAS, hourglass_config
from awr_tpu_torch.data.device import crop_param_tensors
from awr_tpu_torch.data.transforms import crop_params_np
from awr_tpu_torch.geometry import uvd2xyz_np
from awr_tpu_torch.models import build_model
from awr_tpu_torch.models.weights import load_flax_variables
from awr_tpu_torch.ops.loss import smooth_l1_loss
from awr_tpu_torch.training import optim
from awr_tpu_torch.training.steps import (make_eval_step, make_raw_eval_step,
                                          make_raw_train_step,
                                          make_train_step)
from test_torch_ops import raw_batch

J = 14
B = 4
LR = 1e-3
STEPS = 3


def make_batches(n_steps, seed=7, dtype=np.float64):
    """Depth-like batches: a foreground patch in [-1, 0.9] on background
    1.0 (the 0.99 threshold sees both), joints in [-0.8, 0.8]."""
    g = np.random.RandomState(seed)
    batches = []
    for _ in range(n_steps):
        img = np.ones((B, IMG, IMG), dtype)
        for b in range(B):
            u0, v0 = g.randint(4, IMG // 2, size=2)
            du, dv = g.randint(8, IMG - 8, size=2)
            patch = g.uniform(-1.0, 0.9, (min(dv, IMG - v0), min(du, IMG - u0)))
            img[b, v0:v0 + patch.shape[0], u0:u0 + patch.shape[1]] = patch
        batches.append((img, g.uniform(-0.8, 0.8, (B, J, 3)).astype(dtype)))
    return batches


def f64_tree(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)


def flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def tiered_diff(want_tree, got_tree):
    """(max, median) |diff| over all elements of two flax trees."""
    want, got = flat(want_tree), flat(got_tree)
    assert want.keys() == got.keys()
    d = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    return float(d.max()), float(np.median(d))


def port_tree(model, grads=False):
    """The port's weights (or its parameters' ``.grad``) in the JAX
    package's flax layout, through the JAX package's importer."""
    sd = {k: v for k, v in model.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    if grads:
        sd.update({k: p.grad for k, p in model.named_parameters()})
    return f64_tree(import_posenet(sd, model.nstack))


def port_model(nstack, variables, dtype=torch.float64):
    model = load_flax_variables(build_model(f"hourglass_{nstack}", J),
                                variables)
    return model.to(dtype)


# ------------------------------------------------------------------ loss


@pytest.mark.parametrize("weights", ["none", "padding", "all_zero"])
def test_smooth_l1_loss_matches_jax(weights):
    """Both regimes of the piecewise loss (|z| straddles 0.01).  Float32
    sums of 168 values in another order: held to 1e-6 relative (measured
    2.5e-7 without weights, 0 with them)."""
    rng = np.random.RandomState(1)
    x = (rng.randn(B, J, 3) * 0.02).astype(np.float32)
    y = (rng.randn(B, J, 3) * 0.02).astype(np.float32)
    w = {"none": None, "padding": np.array([1, 0, 1, 1], np.float32),
         "all_zero": np.zeros(B, np.float32)}[weights]
    got = smooth_l1_loss(torch.from_numpy(x), torch.from_numpy(y),
                         None if w is None else torch.from_numpy(w))
    want = jax_smooth_l1(jnp.asarray(x), jnp.asarray(y),
                         None if w is None else jnp.asarray(w))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=0)
    if weights == "all_zero":
        assert float(got) == 0.0


def test_smooth_l1_loss_casts_to_float32_and_checks_shapes():
    x = torch.full((2, 3), 0.5, dtype=torch.float64)
    assert smooth_l1_loss(x, torch.zeros_like(x)).dtype == torch.float32
    with pytest.raises(ValueError, match="shapes"):
        smooth_l1_loss(x, torch.zeros(3, 2))


# ----------------------------------------------------------------- optim


def test_step_lr_matches_jax():
    for epoch in range(1, 71):
        assert (optim.step_lr(1e-3, epoch, 30)
                == jax_optim.step_lr(1e-3, epoch, 30)), epoch


def test_plateau_scheduler_matches_jax():
    metrics = [10.0, 9.0, 9.0, 9.0, 9.0, 8.9995, 8.0, 8.0, 8.0, 8.0, 8.0,
               8.0, 8.0, 8.0, 7.0] + [7.0] * 30
    ours, theirs = optim.PlateauScheduler(1e-3), jax_optim.PlateauScheduler(
        1e-3)
    got = [ours.step(m) for m in metrics]
    assert got == [theirs.step(m) for m in metrics]
    assert got[-1] == 1e-8  # the floor was reached


@pytest.mark.parametrize("name,cls", [("adam", torch.optim.Adam),
                                      ("sgd", torch.optim.SGD)])
def test_make_optimizer_and_learning_rate(name, cls):
    p = [torch.nn.Parameter(torch.zeros(3))]
    opt = optim.make_optimizer(p, name, 1e-3, weight_decay=1e-4)
    assert isinstance(opt, cls)
    assert opt.defaults["weight_decay"] == 1e-4
    assert optim.get_learning_rate(optim.set_learning_rate(opt, 5e-4)) == 5e-4
    with pytest.raises(ValueError, match="unknown optimizer"):
        optim.make_optimizer(p, "lion", 1e-3)


# ----------------------------------------------------- train step (fp64)


def jax_cfg(nstack=1, **kw):
    return JaxConfig(net=f"hourglass_{nstack}", img_size=IMG,
                     kernel_size=0.4, coord_weight=1.0, use_pallas=False,
                     **kw)


def jax_grads_and_run(model, variables, cfg, batches):
    """First-step gradients and the state after K Adam steps of the JAX
    package's step.  The gradients are read from Adam's first moment after
    the first step, mu = (1 - 0.9) g exactly up to one float64 rounding,
    so they are the ones the step itself applied, microbatch weighting
    included."""
    adam = jax_optim.make_optimizer("adam")(learning_rate=LR)
    params = variables["params"]
    st = TrainState(params, variables["batch_stats"], adam.init(params),
                    jnp.zeros((), jnp.int32))
    losses, grads = [], None
    with jax.default_matmul_precision("highest"):
        step = jax.jit(jax_make_train_step(model, adam, cfg))
        for batch in batches:
            st, m = step(st, batch)
            losses.append(float(m["loss"]))
            if grads is None:
                mu = st.opt_state.inner_state[0].mu
                grads = jax.tree_util.tree_map(lambda a: a / 0.1, mu)
    return grads, st, losses


def assert_train_parity(model, grads, st, losses, port_losses, port_grads):
    """The hourglass bounds of tests/test_train_dynamics_oracle.py."""
    np.testing.assert_allclose(port_losses[:1], losses[:1], rtol=1e-5)
    np.testing.assert_allclose(port_losses, losses, rtol=3e-2)
    g_max, g_med = tiered_diff(grads, port_grads)
    assert g_max <= 1e-4 and g_med <= 1e-9, (g_max, g_med)
    final = port_tree(model)
    p_max, p_med = tiered_diff(st.params, final["params"])
    assert p_max <= 2.5 * STEPS * LR and p_med <= 1e-3, (p_max, p_med)
    s_max, s_med = tiered_diff(st.batch_stats, final["batch_stats"])
    assert s_max <= 3e-2 and s_med <= 1e-3, (s_max, s_med)


@pytest.mark.parametrize("accum,pad", [(1, False), (2, True)],
                         ids=["accum1", "accum2_padding_row"])
def test_train_step_fp64_matches_jax(accum, pad):
    """K = 3 Adam steps of hourglass_1 at IMG 32, B = 4, coord_weight 1.

    Measured (CPU, float64), accum 1 / accum 2 with one w = 0 row:
    first-step loss equal to 9e-8 / 1e-7 relative, later steps within
    6e-7 / 8e-5; first-step gradients max 2.4e-8 / 4.4e-8, median
    2.5e-14 / 2.8e-14; parameters after 3 steps max 8.5e-4 / 1.6e-3,
    median 7.3e-8 / 4.2e-6; BN running stats max 4.8e-7 / 2.5e-4, median
    1.6e-8 / 1.3e-7.
    """
    _, variables = random_variables(1, seed=3)
    batches = make_batches(STEPS)
    # float32 weights, as the JAX package's trainer makes them
    w = np.array([1, 1, 1, 0], np.float32) if pad else None

    def batch(img, jt, lib):
        out = dict(img=lib(img), jt_uvd=lib(jt))
        if w is not None:
            out["w"] = lib(w)
        return out

    with jax.enable_x64():
        jmodel = JaxPoseNet(nstack=1, joint_num=J, dtype=jnp.float64)
        grads, st, losses = jax_grads_and_run(
            jmodel, f64_tree(variables), jax_cfg(grad_accum=accum),
            [batch(i, j, jnp.asarray) for i, j in batches])

        model = port_model(1, variables)
        opt = optim.make_optimizer(model.parameters(), "adam", LR)
        step = make_train_step(model, opt, hourglass_config(
            img_size=IMG, coord_weight=1.0, grad_accum=accum))
        port_losses, port_grads = [], None
        for img, jt in batches:
            m = step(batch(img, jt, torch.from_numpy))
            port_losses.append(float(m["loss"]))
            assert m["jt_uvd_pred"].shape == (B, J, 3)
            if port_grads is None:
                port_grads = port_tree(model, grads=True)["params"]
        assert_train_parity(model, grads, st, losses, port_losses,
                            port_grads)


def test_train_step_rejects_indivisible_batch():
    model = build_model("hourglass_1", J)
    step = make_train_step(model, optim.make_optimizer(
        model.parameters(), "adam", LR), hourglass_config(grad_accum=3))
    with pytest.raises(ValueError, match="grad_accum"):
        step(dict(img=torch.ones(4, IMG, IMG), jt_uvd=torch.zeros(4, J, 3)))


# ------------------------------------------------------ eval step (fp32)


@pytest.mark.parametrize("nstack", [1, 2])
def test_eval_step_matches_jax(nstack):
    """Losses and last-stack joints within 1e-4 (float32); the loss sums
    every stack (reference test.py:74-87)."""
    model, variables = random_variables(nstack, seed=5)
    img, jt = make_batches(1, seed=9, dtype=np.float32)[0]
    want = jax.jit(jax_make_eval_step(model, jax_cfg(nstack)))(
        variables["params"], variables["batch_stats"],
        dict(img=jnp.asarray(img), jt_uvd=jnp.asarray(jt)))
    pmodel = port_model(nstack, variables, torch.float32)
    cfg = hourglass_config(nstack, img_size=IMG, coord_weight=1.0)
    got = make_eval_step(pmodel, cfg)(
        dict(img=torch.from_numpy(img), jt_uvd=torch.from_numpy(jt)))
    for k in ("loss", "loss_offset", "loss_coord", "jt_uvd_pred"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    assert not pmodel.training

    # the sum over stacks, stack by stack
    from awr_tpu_torch.ops.decode import decode_offsets
    from awr_tpu_torch.ops.encode import encode_offsets
    with torch.no_grad():
        preds = pmodel(torch.from_numpy(img)[:, None])
        gt = encode_offsets(torch.from_numpy(jt), torch.from_numpy(img), 0.4,
                            IMG // 2)
        per_stack = [
            smooth_l1_loss(decode_offsets(p, torch.from_numpy(img), 0.4),
                           torch.from_numpy(jt)) + smooth_l1_loss(p, gt)
            for p in preds]
    assert len(per_stack) == nstack
    np.testing.assert_allclose(float(got["loss"]), float(sum(per_stack)),
                               rtol=1e-6)


# ------------------------------------------------------ raw steps (fp64)


def raw_inputs(lib, dtype=np.float32):
    frames, centers_uvd, cubes = raw_batch(B, seed=8)
    g = np.random.RandomState(8)
    centers_xyz = uvd2xyz_np(centers_uvd, NYU_PARAS, -1)
    jt_xyz = centers_xyz[:, None] + g.uniform(-60, 60, (B, J, 3))
    raw = dict(img=frames, jt_xyz=jt_xyz, centers_uvd=centers_uvd,
               cubes=cubes)
    raw = {k: lib(np.asarray(v, dtype)) for k, v in raw.items()}
    return raw, centers_uvd, cubes


RAW_AUG = (np.array([0, 1, 2, 3], np.int32),
           np.array([[6.0, -4.0, 9.0]] * B, np.float32),
           np.array([1.0, 1.12, 1.0, 1.0], np.float32),
           np.array([0.0, 0.0, 37.0, 0.0], np.float32))


def test_raw_train_step_fp64_matches_jax():
    """One raw-mode Adam step (device crop, one sample per augmentation
    op, normalize, encode, forward, decode, loss, update) of hourglass_1
    at IMG 32 from identical weights, at the bounds of the train-step
    test.  The JAX package's ``make_raw_train_step`` does not trace under
    ``jax.enable_x64`` (its rotation branch builds a float64 matrix that
    ``lax.switch`` refuses beside the float32 branches), so its two
    halves run as it composes them: ``train_preprocess_batch`` in
    float32, then ``make_train_step`` in float64 on that batch.

    Measured (CPU, float64): loss equal to 7e-7 relative; parameters max
    2.0e-3, median 2.1e-9; BN running stats max 1.4e-7, median 1.1e-8.
    Rotation is by 37 degrees: at multiples of 90 degrees the sample
    points sit on the pixel grid and the two frameworks' rounding moves
    them across it (test_torch_augment.py)."""
    _, variables = random_variables(1, seed=6)
    raw_j, centers_uvd, cubes = raw_inputs(np.asarray)
    pre = jax_device.train_preprocess_batch(
        raw_j["img"], raw_j["jt_xyz"], centers_uvd, cubes,
        np.asarray(NYU_PARAS, np.float32), tuple(map(jnp.asarray, RAW_AUG)),
        IMG, -1)
    with jax.enable_x64():
        jmodel = JaxPoseNet(nstack=1, joint_num=J, dtype=jnp.float64)
        adam = jax_optim.make_optimizer("adam")(learning_rate=LR)
        params = f64_tree(variables["params"])
        st = TrainState(params, f64_tree(variables["batch_stats"]),
                        adam.init(params), jnp.zeros((), jnp.int32))
        with jax.default_matmul_precision("highest"):
            st, want = jax.jit(jax_make_train_step(jmodel, adam, jax_cfg()))(
                st, dict(img=pre["img"], jt_uvd=pre["jt_uvd"]))

        model = port_model(1, variables)
        opt = optim.make_optimizer(model.parameters(), "adam", LR)
        raw_t, _, _ = raw_inputs(torch.from_numpy)
        got = make_raw_train_step(
            model, opt, hourglass_config(img_size=IMG, coord_weight=1.0),
            NYU_PARAS, -1)(
                raw_t, crop_param_tensors(centers_uvd, cubes, NYU_PARAS, IMG,
                                          "cpu"),
                tuple(map(torch.from_numpy, RAW_AUG)))
        for k in ("M", "cube", "center_xyz", "jt_xyz"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(pre[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                                   rtol=1e-5)
        final = port_tree(model)
        p_max, p_med = tiered_diff(st.params, final["params"])
        assert p_max <= 2.5 * LR and p_med <= 1e-3, (p_max, p_med)
        s_max, s_med = tiered_diff(st.batch_stats, final["batch_stats"])
        assert s_max <= 3e-2 and s_med <= 1e-3, (s_max, s_med)


def test_raw_eval_step_matches_jax():
    """The raw eval step (op 3 forced) in float32: the crop bit-identical,
    losses and joints within 1e-4."""
    model, variables = random_variables(1, seed=2)
    raw_j, centers_uvd, cubes = raw_inputs(jnp.asarray)
    p_np = crop_params_np(centers_uvd, cubes, NYU_PARAS, IMG)
    want = jax.jit(jax_make_raw_eval(model, jax_cfg(), NYU_PARAS, -1))(
        variables["params"], variables["batch_stats"], raw_j,
        {k: jnp.asarray(v) for k, v in p_np.items()})
    raw_t, _, _ = raw_inputs(torch.from_numpy)
    before = (kernels.LAUNCHES["encode"], kernels.LAUNCHES["decode"])
    got = make_raw_eval_step(
        port_model(1, variables, torch.float32),
        hourglass_config(img_size=IMG, coord_weight=1.0), NYU_PARAS, -1)(
            raw_t, crop_param_tensors(centers_uvd, cubes, NYU_PARAS, IMG,
                                      "cpu"))
    assert (kernels.LAUNCHES["encode"], kernels.LAUNCHES["decode"]) == before
    for k in ("img", "jt_uvd", "M"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    for k in ("loss", "loss_offset", "loss_coord", "jt_uvd_pred"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
