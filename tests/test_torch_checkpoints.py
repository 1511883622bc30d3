"""The port's checkpoints: the reference ``.pth`` layout, atomic writes,
``max_to_keep``, the serving loaders that read them, and a JAX
``TrainState`` carried into the port's model and Adam mid-training."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch_port_weights import IMG, random_variables
from torch_port_weights import one_thread  # noqa: F401

from awr_tpu.models import PoseNet as JaxPoseNet
from awr_tpu.training import optim as jax_optim
from awr_tpu.training.steps import TrainState
from awr_tpu.training.steps import make_train_step as jax_make_train_step
from awr_tpu_torch.config import hourglass_config
from awr_tpu_torch.models import build_model
from awr_tpu_torch.models.weights import load_flax_train_state
from awr_tpu_torch.serving import Predictor
from awr_tpu_torch.training.checkpoints import CheckpointManager
from awr_tpu_torch.training.optim import make_optimizer
from awr_tpu_torch.training.steps import make_train_step
from test_torch_train import (LR, f64_tree, jax_cfg, make_batches,
                              port_tree, tiered_diff)

J = 14


def trained(seed=0):
    """A tiny hourglass and its Adam after one step."""
    torch.manual_seed(seed)
    model = build_model("hourglass_1", J)
    opt = make_optimizer(model.parameters(), "adam", 1e-3)
    step = make_train_step(model, opt, hourglass_config(img_size=IMG))
    img, jt = make_batches(1, seed=seed, dtype=np.float32)[0]
    step(dict(img=torch.from_numpy(img), jt_uvd=torch.from_numpy(jt)))
    return model, opt


def state_of(model, opt, epoch):
    return dict(model=model.state_dict(), optimizer=opt.state_dict(),
                best_records={"epoch": epoch, "best_epoch": 1, "MPE": 12.5,
                              "AUC": 0.25},
                epoch=epoch, lr=3e-4, plateau=[3e-4, 11.0, 2.0])


def test_round_trip(tmp_path):
    model, opt = trained()
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(3, state_of(model, opt, 3))
    assert mgr.latest_epoch() == 3
    assert os.listdir(tmp_path / "ckpt") == ["3.pth"]
    got = mgr.restore()
    mgr.close()
    assert got.keys() == state_of(model, opt, 3).keys()
    for k, v in model.state_dict().items():
        assert torch.equal(got["model"][k], v), k
    fresh = build_model("hourglass_1", J)
    fresh.load_state_dict(got["model"])
    opt2 = make_optimizer(fresh.parameters(), "adam", 1e-3)
    opt2.load_state_dict(got["optimizer"])
    for p, q in zip(model.parameters(), fresh.parameters()):
        s, t = opt.state[p], opt2.state[q]
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(s[k], t[k]), k
    assert got["best_records"] == {"epoch": 3, "best_epoch": 1, "MPE": 12.5,
                                   "AUC": 0.25}
    assert (got["epoch"], got["lr"], got["plateau"]) == (3, 3e-4,
                                                         [3e-4, 11.0, 2.0])


def test_save_snapshots_the_state(tmp_path):
    """What is written is the state at save time, whatever a later step
    does to the live tensors before the background write."""
    model, opt = trained()
    want = {k: v.clone() for k, v in model.state_dict().items()}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state_of(model, opt, 1))
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    got = mgr.restore(1)["model"]
    mgr.close()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_max_to_keep(tmp_path):
    model, opt = trained()
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    for epoch in range(1, 5):
        mgr.save(epoch, state_of(model, opt, epoch))
    mgr.wait()
    assert sorted(os.listdir(tmp_path)) == ["3.pth", "4.pth"]
    assert mgr.epochs() == [3, 4]
    mgr.close()


def test_leftover_temporary_file_is_ignored(tmp_path):
    """A write cut short leaves a temporary file, never ``<epoch>.pth``."""
    model, opt = trained()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state_of(model, opt, 1), block=True)
    (tmp_path / "2.pth.tmp1234").write_bytes(b"half a file")
    assert mgr.latest_epoch() == 1
    assert mgr.restore()["epoch"] == 1
    mgr.close()


def test_reader_creates_nothing(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "absent"))
    assert mgr.latest_epoch() is None
    try:
        mgr.restore()
    except FileNotFoundError:
        pass
    else:
        raise AssertionError("restored from an empty directory")
    mgr.close()
    assert not (tmp_path / "absent").exists()


def test_predictor_reads_checkpoints(tmp_path):
    """The checkpoint's ``model`` is a reference-layout state dict:
    ``Predictor.from_torch`` loads the file, ``from_checkpoint`` the
    directory's newest epoch, and both give the saved model's joints
    (atol 0 on the CPU)."""
    model, opt = trained(seed=2)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state_of(build_model("hourglass_1", J), opt, 1))
    mgr.save(2, state_of(model, opt, 2))
    mgr.close()
    cfg = hourglass_config(img_size=IMG)
    img = make_batches(1, seed=5, dtype=np.float32)[0][0]
    want = Predictor(cfg, model, device="cpu").predict_normalized(img)
    for pred in (Predictor.from_checkpoint(cfg, str(tmp_path),
                                           device="cpu"),
                 Predictor.from_torch(cfg, str(tmp_path / "2.pth"),
                                      device="cpu")):
        np.testing.assert_array_equal(pred.predict_normalized(img), want)
    first = Predictor.from_checkpoint(cfg, str(tmp_path), epoch=1,
                                      device="cpu")
    assert not np.array_equal(first.predict_normalized(img), want)


def test_load_flax_train_state_continues_jax_adam():
    """From one JAX TrainState after 2 Adam steps (float64), one more
    step on each side: the loss within 1e-6 relative, the step's
    parameter update within the tiered bounds of the train-step test
    (max: Adam's lr-sized sign noise on gradients at the noise floor;
    median 1e-9).  Measured: max 7.9e-8, median 3.3e-10; a fresh Adam
    in place of the carried moments gives median 2.4e-4 (lr * sign(g)
    against lr * m / sqrt(v))."""
    _, variables = random_variables(1, seed=7)
    batches = [dict(img=img, jt_uvd=jt) for img, jt in make_batches(3)]
    with jax.enable_x64():
        jmodel = JaxPoseNet(nstack=1, joint_num=J, dtype=jnp.float64)
        adam = jax_optim.make_optimizer("adam")(learning_rate=LR)
        params = f64_tree(variables["params"])
        st = TrainState(params, f64_tree(variables["batch_stats"]),
                        adam.init(params), jnp.zeros((), jnp.int32))
        with jax.default_matmul_precision("highest"):
            step = jax.jit(jax_make_train_step(jmodel, adam, jax_cfg()))
            for b in batches[:2]:
                st, _ = step(st, jax.tree_util.tree_map(jnp.asarray, b))
            st3, m3 = step(st, jax.tree_util.tree_map(jnp.asarray,
                                                      batches[2]))

        model = build_model("hourglass_1", J).double()
        opt = make_optimizer(model.parameters(), "adam", 0.5)
        load_flax_train_state(model, opt, st)
        assert opt.param_groups[0]["lr"] == LR
        before = port_tree(model)
        m = make_train_step(model, opt, hourglass_config(
            img_size=IMG, coord_weight=1.0))(
                {k: torch.from_numpy(v) for k, v in batches[2].items()})
        after = port_tree(model)
        np.testing.assert_allclose(float(m["loss"]), float(m3["loss"]),
                                   rtol=1e-6)
        tm = jax.tree_util.tree_map
        d_max, d_med = tiered_diff(
            tm(lambda a, b: a - b, st3.params, st.params),
            tm(lambda a, b: a - b, after["params"], before["params"]))
        assert d_max <= 2.5 * LR and d_med <= 1e-9, (d_max, d_med)
