"""The port's Trainer and CLIs against the JAX package's, on the CPU.

Both Trainers get the same raw-mode ``SyntheticHandDataset`` items (the
port's are bit-equal to the JAX package's, tests/test_torch_data.py) and
the same initial weights (``load_flax_variables``): hourglass_1 at img
32, batch 4, float32, one JAX device.  For training, both packages'
``draw_augment_params`` are patched to draw op 3 (no augmentation) for
every sample: the two packages draw from different random streams, and
at zero parameters the other three ops are not the identity (the
translate and scale recrop, the warp resamples).
"""

import glob
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_nyu_files import write_fake_nyu
from torch_port_weights import IMG, random_variables
from torch_port_weights import one_thread  # noqa: F401

import awr_tpu.data.device as jax_device
from awr_tpu.config import Config as JaxConfig
from awr_tpu.data.nyu import NYUDataset as JaxNYU
from awr_tpu.data.synthetic import SyntheticHandDataset as JaxSynthetic
from awr_tpu.parallel.mesh import replicated
from awr_tpu.training.trainer import Trainer as JaxTrainer
from awr_tpu_torch.config import hourglass_config
from awr_tpu_torch.data import device as port_device
from awr_tpu_torch.data.nyu import NYUDataset
from awr_tpu_torch.data.synthetic import SyntheticHandDataset
from awr_tpu_torch.models.weights import load_flax_variables
from awr_tpu_torch.training import evaluate, train
from awr_tpu_torch.training.trainer import Trainer

B = 4
COMMON = dict(img_size=IMG, batch_size=B, vis_freq=0, print_freq=1000,
              num_workers=2, coord_weight=1.0)


def jax_trainer(tmp_path, variables, train_ds, test_ds, **kw):
    cfg = JaxConfig(net="hourglass_1", kernel_size=0.4, use_pallas=False,
                    mesh_devices=1, **COMMON, **kw)
    tr = JaxTrainer(cfg, train_ds, test_ds, workdir=str(tmp_path / "jax"))
    # placed as the Trainer places its state, so the steps compile once
    tr.state = jax.device_put(tr.state._replace(
        params=variables["params"], batch_stats=variables["batch_stats"]),
        replicated(tr.mesh))
    return tr


def port_trainer(path, variables, train_ds, test_ds, **kw):
    cfg = hourglass_config(**COMMON, **kw)
    tr = Trainer(cfg, train_ds, test_ds, workdir=str(path), device="cpu")
    load_flax_variables(tr.model, variables)
    return tr


def datasets(pkg_cls, n_train=8, n_test=4):
    train = (pkg_cls(n_train, 14, IMG, phase="train", seed=0, mode="raw")
             if n_train else None)
    return train, pkg_cls(n_test, 14, IMG, phase="test", seed=1, mode="raw")


def dump(workdir):
    (path,) = glob.glob(os.path.join(workdir, "test_*.txt"))
    return np.loadtxt(path)


def result_names(workdir):
    """The files a Trainer wrote beside its checkpoints, with the MPE in
    the prediction dump's name replaced by a placeholder."""
    return sorted(re.sub(r"^test_\d+\.\d{3}\.txt$", "test_MPE.txt", f)
                  for f in os.listdir(workdir) if f != "ckpt")


def test_eval_with_identical_weights_matches_jax(tmp_path):
    """test(0): MPE and AUC within rtol 1e-4; the reference-format dumps
    (3 decimals) within 1e-3 px/mm, one unit of their last digit (plus
    the decimal parse's own rounding)."""
    _, variables = random_variables(1, seed=4)
    jtr = jax_trainer(tmp_path, variables, *datasets(JaxSynthetic, 0))
    ptr = port_trainer(tmp_path / "port", variables,
                       *datasets(SyntheticHandDataset, 0))
    want, got = jtr.test(0), ptr.test(0)
    jtr.close()
    ptr.close()
    np.testing.assert_allclose(got, want, rtol=1e-4)
    np.testing.assert_allclose(dump(ptr.work_dir), dump(jtr.work_dir),
                               rtol=0, atol=1e-3 + 1e-9)
    assert result_names(ptr.work_dir) == result_names(jtr.work_dir)
    assert os.path.basename(ptr.log_file) == os.path.basename(
        jtr.log_file) == "hourglass_1_dense.log"


def no_augmentation(monkeypatch):
    def jax_draw(key, batch, *sigmas):
        return (jnp.full((batch,), 3, jnp.int32), jnp.zeros((batch, 3)),
                jnp.ones((batch,)), jnp.zeros((batch,)))

    def port_draw(generator, batch, *sigmas):
        dev = generator.device
        return (torch.full((batch,), 3, dtype=torch.int64, device=dev),
                torch.zeros((batch, 3), device=dev),
                torch.ones((batch,), device=dev),
                torch.zeros((batch,), device=dev))

    monkeypatch.setattr(jax_device, "draw_augment_params", jax_draw)
    monkeypatch.setattr(port_device, "draw_augment_params", port_draw)


def record(tr, losses, tests, jax_side):
    """Spy on a Trainer's raw train step (each step's loss) and test
    (each epoch's MPE and AUC)."""
    step, test = tr._raw_train_step, tr.test

    def step_spy(*args):
        out = step(*args)
        losses.append(float((out[1] if jax_side else out)["loss"]))
        return out

    def test_spy(epoch=0):
        tests.append(test(epoch))
        return tests[-1]

    tr._raw_train_step, tr.test = step_spy, test_spy


def test_two_epochs_match_jax(tmp_path, monkeypatch):
    """2 epochs of 2 Adam steps, un-augmented, from identical weights:
    per-step losses at tests/test_torch_train.py's bounds (first step
    rtol 1e-5, later steps 3e-2), per-epoch test MPE within 3e-2, the
    epoch cursor and best epoch exactly.

    Adam at lr 1e-4: both Trainers run float32, and Adam normalizes each
    gradient, so at 1e-3 float32 roundoff alone moves the fourth step's
    loss by 1.8 % (the port against itself in float64, measured on the
    CPU; the JAX package is 4.4 % from the port there).  At 1e-4 that
    is 0.08 %, while the loss still falls 7 % over the four steps."""
    no_augmentation(monkeypatch)
    _, variables = random_variables(1, seed=3)
    kw = dict(max_epoch=2, lr=1e-4)
    runs = {}
    for side in ("jax", "port"):
        losses, tests = [], []
        if side == "jax":
            tr = jax_trainer(tmp_path, variables, *datasets(JaxSynthetic),
                             **kw)
        else:
            tr = port_trainer(tmp_path / "port", variables,
                              *datasets(SyntheticHandDataset), **kw)
        record(tr, losses, tests, side == "jax")
        tr.train()
        tr.close()
        runs[side] = losses, tests, tr.best_records
    (jl, jt, jb), (pl, pt, pb) = runs["jax"], runs["port"]
    assert len(pl) == len(jl) == 4
    np.testing.assert_allclose(pl[:1], jl[:1], rtol=1e-5)
    np.testing.assert_allclose(pl, jl, rtol=3e-2)
    np.testing.assert_allclose([m for m, _ in pt], [m for m, _ in jt],
                               rtol=3e-2)
    assert (pb["epoch"], pb["best_epoch"]) == (jb["epoch"], jb["best_epoch"])
    np.testing.assert_allclose(pb["MPE"], jb["MPE"], rtol=3e-2)
    assert sorted(os.listdir(os.path.join(tmp_path / "port", "ckpt"))) == [
        "1.pth", "2.pth"]


@pytest.fixture(scope="module")
def nyu_root(tmp_path_factory):
    """A 4-frame NYU-layout directory (tests/test_nyu_files.py's writer:
    cv2 PNGs, a scipy joint_data.mat, refined centers)."""
    return write_fake_nyu(str(tmp_path_factory.mktemp("nyu")))


def test_host_mode_two_epochs_match_jax(tmp_path, nyu_root):
    """Host mode, the JAX CLI's default, on an NYU-layout directory: 2
    epochs of one augmented Adam step from identical weights, at
    test_two_epochs_match_jax's bars (first step rtol 1e-5, later steps
    and per-epoch test MPE 3e-2).  Both Trainers load host-mode training
    on one worker, so both datasets draw their augmentation from
    RandomState(23455) in the same order, and the port's host chain
    gives the JAX package's items (tests/test_torch_datasets.py)."""
    _, variables = random_variables(1, seed=3)
    kw = dict(max_epoch=2, lr=1e-4)
    runs = {}
    for side, cls in (("jax", JaxNYU), ("port", NYUDataset)):
        train_ds = cls(nyu_root, "train", img_size=IMG)
        test_ds = cls(nyu_root, "test", img_size=IMG)
        if side == "jax":
            tr = jax_trainer(tmp_path, variables, train_ds, test_ds, **kw)
        else:
            tr = port_trainer(tmp_path / "port", variables, train_ds,
                              test_ds, **kw)
        losses, tests = [], []
        step, test = tr._train_step, tr.test

        def step_spy(*args, _step=step, _jax=side == "jax"):
            out = _step(*args)
            losses.append(float((out[1] if _jax else out)["loss"]))
            return out

        def test_spy(epoch=0, _test=test):
            tests.append(_test(epoch))
            return tests[-1]

        tr._train_step, tr.test = step_spy, test_spy
        tr.train()
        tr.close()
        runs[side] = losses, tests, tr.best_records
    (jl, jt, jb), (pl, pt, pb) = runs["jax"], runs["port"]
    assert len(pl) == len(jl) == 2
    np.testing.assert_allclose(pl[:1], jl[:1], rtol=1e-5)
    np.testing.assert_allclose(pl, jl, rtol=3e-2)
    np.testing.assert_allclose([m for m, _ in pt], [m for m, _ in jt],
                               rtol=3e-2)
    assert (pb["epoch"], pb["best_epoch"]) == (jb["epoch"], jb["best_epoch"])


def params(tr):
    return {k: v.detach().clone() for k, v in tr.model.state_dict().items()}


def test_resume_equals_straight_run(tmp_path):
    """Training 2 epochs straight equals training 1, restarting from its
    checkpoint and training the second (augmentation drawn from the
    (seed, epoch, step) generator), as tests/test_resume.py holds the
    JAX package's Trainer."""
    kw = dict(max_epoch=2, optimizer="adam")
    tr_a = port_trainer(tmp_path / "a", random_variables(1, seed=1)[1],
                        *datasets(SyntheticHandDataset), **kw)
    tr_a.train()
    pa = params(tr_a)
    tr_a.close()

    _, variables = random_variables(1, seed=1)
    tr_b = port_trainer(tmp_path / "b", variables,
                        *datasets(SyntheticHandDataset), **dict(kw,
                                                               max_epoch=1))
    tr_b.train()
    tr_b.close()
    tr_c = Trainer(hourglass_config(**COMMON, **kw),
                   *datasets(SyntheticHandDataset),
                   workdir=str(tmp_path / "b"), device="cpu")
    assert tr_c.best_records["epoch"] == 1
    tr_c.train()
    pc = params(tr_c)
    tr_c.close()
    assert pa.keys() == pc.keys()
    for k in pa:
        np.testing.assert_allclose(pc[k], pa[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)


CLI = ["--net", "hourglass_1", "--synthetic", "--data-mode", "raw",
       "--img-size", str(IMG), "--batch-size", str(B), "--synthetic-size",
       "4"]


def test_cli_train_then_evaluate_on_cpu(tmp_path, capsys):
    """train.main trains, checkpoints and resumes; evaluate.main scores
    the last checkpoint with the trainer's last test MPE."""
    out = ["--output-dir", str(tmp_path), "--device", "cpu"]
    tr = train.main(CLI + out + ["--epochs", "1"])
    tr = train.main(CLI + out + ["--epochs", "2"])
    log = open(tr.log_file).read()
    assert "restored checkpoint (epoch 1)" in log
    assert log.count("[epoch 02], [train loss") == 1
    assert log.count("[epoch 01], [train loss") == 1
    ckpt = os.path.join(tr.work_dir, "ckpt")
    assert sorted(os.listdir(ckpt)) == ["1.pth", "2.pth"]
    last = re.findall(r"\[epoch  2\].*\[test mpe ([\d.]+)\]", log)
    mpe = evaluate.main(CLI + out + ["--load-model",
                                     os.path.join(ckpt, "2.pth")])
    assert f"{mpe:.3f}" == last[-1]
    assert glob.glob(os.path.join(tr.work_dir, "test_pck_epoch_-1.png"))
    assert "results: [MPE" in capsys.readouterr().out


@pytest.mark.parametrize("cli", [train, evaluate])
def test_cli_without_device_raises_without_gpu(cli, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(CLI + ["--output-dir", str(tmp_path)])


def test_cli_host_mode_and_real_datasets_raise(tmp_path):
    """Host mode and the real datasets are served now
    (tests/test_torch_datasets.py runs the CLIs on an NYU-layout
    directory); a directory without the dataset's files still raises.
    bfloat16 is served too: the evaluate CLI runs in it; an unknown
    compute dtype is refused."""
    out = ["--output-dir", str(tmp_path), "--device", "cpu"]
    with pytest.raises(FileNotFoundError, match="NYU split directory"):
        evaluate.main(["--net", "hourglass_1", "--data-dir",
                       str(tmp_path / "absent")] + out)
    assert np.isfinite(evaluate.main(CLI + out
                                     + ["--compute-dtype", "bfloat16"]))
    with pytest.raises(SystemExit):
        evaluate.main(CLI + out + ["--compute-dtype", "float16"])
