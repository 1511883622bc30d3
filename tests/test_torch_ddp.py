"""The port's data-parallel Trainer and CLIs at W = 2 on the CPU (gloo).

Two ranks (``torch_ddp_worker``: processes of their own, a ``file://``
rendezvous, one thread a rank, a 120 s limit) train hourglass_1 at img
32, batch 4, on 5 raw synthetic train frames (a final batch of 1, padded
to 2: rank 1 holds padding only) and test on 3 (padded to 4), without
augmentation (``draw_augment_params`` patched to op 3, as
tests/test_torch_trainer.py does).  Here, in the pytest process, the
single-process port Trainer trains on the same data with the same
padding (``_pad_multiple`` 2), so both train on the same global
batches.
"""

import os

import numpy as np
import pytest
import torch
import torch_ddp_worker as worker
from torch_port_weights import IMG, random_variables
from torch_port_weights import one_thread  # noqa: F401

from awr_tpu_torch.config import hourglass_config
from awr_tpu_torch.data import device as port_device
from awr_tpu_torch.data.synthetic import SyntheticHandDataset
from awr_tpu_torch.models import build_model
from awr_tpu_torch.models.weights import load_flax_variables
from awr_tpu_torch.serving import Predictor
from awr_tpu_torch.training.trainer import Trainer

CONFIG = dict(img_size=IMG, batch_size=4, vis_freq=1, print_freq=1000,
              num_workers=2, coord_weight=1.0, lr=1e-4)
N_TRAIN, N_TEST = 5, 3
CLI = ["--net", "hourglass_1", "--synthetic", "--data-mode", "raw",
       "--img-size", str(IMG), "--batch-size", "4", "--synthetic-size",
       str(N_TRAIN), "--synthetic-test-size", str(N_TEST)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' runs (worker ``trainer``) and the weights file."""
    root = tmp_path_factory.mktemp("ddp_trainer")
    model = load_flax_variables(build_model("hourglass_1", 14),
                                random_variables(1, seed=3)[1])
    torch.save(model.state_dict(), root / "weights.pt")
    spec = {"trainer": dict(config=CONFIG, n_train=N_TRAIN, n_test=N_TEST,
                            weights=str(root / "weights.pt"),
                            root=str(root / "runs"), cli=CLI)}
    return worker.run_ranks(["trainer"], 2, root / "ranks",
                            spec)["trainer"], root


def single_process(tmp_path, weights, monkeypatch):
    """The one-device Trainer on the same padded batches, with spies on
    its steps' losses and its test results."""
    monkeypatch.setattr(port_device, "draw_augment_params",
                        worker.no_augmentation)
    cfg = hourglass_config(**CONFIG, max_epoch=2)
    train = SyntheticHandDataset(N_TRAIN, 14, IMG, phase="train", seed=0,
                                 mode="raw")
    test = SyntheticHandDataset(N_TEST, 14, IMG, phase="test", seed=1,
                                mode="raw")
    tr = Trainer(cfg, train, test, workdir=str(tmp_path), device="cpu")
    tr._pad_multiple = 2  # the W = 2 Trainer's padding
    tr.model.load_state_dict(torch.load(weights, weights_only=True))
    losses, tests = [], []
    step, test_fn = tr._raw_train_step, tr.test

    def step_spy(*args):
        out = step(*args)
        losses.append(float(out["loss"]))
        return out

    def test_spy(epoch=0):
        tests.append(test_fn(epoch))
        return tests[-1]

    tr._raw_train_step, tr.test = step_spy, test_spy
    tr.train()
    tr.close()
    return losses, tests, tr


def test_w2_trainer_matches_single_process(runs, tmp_path, monkeypatch):
    """2 epochs of 2 Adam steps at lr 1e-4: per-step losses and per-epoch
    test MPE at test_two_epochs_match_jax's bars (first step rtol 1e-5,
    the rest 3e-2), the epoch cursor and best epoch exactly; both ranks
    report the same losses, test results and records (the joints are
    gathered to every rank), with the global BatchNorm swapped in.
    Measured on the CPU: losses within 5.7e-3 relative (float32 Adam
    from the third step), test MPE within 3.1e-4."""
    (r0, r1), root = runs
    losses, tests, tr = single_process(tmp_path, root / "weights.pt",
                                       monkeypatch)
    assert len(r0["losses"]) == len(losses) == 4
    for key in ("losses", "tests", "best_records"):
        assert r0[key] == r1[key], key
    np.testing.assert_allclose(r0["losses"][:1], losses[:1], rtol=1e-5)
    np.testing.assert_allclose(r0["losses"], losses, rtol=3e-2)
    np.testing.assert_allclose([m for m, _ in r0["tests"]],
                               [m for m, _ in tests], rtol=3e-2)
    got, want = r0["best_records"], tr.best_records
    assert (got["epoch"], got["best_epoch"]) == (want["epoch"],
                                                 want["best_epoch"])
    np.testing.assert_allclose(got["MPE"], want["MPE"], rtol=3e-2)
    assert r0["global_bn"] == r1["global_bn"] > 0


def test_only_rank_0_writes(runs):
    """Rank 1 opened no file for writing and made no directory under the
    runs' root (Python's audit events); rank 0 wrote the log, the
    checkpoints, the PCK figures, the pose figures (``vis_freq`` 1) of
    the Trainer and both CLIs."""
    (r0, r1), root = runs
    assert r0["writes"] is None and r1["writes"] == []
    straight = root / "runs" / "straight"
    assert sorted(os.listdir(straight / "ckpt")) == ["1.pth", "2.pth"]
    assert (straight / "hourglass_1_dense.log").exists()
    assert (straight / "test_pck_epoch_2.png").exists()
    assert os.listdir(straight / "results")
    cli = r0["cli_work_dir"]
    log = open(os.path.join(cli, "hourglass_1_dense.log")).read()
    assert log.count("[epoch 01], [train loss") == 1
    assert os.path.exists(os.path.join(cli, "test_pck_epoch_-1.png"))
    assert r0["eval_mpe"] == r1["eval_mpe"]
    np.testing.assert_allclose(r0["eval_mpe"], r0["cli_best"]["MPE"],
                               rtol=1e-6)


def test_checkpoint_loads_in_single_process_predictor(runs):
    """Rank 0's checkpoint holds the unwrapped model's state dict:
    ``Predictor.from_checkpoint`` on one device loads it, equal to the
    ranks' final weights."""
    (r0, r1), root = runs
    pred = Predictor.from_checkpoint(hourglass_config(img_size=IMG),
                                     str(root / "runs" / "straight" / "ckpt"),
                                     device="cpu")
    state = pred.model.state_dict()
    assert state.keys() == r0["straight"].keys()
    for k, v in r0["straight"].items():
        assert torch.equal(state[k], v), k
        assert torch.equal(r1["straight"][k], v), k
    out = pred.predict_normalized(np.ones((3, IMG, IMG), np.float32))
    assert out.shape == (3, 14, 3) and np.isfinite(out).all()


def test_w2_resume_equals_straight_run(runs):
    """One epoch, then a new W = 2 Trainer that restores it on every rank
    and trains the second, ends at the straight run's weights
    (tests/test_torch_trainer.py's bars: rtol 1e-5, atol 1e-7)."""
    (r0, r1), _ = runs
    assert r0["resumed_from"] == r1["resumed_from"] == 1
    for k, v in r0["straight"].items():
        np.testing.assert_allclose(r0["resumed"][k], v, rtol=1e-5,
                                   atol=1e-7, err_msg=k)
        assert torch.equal(r1["resumed"][k], r0["resumed"][k]), k
