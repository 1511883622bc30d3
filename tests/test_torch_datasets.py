"""The port's NYU, ICVL, MSRA and HANDS17 loaders against the JAX
package's, on fixture directories in each dataset's layout, written with
cv2 and scipy by the JAX package's own fixture writers
(tests/test_nyu_files.py, tests/test_icvl_msra.py): raw items, host items
(test phase, and train phase with its augmentation drawn from the same
seed), the label tables, the MSRA split, and the missing-file errors;
then the train and evaluate CLIs on an NYU-layout directory, and
``compare_dumps`` on the port's dump against the JAX Trainer's."""

import glob
import json
import os
import re
import warnings

import jax
import numpy as np
import pytest
from test_icvl_msra import write_fake_hands17, write_fake_icvl, write_fake_msra
from test_nyu_files import write_fake_nyu
from torch_port_weights import IMG, random_variables
from torch_port_weights import one_thread  # noqa: F401

import awr_tpu.data as jax_data
import awr_tpu.data.nyu as jax_nyu
from awr_tpu.config import Config as JaxConfig
from awr_tpu.parallel.mesh import replicated
from awr_tpu.training import compare_dumps as jax_compare
from awr_tpu.training.trainer import Trainer as JaxTrainer
import awr_tpu_torch.data as port_data
import awr_tpu_torch.data.nyu as port_nyu
from awr_tpu_torch.config import hourglass_config
from awr_tpu_torch.models.weights import load_flax_variables
from awr_tpu_torch.training import compare_dumps, evaluate, train
from awr_tpu_torch.training.trainer import Trainer

NAMES = {"nyu": "NYUDataset", "icvl": "ICVLDataset", "msra": "MSRADataset",
         "hands17": "Hands17Dataset"}
# the bars of the host chain's augment (tests/test_torch_host_data.py,
# the JAX package's own against the reference, tests/test_data.py:92-96)
AUG_BARS = dict(img=(0, 1e-5), jt_xyz=(1e-4, 1e-3), jt_uvd=(1e-4, 1e-4),
                cube=(1e-6, 0), center_xyz=(1e-5, 0), M=(1e-4, 1e-4))


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("datasets")
    out = {}
    for name, write in (("nyu", write_fake_nyu), ("icvl", write_fake_icvl),
                        ("msra", write_fake_msra),
                        ("hands17", write_fake_hands17)):
        out[name] = write(str(base / name))
    return out


def both(name, root, phase, **kw):
    """The port's and the JAX package's dataset on the same files."""
    if name in ("msra", "hands17"):
        kw.setdefault("allow_centroid_centers", True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the centroid-center warning
        return (getattr(port_data, NAMES[name])(root, phase, **kw),
                getattr(jax_data, NAMES[name])(root, phase, **kw))


def phases(name):
    return ["train"] if name == "hands17" else ["train", "test"]


@pytest.mark.parametrize("name", sorted(NAMES))
def test_raw_items_bit_equal_jax(roots, name):
    for phase in phases(name):
        ours, theirs = both(name, roots[name], phase, mode="raw")
        assert len(ours) == len(theirs) > 0
        for i in range(len(ours)):
            got, want = ours[i], theirs[i]
            assert got.keys() == want.keys()
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("name", sorted(NAMES))
def test_host_items_match_jax(roots, name):
    """Un-augmented host items (the test phase; hands17 ships one split,
    read here with ``val``) within 1e-6; train items, whose augmentation
    both datasets draw from RandomState(23455) in the same order, at the
    augment bars."""
    for phase, val in (("test", False), ("train", True), ("train", False)):
        if name == "hands17" and phase == "test":
            continue
        ours, theirs = both(name, roots[name], phase, val=val, img_size=IMG)
        for i in list(range(len(ours))) * (1 if val or phase == "test"
                                           else 2):
            got, want = ours[i], theirs[i]
            assert got.keys() == want.keys()
            for k in want:
                assert got[k].dtype == want[k].dtype == np.float32, k
                if phase == "test" or val:
                    np.testing.assert_allclose(got[k], want[k], rtol=0,
                                               atol=1e-6, err_msg=k)
                else:
                    rtol, atol = AUG_BARS[k]
                    np.testing.assert_allclose(got[k], want[k], rtol=rtol,
                                               atol=atol, err_msg=k)
        # the same draws: the two streams stay in step
        assert ours.rng.randint(1 << 30) == theirs.rng.randint(1 << 30)


@pytest.mark.parametrize("name", sorted(NAMES))
def test_label_tables_match_jax(roots, name, monkeypatch):
    """Paths, labels, centers and cube_for; NYU's second-subject rule with
    its boundary moved to frame 2 of the 4-frame test split."""
    monkeypatch.setattr(port_nyu, "SECOND_SUBJECT_START", 2)
    monkeypatch.setattr(jax_nyu, "SECOND_SUBJECT_START", 2)
    for phase in phases(name):
        ours, theirs = both(name, roots[name], phase)
        assert ours.image_paths == theirs.image_paths
        for attr in ("labels_xyz", "labels_uvd", "centers", "test_cube"):
            if hasattr(theirs, attr):
                np.testing.assert_array_equal(getattr(ours, attr),
                                              getattr(theirs, attr), attr)
        for i in range(len(ours)):
            np.testing.assert_array_equal(ours.cube_for(i),
                                          theirs.cube_for(i))
        assert (ours.paras, ours.flip, ours.jt_num) == (
            theirs.paras, theirs.flip, theirs.jt_num)
    if name == "nyu":
        ours, _ = both(name, roots[name], "test")
        np.testing.assert_array_equal(ours.cube_for(1), [300.0] * 3)
        np.testing.assert_allclose(ours.cube_for(2), [250.0] * 3)
        np.testing.assert_array_equal(port_nyu.JOINT_SELECT,
                                      jax_nyu.JOINT_SELECT)
        np.testing.assert_array_equal(port_nyu.EVAL_SELECT,
                                      jax_nyu.EVAL_SELECT)


def test_msra_leave_one_subject_out_matches_jax(roots):
    for subject in (0, 1):
        for phase in ("train", "test"):
            ours, theirs = both("msra", roots["msra"], phase,
                                test_subject=subject)
            assert ours.image_paths == theirs.image_paths
            assert all((f"P{subject}" in p) == (phase == "test")
                       for p in ours.image_paths)


def error_of(fn):
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        try:
            fn()
        except (FileNotFoundError, OSError) as e:
            return type(e), str(e), [str(w.message) for w in seen]
    return None, None, [str(w.message) for w in seen]


@pytest.mark.parametrize("name", sorted(NAMES))
def test_missing_files_and_centroid_warning_match_jax(roots, name, tmp_path):
    """The same exception and message for a directory without the
    dataset's files; for MSRA and HANDS17, the same refusal without
    refined centers and the same warning when centroids are allowed."""
    empty = str(tmp_path / "empty")
    os.makedirs(os.path.join(empty, "train"))
    for root in (str(tmp_path / "absent"), empty):
        kw = {"allow_centroid_centers": True} if name in (
            "msra", "hands17") else {}
        got = error_of(lambda: getattr(port_data, NAMES[name])(
            root, "train", **kw))
        want = error_of(lambda: getattr(jax_data, NAMES[name])(
            root, "train", **kw))
        assert got == want
    if name in ("msra", "hands17"):
        for allow in (False, True):
            kw = {"allow_centroid_centers": allow}
            got = error_of(lambda: getattr(port_data, NAMES[name])(
                roots[name], "train", **kw))
            want = error_of(lambda: getattr(jax_data, NAMES[name])(
                roots[name], "train", **kw))
            assert got == want
            assert (got[0] is FileNotFoundError) == (not allow)
            assert bool(got[2]) == allow


def test_cli_train_then_evaluate_on_nyu_directory(roots, tmp_path, capsys):
    """The CLIs' defaults read an NYU-layout directory in host mode:
    train.main trains and checkpoints; evaluate.main scores the
    checkpoint with the Trainer's last test MPE."""
    cli = ["--net", "hourglass_1", "--dataset", "nyu", "--data-dir",
           roots["nyu"], "--img-size", str(IMG), "--batch-size", "4",
           "--output-dir", str(tmp_path), "--device", "cpu"]
    tr = train.main(cli + ["--epochs", "1"])
    assert tr.train_data.mode == tr.test_data.mode == "host"
    assert isinstance(tr.train_data, port_data.NYUDataset)
    log = open(tr.log_file).read()
    last = re.findall(r"\[epoch  1\].*\[test mpe ([\d.]+)\]", log)
    ckpt = os.path.join(tr.work_dir, "ckpt", "1.pth")
    mpe = evaluate.main(cli + ["--load-model", ckpt])
    assert f"{mpe:.3f}" == last[-1]
    assert "results: [MPE" in capsys.readouterr().out


def test_compare_dumps_port_against_jax_trainer(roots, tmp_path, capsys):
    """The port's evaluation dump of the NYU test split and the JAX
    Trainer's, from the same weights in host mode: compare_dumps passes
    them within 0.05 mm, and gives the JAX tool's statistics."""
    _, variables = random_variables(1, seed=5)
    kw = dict(img_size=IMG, batch_size=4, vis_freq=0, print_freq=1000,
              num_workers=2)
    jtest = jax_data.NYUDataset(roots["nyu"], "test", img_size=IMG)
    jtr = JaxTrainer(JaxConfig(net="hourglass_1", kernel_size=0.4,
                               use_pallas=False, mesh_devices=1, **kw),
                     test_data=jtest, workdir=str(tmp_path / "jax"))
    jtr.state = jax.device_put(jtr.state._replace(
        params=variables["params"], batch_stats=variables["batch_stats"]),
        replicated(jtr.mesh))
    ptr = Trainer(hourglass_config(**kw),
                  test_data=port_data.NYUDataset(roots["nyu"], "test",
                                                 img_size=IMG),
                  workdir=str(tmp_path / "port"), device="cpu")
    load_flax_variables(ptr.model, variables)
    jtr.test(0)
    ptr.test(0)
    jtr.close()
    ptr.close()
    (golden,) = glob.glob(os.path.join(jtr.work_dir, "test_*.txt"))
    (ours,) = glob.glob(os.path.join(ptr.work_dir, "test_*.txt"))
    report = str(tmp_path / "report.json")
    capsys.readouterr()
    assert compare_dumps.main([golden, ours, "--tol-mm", "0.05",
                               "--report", report]) == 0
    summary = json.loads(capsys.readouterr().out.splitlines()[-1])
    stats = json.load(open(report))
    assert summary["frames"] == 4 and summary["joints"] == 14
    want = jax_compare.compare(
        jax_compare.load_prediction_txt(golden),
        jax_compare.load_prediction_txt(ours),
        *jax_compare.DATASET_CAMERA["nyu"])
    assert stats == json.loads(json.dumps(want))
    # a dump against itself is 0 mm; a gate below the diff fails
    assert compare_dumps.main([ours, ours, "--tol-mm", "0"]) == 0
    if stats["mean_mm"] > 0:
        assert compare_dumps.main([golden, ours, "--tol-mm",
                                   str(stats["mean_mm"] / 2)]) == 1
