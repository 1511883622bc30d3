"""The port's serving path end to end against the JAX package's
``Predictor`` (same weights, same raw frames), and the port's import
boundary."""

import ast
import os
import pathlib

import numpy as np
import pytest
import torch
from torch_port_weights import flax_variables
from torch_port_weights import one_thread  # noqa: F401

from awr_tpu.config import hourglass_config as jax_hourglass_config
from awr_tpu.serving import Predictor as JaxPredictor
from awr_tpu_torch.config import hourglass_config
from awr_tpu_torch.data.device import crop_normalize_batch
from awr_tpu_torch.data.synthetic import synthetic_frames
from awr_tpu_torch.geometry import xyz2uvd_np
from awr_tpu_torch.models import build_model
from awr_tpu_torch.models.weights import load_flax_variables
from awr_tpu_torch.serving import Predictor

ROOT = pathlib.Path(__file__).resolve().parent.parent
IMG = 64


@pytest.fixture(scope="module")
def predictors():
    _, variables = flax_variables(1, seed=4)
    jax_pred = JaxPredictor(
        jax_hourglass_config(img_size=IMG, use_pallas=False), variables)
    cfg = hourglass_config(img_size=IMG)
    model = load_flax_variables(build_model(cfg.net, cfg.jt_num), variables)
    return jax_pred, Predictor(cfg, model, device="cpu")


@pytest.fixture(scope="module")
def frames():
    return synthetic_frames(3, 14, seed=11)


def test_predict_matches_jax_predictor(predictors, frames):
    """3 raw frames: padded to the bucket of 8 on both sides."""
    jax_pred, pred = predictors
    imgs, _, centers = frames
    got = pred.predict(imgs, centers)
    want = jax_pred.predict(imgs, centers)
    assert got.shape == (3, 14, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=0.05)  # px / mm


def test_predict_normalized_matches_jax_predictor(predictors, frames):
    jax_pred, pred = predictors
    imgs, _, centers = frames
    crops, _ = crop_normalize_batch(
        torch.from_numpy(imgs), xyz2uvd_np(centers, pred.paras, pred.flip),
        np.tile(pred.cfg.cube, (3, 1)), pred.paras, IMG)
    got = pred.predict_normalized(crops.numpy())
    want = jax_pred.predict_normalized(crops.numpy())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_predict_xyz_and_async(predictors, frames):
    _, pred = predictors
    imgs, _, centers = frames
    uvd = pred.predict_async(imgs[:2], centers[:2])()
    np.testing.assert_array_equal(uvd, pred.predict(imgs[:2], centers[:2]))
    xyz = pred.predict_xyz(imgs[:2], centers[:2])
    # the hands lie 650-950 mm away, joints within ~110 mm of the center
    assert np.all(np.abs(xyz[..., 2] - centers[:2, None, 2]) < 200)


@pytest.mark.parametrize("B", [3, 8])  # below the bucket of 8, and at it
def test_predict_takes_a_reversed_view(predictors, frames, B):
    """A float32 view with negative strides (frames mirrored left to
    right) gives the joints of its contiguous copy."""
    _, pred = predictors
    imgs, _, centers = frames
    imgs, centers = np.resize(imgs, (B,) + imgs.shape[1:]), np.resize(
        centers, (B, 3))
    view = imgs[:, :, ::-1]
    np.testing.assert_array_equal(
        pred.predict(view, centers),
        pred.predict(np.ascontiguousarray(view), centers))


def test_bucket_and_empty_batch(predictors):
    _, pred = predictors
    assert [pred._bucket(n) for n in (1, 8, 9, 33)] == [8, 8, 16, 64]
    with pytest.raises(ValueError, match="empty"):
        pred.predict_normalized(np.zeros((0, IMG, IMG), np.float32))
    with pytest.raises(ValueError, match="empty"):
        pred.predict(np.zeros((0, 480, 640), np.float32), np.zeros((0, 3)))


def test_from_torch_reads_reference_checkpoint(tmp_path, predictors, frames):
    _, pred = predictors
    path = tmp_path / "hourglass_1.pth"
    torch.save({"model": pred.model.state_dict(), "optimizer": {},
                "best_records": {"epoch": 1, "MPE": 8.5}}, path)
    loaded = Predictor.from_torch(pred.cfg, str(path), device="cpu")
    imgs, _, centers = frames
    np.testing.assert_array_equal(loaded.predict(imgs, centers),
                                  pred.predict(imgs, centers))


def test_no_device_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = hourglass_config(img_size=IMG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor(cfg, build_model(cfg.net, cfg.jt_num))


FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "cv2", "matplotlib",
             "awr_tpu"}


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in
    [*(ROOT / "awr_tpu_torch").rglob("*.py"), ROOT / "chip_smoke.py"]))
def test_port_imports_no_jax_and_nothing_of_awr_tpu(path):
    """An AST scan, not a sys.modules check: this image's interpreter
    imports jax at startup."""
    tree = ast.parse((ROOT / path).read_text(), path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    assert not roots & FORBIDDEN, roots & FORBIDDEN


# where the port may import scipy (``scipy.io``, for NYU's
# joint_data.mat): inside these functions only, never at module level
SCIPY_ALLOWED = {"awr_tpu_torch/data/nyu.py": {"load_labels"},
                 "chip_smoke.py": {"write_nyu_fixture"}}


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in
    [*(ROOT / "awr_tpu_torch").rglob("*.py"), ROOT / "chip_smoke.py"]))
def test_port_imports_scipy_only_in_the_nyu_label_loader(path):
    tree = ast.parse((ROOT / path).read_text(), path)
    found = []

    def walk(node, func):
        for child in ast.iter_child_nodes(node):
            name = (child.name if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef)) else func)
            mods = []
            if isinstance(child, ast.Import):
                mods = [a.name for a in child.names]
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                mods = [child.module]
            found.extend((m, func) for m in mods
                         if m.split(".")[0] == "scipy")
            walk(child, name)

    walk(tree, None)
    allowed = SCIPY_ALLOWED.get(path.replace(os.sep, "/"), set())
    assert all(m == "scipy.io" and func in allowed for m, func in found), \
        found
