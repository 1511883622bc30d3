"""``Predictor.export_program`` and the custom ops it traces through, on
the CPU: the port's exported program, read back by
``awr_tpu_torch.export.load``, against the JAX package's
``export_stablehlo`` payload on the same weights and inputs, and against
the port's own Predictor; and a fresh process that loads a program
without the port's model code.  (``tests/test_torch_ops.py`` holds the
custom ops themselves: ``opcheck``, and ``torch.compile`` through them.)
PyTorch runs on one thread (``one_thread``)."""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
from jax import export as jax_export
from torch_port_weights import random_variables, resnet_variables
from torch_port_weights import one_thread  # noqa: F401

from awr_tpu.config import hourglass_config as jax_hourglass_config
from awr_tpu.config import resnet_config as jax_resnet_config
from awr_tpu.data.device import \
    crop_normalize_batch as jax_crop_normalize_batch
from awr_tpu.serving import Predictor as JaxPredictor
from awr_tpu_torch import export
from awr_tpu_torch.config import hourglass_config, resnet_config
from awr_tpu_torch.data.device import crop_normalize_batch
from awr_tpu_torch.data.synthetic import synthetic_frames
from awr_tpu_torch.data.transforms import crop_params_np
from awr_tpu_torch.geometry import xyz2uvd_np
from awr_tpu_torch.models import build_model
from awr_tpu_torch.models.weights import load_flax_variables
from awr_tpu_torch.serving import Predictor, denormalize_uvd

ROOT = pathlib.Path(__file__).resolve().parent.parent
IMG = 32
B = 8
# the bars of the port's Predictor against the JAX one
# (tests/test_torch_serving.py: normalized uvd 1e-4, camera px/mm 0.05;
# tests/test_torch_quant.py INT8_ATOL: int8 normalized uvd 1e-3)
ATOL = {"normalized": 1e-4, "raw": 0.05, "int8": 1e-3}
# the Predictor's float64 inverse of the crop affine on the host against
# the program's float32 one on the device (the JAX package's bar for the
# same comparison, tests/test_serving.py:285)
INV_ATOL = 1e-2


@pytest.fixture(scope="module")
def frames():
    return synthetic_frames(B, 14, seed=13)


@pytest.fixture(scope="module")
def predictors(frames):
    """``predictors(net, int8)``: the JAX Predictor, the port's on the same
    weights (after ``quantize`` on both sides with ``int8``) and the
    crops of ``frames``, built once a module."""
    made = {}

    def get(net, int8=False):
        if (net, int8) not in made:
            made[net, int8] = _predictors(net, frames, int8)
        return made[net, int8]

    return get


def _predictors(net, frames, int8):
    if net == "hourglass_1":
        variables = random_variables(1, seed=4)[1]
        jax_cfg = jax_hourglass_config(img_size=IMG, use_pallas=False)
        cfg = hourglass_config(img_size=IMG)
    else:
        variables = resnet_variables(18, 2, IMG, seed=7)[1]
        jax_cfg = jax_resnet_config(img_size=IMG, use_pallas=False)
        cfg = resnet_config(img_size=IMG)
    model = load_flax_variables(
        build_model(cfg.net, cfg.jt_num, cfg.downsample), variables)
    jax_pred, pred = JaxPredictor(jax_cfg, variables), Predictor(
        cfg, model, device="cpu")
    crops = _crops(pred, frames)
    if int8:
        jax_pred.quantize(crops)
        pred.quantize(crops)
    return jax_pred, pred, crops


def _crops(pred, frames):
    imgs, _, centers = frames
    img, _ = crop_normalize_batch(
        torch.from_numpy(imgs), xyz2uvd_np(centers, pred.paras, pred.flip),
        np.tile(pred.cfg.cube, (len(imgs), 1)), pred.paras, IMG)
    return img.numpy()


def _raw_args(pred, frames):
    """The raw extent's inputs: the frames, ``crop_params_np``'s dict,
    the center and cube depths (the JAX test's host side)."""
    imgs, _, centers = frames
    cubes = np.tile(np.asarray(pred.cfg.cube, np.float64), (len(imgs), 1))
    cu = xyz2uvd_np(centers, pred.paras, pred.flip)
    p = crop_params_np(cu, cubes, np.asarray(pred.paras), IMG)
    return (imgs, p, cu[:, 2].astype(np.float32),
            cubes[:, 2].astype(np.float32))


CASES = [("hourglass_1", "normalized"), ("resnet_18", "normalized"),
         ("hourglass_1", "raw"), ("resnet_18", "int8")]


@pytest.fixture(scope="module")
def payloads():
    """The bytes of each program exported, by (net, extent)."""
    return {}


@pytest.fixture(scope="module", params=CASES, ids="-".join)
def case(request, frames, predictors, payloads):
    """(net, extent, the JAX Predictor, the port's, the crops, the
    program's arguments, the port's program read back)."""
    net, extent = request.param
    jax_pred, pred, crops = predictors(net, extent == "int8")
    raw_hw = frames[0].shape[1:] if extent == "raw" else None
    args = _raw_args(pred, frames) if raw_hw else (crops,)
    payloads[net, extent] = pred.export_program(B, raw_hw=raw_hw)
    prog = export.load(payloads[net, extent], device="cpu")
    return net, extent, jax_pred, pred, crops, args, prog


def test_exported_program_matches_jax_payload(case, frames):
    """The port's program against the JAX package's ``export_stablehlo``
    payload (``use_pallas=False``, as its own CPU tests run it), read back
    by ``jax.export.deserialize``, on the same weights and inputs.

    The raw extent crops in the program, and the two packages' device
    crops differ on purpose: the port takes OpenCV's nearest index in
    float64, which is the host crop's bit for bit, the JAX package the
    float32 quotient (ROADMAP.md queue 3).
    Frames whose crops agree are held to the bar; on the others the
    crops must differ, as that index makes them do, and
    ``test_exported_program_equals_the_predictor`` holds the program to
    the port's own crop."""
    net, extent, jax_pred, pred, crops, args, prog = case
    raw_hw = prog.raw_hw
    payload = jax_pred.export_stablehlo(batch_size=B, raw_hw=raw_hw)
    want = np.asarray(jax_export.deserialize(payload).call(*args))
    got = prog.call(*args).numpy()
    assert prog.batch_size == B and got.shape == (B, 14, 3)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    same = np.ones(B, bool)
    if raw_hw is not None:
        imgs, _, centers = frames
        jax_crops = np.asarray(jax_crop_normalize_batch(
            imgs, xyz2uvd_np(centers, pred.paras, pred.flip),
            np.tile(pred.cfg.cube, (B, 1)), np.asarray(pred.paras), IMG)[0])
        same = (jax_crops == crops).all(axis=(1, 2))
        assert same.sum() >= B - 2, same
        bad = np.abs(got - want).max(axis=(1, 2)) > ATOL[extent]
        assert not (bad & same).any()
    np.testing.assert_allclose(got[same], want[same], rtol=0,
                               atol=ATOL[extent])


def test_exported_program_equals_the_predictor(case, frames):
    """The program read back against the Predictor it was traced from,
    bit for bit: ``predict_normalized`` (B is a full bucket, so both run
    the batch as it is); for the raw extent the Predictor's crop, forward
    and decode followed by :func:`denormalize_uvd`, and ``predict``
    (whose float64 inverse of the crop affine moves a joint by less than
    INV_ATOL)."""
    net, extent, jax_pred, pred, crops, args, prog = case
    got = prog.call(*args).numpy()
    if prog.raw_hw is None:
        np.testing.assert_array_equal(got, pred.predict_normalized(crops))
        return
    imgs, p, center_z, cube_z = args
    uvd = torch.from_numpy(pred.predict_normalized(crops))
    want = denormalize_uvd(uvd, torch.from_numpy(p["M"]),
                           torch.from_numpy(center_z),
                           torch.from_numpy(cube_z), IMG).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, pred.predict(imgs, frames[2]), rtol=0,
                               atol=INV_ATOL)


FRESH_PROCESS = r"""
import json, sys
import numpy as np
from awr_tpu_torch import export
prog = export.load(sys.argv[1], device="cpu")
out = prog.call(np.load(sys.argv[2])).numpy()
np.save(sys.argv[3], out)
print(json.dumps({"models": "awr_tpu_torch.models" in sys.modules,
                  "serving": "awr_tpu_torch.serving" in sys.modules,
                  "meta": prog.meta}))
"""


def test_program_loads_in_a_fresh_process(tmp_path, predictors, payloads):
    """A saved program (``path``) runs in a process that imports the
    loader and nothing of the models or the Predictor, with the joints of
    the process that traced it (on a reversed view of the crops)."""
    _, pred, crops = predictors("hourglass_1")
    path = tmp_path / "hourglass_1.pt2"
    payload = payloads.get(("hourglass_1", "normalized"))
    if payload is None:
        payload = pred.export_program(B)
    path.write_bytes(payload)
    np.save(tmp_path / "img.npy", crops[:, ::-1])
    env = dict(os.environ, OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-c", FRESH_PROCESS, str(path),
         str(tmp_path / "img.npy"), str(tmp_path / "out.npy")],
        cwd=ROOT, capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    info = json.loads(res.stdout.splitlines()[-1])
    assert not info["models"] and not info["serving"]
    assert info["meta"]["batch_size"] == B and info["meta"]["raw_hw"] is None
    np.testing.assert_array_equal(
        np.load(tmp_path / "out.npy"),
        pred.predict_normalized(np.ascontiguousarray(crops[:, ::-1])))
