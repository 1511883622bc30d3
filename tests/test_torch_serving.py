"""The port's serving path end to end against the JAX package's
``Predictor`` (same weights, same raw frames), the Predictor's packed crop
windows against the full frames' crop, and the port's import boundary."""

import ast
import copy
import os
import pathlib

import numpy as np
import pytest
import torch
from torch_port_weights import flax_variables, resnet_variables
from torch_port_weights import one_thread  # noqa: F401

from awr_tpu.config import hourglass_config as jax_hourglass_config
from awr_tpu.serving import Predictor as JaxPredictor
from awr_tpu_torch import export
from awr_tpu_torch.config import hourglass_config, resnet_config
from awr_tpu_torch.data import windows
from awr_tpu_torch.data.device import crop_normalize_batch
from awr_tpu_torch.data.synthetic import synthetic_frames
from awr_tpu_torch.data.transforms import crop_params_np
from awr_tpu_torch.geometry import uvd2xyz_np, xyz2uvd_np
from awr_tpu_torch.models import build_model
from awr_tpu_torch.models.common import torch_default_init_
from awr_tpu_torch.models.weights import load_flax_variables
from awr_tpu_torch.serving import Predictor
from awr_tpu_torch.training import qat

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


@pytest.mark.parametrize("B", [8, 16])  # full buckets: the pad copies nothing
def test_predict_normalized_takes_a_reversed_view(predictors, frames, B):
    """``predict_normalized`` on a float32 view with negative strides
    gives the joints of its contiguous copy."""
    _, pred = predictors
    imgs, _, centers = frames
    crops, _ = crop_normalize_batch(
        torch.from_numpy(imgs), xyz2uvd_np(centers, pred.paras, pred.flip),
        np.tile(pred.cfg.cube, (3, 1)), pred.paras, IMG)
    view = np.resize(crops.numpy(), (B, IMG, IMG))[:, ::-1]
    np.testing.assert_array_equal(
        pred.predict_normalized(view),
        pred.predict_normalized(np.ascontiguousarray(view)))


def test_quantize_takes_a_reversed_view(predictors, frames):
    """``quantize`` calibrates on a view with negative strides to the
    scales of its contiguous copy, bit for bit."""
    _, pred = predictors
    view = np.random.RandomState(3).uniform(
        -1, 1, (4, IMG, IMG)).astype(np.float32)[:, :, ::-1]
    got, want = copy.deepcopy(pred), copy.deepcopy(pred)
    got.quantize(view)
    want.quantize(np.ascontiguousarray(view))
    assert got.quant.keys() == want.quant.keys()
    for k in want.quant:
        assert torch.equal(got.quant[k], want.quant[k]), k


def test_qat_batches_take_a_reversed_view(predictors):
    """The QAT fine-tune's batches (``qat._device_batches``, which
    ``finetune``, ``int8_holdout_metrics`` and ``quantize_qat`` take) with
    a reversed ``img``: the batches, and one QAT step's losses and
    scales, equal those of the contiguous copy."""
    _, pred = predictors
    rng = np.random.RandomState(4)
    img = rng.uniform(-1, 1, (4, IMG, IMG)).astype(np.float32)[:, ::-1]
    jt = rng.uniform(-0.8, 0.8, (4, 14, 3)).astype(np.float32)
    view = {"img": img, "jt_uvd": jt}
    dense = {"img": np.ascontiguousarray(img), "jt_uvd": jt}
    (got,), (want,) = (qat._device_batches([b], "cpu")
                       for b in (view, dense))
    assert all(torch.equal(got[k], want[k]) for k in want)
    a, b = copy.deepcopy(pred), copy.deepcopy(pred)
    assert (a.quantize_qat([view], steps=1, lr=1e-5,
                           holdout_batches=[view])
            == b.quantize_qat([dense], steps=1, lr=1e-5,
                              holdout_batches=[dense]))
    assert a.qat_validation == b.qat_validation
    for k in b.quant:
        assert torch.equal(a.quant[k], b.quant[k]), k


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


# -------------------------------------------------- the crop's windows

# (u px, v px, z mm) centers of boxes cut by the left, right, top and
# bottom edges, one larger than the frame, one wholly outside it
EDGE_UVD = [(40, 240, 700), (610, 240, 700), (320, 20, 700),
            (320, 470, 700), (320, 240, 120), (-400, 240, 700)]


def _edge_frames(frames):
    """Six frames (the synthetic hands, repeated) with the centers of
    EDGE_UVD, in camera xyz mm."""
    imgs = np.resize(frames[0], (len(EDGE_UVD),) + frames[0].shape[1:])
    cfg = hourglass_config()
    return imgs, uvd2xyz_np(np.asarray(EDGE_UVD, np.float64), cfg.paras,
                            cfg.flip).astype(np.float64)


def _full_frame_predict(pred, imgs, centers_xyz):
    """``predict`` through the full frames' crop: the whole frames padded
    to the bucket, ``crop_normalize_batch``, the forward and decode, and
    the host's de-normalization."""
    B, bucket = len(imgs), pred._bucket(len(imgs))
    cubes = np.tile(np.asarray(pred.cfg.cube, np.float64), (B, 1))
    cu = xyz2uvd_np(centers_xyz, pred.paras, pred.flip)
    img_n, M = crop_normalize_batch(
        torch.from_numpy(pred._pad(np.ascontiguousarray(imgs), bucket)),
        pred._pad(cu, bucket), pred._pad(cubes, bucket),
        np.asarray(pred.paras), pred.cfg.img_size)
    out = pred._infer(img_n)[:B].numpy()
    return pred.denormalize(out, centers_xyz, M[:B], cubes)


@pytest.fixture(scope="module")
def resnet_predictor():
    cfg = resnet_config(img_size=IMG)
    model = torch_default_init_(build_model(cfg.net, cfg.jt_num,
                                            cfg.downsample),
                                torch.Generator().manual_seed(0))
    return Predictor(cfg, model, device="cpu")


@pytest.mark.parametrize("net", ["hourglass_1", "resnet_18"])
@pytest.mark.parametrize("kind", ["hands", "edges", "reversed"])
def test_predict_through_windows_equals_the_full_frame_crop(
        predictors, resnet_predictor, frames, net, kind):
    """``predict`` packs only the crop windows; its joints are those of
    the full frames' crop, bit for bit: the synthetic hands (3 frames, a
    bucket of 8), boxes cut by each edge, larger than the frame and
    wholly outside it, and a view reversed on both image axes."""
    pred = predictors[1] if net == "hourglass_1" else resnet_predictor
    imgs, _, centers = frames
    if kind == "edges":
        imgs, centers = _edge_frames(frames)
    elif kind == "reversed":
        imgs = imgs[:, ::-1, ::-1]
    got = pred.predict(imgs, centers)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, _full_frame_predict(pred, imgs,
                                                           centers))


def test_predict_packs_with_the_numpy_loop_without_a_compiler(
        predictors, frames, monkeypatch):
    """Where no host C++ compiler is found, the numpy loop packs the same
    windows: the same joints."""
    _, pred = predictors
    imgs, centers = _edge_frames(frames)
    want = pred.predict(imgs, centers)
    monkeypatch.setattr(windows.kernels, "host_compiler", lambda: None)
    windows._packer.cache_clear()
    try:
        assert windows._packer() is None
        np.testing.assert_array_equal(pred.predict(imgs, centers), want)
    finally:
        windows._packer.cache_clear()


def test_predictor_counts_raw_and_uploaded_pixels(predictors, frames):
    """``n_raw_px``: a call's bucket rows of whole frames; ``n_uploaded_px``:
    the pixels of its packed windows, the real rows' clipped boxes (the
    padding rows share the last one)."""
    pred = Predictor(predictors[1].cfg, predictors[1].model, device="cpu")
    assert (pred.n_raw_px, pred.n_uploaded_px) == (0, 0)
    imgs, centers = _edge_frames(frames)
    pred.predict(imgs, centers)
    cubes = np.tile(np.asarray(pred.cfg.cube, np.float64), (len(imgs), 1))
    p = crop_params_np(xyz2uvd_np(centers, pred.paras, pred.flip), cubes,
                       np.asarray(pred.paras), IMG)
    H0, W0 = imgs.shape[1:]
    clip = lambda s, e, n: max(0, min(e, n) - max(s, 0))  # noqa: E731
    areas = [clip(p["us"][i], p["ue"][i], W0) * clip(p["vs"][i], p["ve"][i],
                                                     H0)
             for i in range(len(imgs))]
    assert areas[-1] == 0 and areas[-2] == H0 * W0  # outside; larger
    assert pred.n_raw_px == 8 * H0 * W0
    assert pred.n_uploaded_px == sum(areas)
    assert pred.n_uploaded_px / pred.n_raw_px == sum(areas) / (8 * H0 * W0)


def test_raw_export_program_takes_full_frames(predictors, frames):
    """The exported raw program keeps its signature: whole (B, H0, W0)
    frames and the crop parameters, no windows; its joints are those of
    the Predictor's windowed ``predict`` within the float32 inverse's
    0.01 px."""
    _, pred = predictors
    imgs, _, centers = frames
    imgs = np.resize(imgs, (8,) + imgs.shape[1:])
    centers = np.resize(centers, (8, 3))
    prog = export.load(pred.export_program(8, raw_hw=imgs.shape[1:]),
                       device="cpu")
    assert prog.raw_hw == imgs.shape[1:]
    cubes = np.tile(np.asarray(pred.cfg.cube, np.float64), (8, 1))
    cu = xyz2uvd_np(centers, pred.paras, pred.flip)
    got = prog.call(imgs, crop_params_np(cu, cubes, np.asarray(pred.paras),
                                         IMG),
                    cu[:, 2].astype(np.float32),
                    cubes[:, 2].astype(np.float32)).numpy()
    np.testing.assert_allclose(got, pred.predict(imgs, centers), rtol=0,
                               atol=0.01)


# ------------------------------------------------ data mode over a mesh

MESH_IMG = 64
INT8_ATOL = 1e-3  # tests/test_torch_quant.py's, which says why


@pytest.fixture(scope="module")
def mesh_predictors():
    """resnet_18 at img 64, as tests/test_serving.py's mesh tests build
    it but with ``resnet_variables``' seeded weights (the flax init's
    N(0, 0.001) heads give near-constant joints): a maker of the JAX
    Predictor on ``make_mesh(8)``, the port's on eight CPU replicas, and
    a maker of the port's (one device without a mesh)."""
    from awr_tpu.config import Config as JaxConfig
    from awr_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from awr_tpu_torch.config import resnet_config
    from awr_tpu_torch.parallel import make_mesh

    jcfg = JaxConfig(net="resnet_18", kernel_size=1.0, img_size=MESH_IMG,
                     batch_size=8, vis_freq=0, use_pallas=False,
                     print_freq=1000)
    variables = resnet_variables(18, 2, MESH_IMG, seed=0)[1]
    cfg = resnet_config(18, img_size=MESH_IMG)

    def port(mesh=None):
        model = load_flax_variables(build_model("resnet_18", 14), variables)
        return Predictor(cfg, model, device=None if mesh else "cpu",
                         mesh=mesh)

    return (lambda: JaxPredictor(jcfg, variables, mesh=jax_make_mesh(8)),
            port(make_mesh(devices=["cpu"] * 8)), port)


def mesh_inputs():
    g = np.random.RandomState(7)
    return g.uniform(-1, 1, (12, MESH_IMG, MESH_IMG)).astype(np.float32)


def test_mesh_predictor_matches_jax_mesh_predictor(mesh_predictors):
    """12 frames over 8 replicas (bucket 16, two rows a replica) against
    the JAX Predictor on ``make_mesh(8)`` and the port's one-device
    Predictor, at tests/test_serving.py's mesh bar (rtol and atol
    1e-5); the replicas hold the same weights on their devices."""
    jax_p8, p8, port = mesh_predictors
    imgs = mesh_inputs()
    assert p8._bucket(12) == 16 and p8._bucket(3) == 8
    assert len(p8._replicas) == 8
    for _, model, _ in p8._replicas[1:]:
        for k, v in model.state_dict().items():
            assert torch.equal(v, p8.model.state_dict()[k]), k
    got = p8.predict_normalized(imgs)
    assert got.shape == (12, 14, 3)
    np.testing.assert_allclose(got, jax_p8().predict_normalized(imgs),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, port().predict_normalized(imgs),
                               rtol=1e-5, atol=1e-5)


def test_mesh_predict_matches_single_predictor(mesh_predictors, frames):
    """Raw frames through ``predict`` and ``predict_async`` on the mesh:
    each replica crops and infers its block; the joints are the
    one-device Predictor's (1e-5 relative, px and mm)."""
    _, p8, port = mesh_predictors
    imgs, _, centers = frames
    want = port().predict(imgs, centers)
    np.testing.assert_allclose(p8.predict(imgs, centers), want, rtol=1e-5)
    np.testing.assert_allclose(p8.predict_async(imgs, centers)(), want,
                               rtol=1e-5)


def test_mesh_int8_matches_jax_mesh_int8(mesh_predictors):
    """``quantize`` under the mesh calibrates once, on the first device:
    its scales are bit-equal to the one-device Predictor's and within
    1e-6 of the JAX mesh Predictor's, and every replica serves int8 with
    them.  The joints are the one-device int8 Predictor's within
    tests/test_serving.py's int8 bar for a mesh (rtol and atol 1e-4),
    and the JAX mesh Predictor's within the port's int8 bar against the
    JAX package (``INT8_ATOL``, 1e-3, tests/test_torch_quant.py: the two
    BatchNorms round differently and a code on a rounding boundary
    flips; measured 1.7e-4 here)."""
    import jax

    from awr_tpu_torch.models.quant import quant_layers
    from awr_tpu_torch.models.weights import load_flax_quant
    from awr_tpu_torch.parallel import make_mesh

    jax_make, _, port = mesh_predictors
    g = np.random.RandomState(3)
    calib = g.uniform(-1, 1, (8, MESH_IMG, MESH_IMG)).astype(np.float32)
    imgs = g.uniform(-1, 1, (12, MESH_IMG, MESH_IMG)).astype(np.float32)
    p8, p1, jax_p8 = port(make_mesh(devices=["cpu"] * 8)), port(), jax_make()
    p8.quantize(calib)
    p1.quantize(calib)
    jax_p8.quantize(calib)
    for k in p1.quant:
        assert torch.equal(p8.quant[k], p1.quant[k]), k
    jax_scales = load_flax_quant(build_model("resnet_18", 14),
                                 jax.device_get(jax_p8.quant))
    assert jax_scales.keys() == p8.quant.keys()
    for k, v in jax_scales.items():
        np.testing.assert_allclose(float(p8.quant[k]), float(v), rtol=1e-6,
                                   err_msg=k)
    assert len(p8._replicas) == 8
    for _, model, _ in p8._replicas:
        layers = quant_layers(model)
        assert {m.mode for m in layers.values()} == {"int8"}
        for k, m in layers.items():
            assert torch.equal(m.act_scale, p8.quant[k]), k
    got = p8.predict_normalized(imgs)
    np.testing.assert_allclose(got, p1.predict_normalized(imgs), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got, jax_p8.predict_normalized(imgs),
                               rtol=0, atol=INT8_ATOL)


def test_mesh_bucket_equals_jax_rule(mesh_predictors):
    """``_bucket`` under meshes of 1 to 8 devices equals the JAX
    Predictor's for every batch of 1 to 300 (8 devices take 12 frames to
    16; 6 take 1 to 12 and 9 to 18)."""
    import jax

    from awr_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from awr_tpu_torch.parallel import make_mesh

    jax_make, p8, _ = mesh_predictors
    jax_p = jax_make()
    for size in range(1, 9):
        p8.mesh = make_mesh(devices=["cpu"] * size) if size > 1 else None
        jax_p.mesh = jax_make_mesh(size) if size > 1 else None
        got = [p8._bucket(n) for n in range(1, 301)]
        assert got == [jax_p._bucket(n) for n in range(1, 301)], size
    p8.mesh = make_mesh(devices=["cpu"] * 8)
    assert jax.device_count() >= 8
    assert (p8._bucket(12), jax_p._bucket(12)) == (16, 16)


def test_batching_walks_the_mesh_buckets_jax_walks(mesh_predictors):
    """The port's ``BatchingPredictor`` over a 6-way mesh primes the
    buckets the JAX one walks over the JAX 6-way mesh Predictor's
    ``_bucket`` (12, 18, 36 up to 32 frames), serving real requests on
    the six replicas."""
    from types import SimpleNamespace

    from awr_tpu.batching import BatchingPredictor as JaxBatching
    from awr_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from awr_tpu_torch.batching import BatchingPredictor
    from awr_tpu_torch.parallel import make_mesh

    jax_make, _, port = mesh_predictors
    jax_p = jax_make()
    jax_p.mesh = jax_make_mesh(6)
    shim = SimpleNamespace(
        _bucket=jax_p._bucket, cfg=jax_p.cfg,
        predict_async=lambda imgs, centers, cubes=None: (
            lambda: np.zeros((len(imgs), 14, 3), np.float32)))
    with JaxBatching(shim, max_batch=32, max_wait_ms=0.0) as bp:
        seeded = bp.prime_service_model((60, 80), repeats=1)
        want = list(bp.prime_stats["per_bucket"])
    with BatchingPredictor(port(make_mesh(devices=["cpu"] * 6)),
                           max_batch=32, max_wait_ms=0.0) as bp:
        assert bp.prime_service_model((60, 80), repeats=1).keys() == \
            seeded.keys()
        got = list(bp.prime_stats["per_bucket"])
    assert got == want == [12, 18, 36]


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
