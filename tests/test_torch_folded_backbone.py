"""The inference form of the ResNet-deconv (``models/inference.py``) on
the CPU: its folding against the eval module in float64, its bf16 map and
joints against the JAX package's under the 2x rule, where
``Predictor`` serves through it and where not, and ``/healthz``'s
``folded_share``.  On one PyTorch thread at img 32."""

import io
import json
import urllib.request

import numpy as np
import pytest
import torch
import torch_bf16_reference as ref
from torch_bf16_reference import assert_within_twice, seeded_state
from torch_port_weights import one_thread  # noqa: F401

from awr_tpu_torch import export  # noqa: F401  (registers the ops)
from awr_tpu_torch.config import hourglass_config, resnet_config
from awr_tpu_torch.data.synthetic import synthetic_frames
from awr_tpu_torch.models import build_model, inference
from awr_tpu_torch.models.quant import quant_layers
from awr_tpu_torch.ops.decode import decode_offsets
from awr_tpu_torch.parallel.mesh import make_mesh, spatial_mesh
from awr_tpu_torch.server import AWRServer, folded_share
from awr_tpu_torch.serving import Predictor
from awr_tpu_torch.training.steps import make_infer_step

IMG = 32
J = 14
# the 2x rule's absolute bounds on max |port bf16 - JAX bf16|, those of
# tests/test_torch_bf16.py: a bf16 value carries 8 bits (a relative step
# of 0.0039), so maps of magnitude ~1 after a few dozen rounded layers
# differ by a few steps; joints are softmax(30 ht)-weighted means, where
# a map's rounding moves the weights by 30x its size
MAP_ATOL = 0.05
JOINT_ATOL = 0.15


def port_model(net, sd, dtype=None):
    model = build_model(net, J, compute_dtype=dtype)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                          strict=False)
    return model.eval()


def depth(n=2, seed=2):
    img = np.random.RandomState(seed).uniform(-1, 1, (n, IMG, IMG)).astype(
        np.float32)
    img[:, :4] = 1.0  # background rows for the decode's mask
    return img


@pytest.mark.parametrize("net", ["resnet_18", "resnet_50"])
def test_folding_is_exact_algebra_in_float64(net):
    """BasicBlock and Bottleneck, every conv's BatchNorm (stem, blocks,
    downsamples, deconvs) with seeded, non-trivial statistics: the form's
    map equals the eval module's within 1e-10 in float64, and leaves
    contiguous."""
    model = port_model(net, seeded_state(net, 3, "serve")).double()
    form = inference.FoldedResNetDeconv(model, torch.float64)
    x = torch.from_numpy(depth()).double()[:, None]
    with torch.no_grad():
        want, got = model(x), form(x)
    assert got.dtype == torch.float64 and got.is_contiguous()
    assert got.shape == want.shape == (2, 4 * J, IMG // 2, IMG // 2)
    assert float(want.abs().max()) > 0.01
    assert float((got - want).abs().max()) < 1e-10


def test_bf16_form_within_twice_the_jax_bf16_distance():
    """resnet_18's form in bf16: its map and the joints decoded from it
    lie within the 2x rule of the JAX package's bf16 result (absolute
    bounds above)."""
    sd = seeded_state("resnet_18", 3, "serve")
    img = depth()
    want = ref.forward({"resnet_18": sd}, img)
    form = inference.inference_form(port_model("resnet_18", sd,
                                               torch.bfloat16))
    x = torch.from_numpy(img)
    with torch.no_grad():
        out = form(x[:, None])
        joints = decode_offsets(out, x, 1.0)
    assert out.dtype == torch.float32 and out.is_contiguous()
    assert_within_twice(out.numpy().transpose(0, 2, 3, 1),
                        want[("map", "resnet_18", "bfloat16")],
                        want[("map", "resnet_18", "float32")], MAP_ATOL,
                        "form map")
    assert_within_twice(joints.numpy(),
                        want[("joints", "resnet_18", "bfloat16")],
                        want[("joints", "resnet_18", "float32")], JOINT_ATOL,
                        "form joints")


def test_form_compiles_as_one_graph():
    """The form's passes are custom ops with fake implementations, so
    ``torch.compile(fullgraph=True)`` traces its forward whole (no graph
    break at a kernel), and the compiled forward gives the eager map bit
    for bit (``aot_eager``: the same ops, no code generated)."""
    form = inference.inference_form(port_model(
        "resnet_18", seeded_state("resnet_18", 3, "serve"), torch.bfloat16))
    x = torch.from_numpy(depth())[:, None]
    compiled = torch.compile(form, backend="aot_eager", fullgraph=True)
    with torch.no_grad():
        assert torch.equal(compiled(x), form(x))


@pytest.fixture
def form_calls(monkeypatch):
    """The number of the inference form's forwards since the test began."""
    calls = []
    forward = inference.FoldedResNetDeconv.forward

    def counted(self, x):
        calls.append(len(x))
        return forward(self, x)

    monkeypatch.setattr(inference.FoldedResNetDeconv, "forward", counted)
    return calls


@pytest.fixture(scope="module")
def frames():
    imgs, _, centers = synthetic_frames(3, J, seed=11)
    return imgs, centers


def resnet_predictor(dtype="bfloat16", **kw):
    return Predictor(resnet_config(img_size=IMG, compute_dtype=dtype),
                     port_model("resnet_18", seeded_state(
                         "resnet_18", 4, "serve")), device="cpu", **kw)


def test_bf16_resnet_predictor_serves_through_the_form(form_calls, frames):
    """A resnet_18 bf16 Predictor on one device: every call runs the form
    (its bucket of 8 rows), ``n_folded_frames`` counts the real frames,
    the module keeps its float32 parameters, and the joints are those of
    the form's map."""
    pred = resnet_predictor()
    imgs, centers = frames
    got = pred.predict(imgs, centers)
    assert form_calls == [8]
    assert pred.n_folded_frames == pred.n_frames == 3
    pred.predict_normalized(depth(5))
    assert form_calls == [8, 8]
    assert pred.n_folded_frames == pred.n_frames == 8
    assert all(p.dtype == torch.float32 for p in pred.model.parameters())
    module = resnet_predictor()
    module._infer = make_infer_step(module.model, module.cfg)
    # camera px / mm: the joint bound times the crop's half-width (64 px)
    # and half-depth (150 mm), as tests/test_torch_bf16.py bounds them
    drift = np.abs(got - module.predict(imgs, centers)).max()
    assert 0 < drift < JOINT_ATOL * 150


def test_form_is_a_snapshot(frames):
    """A change to the module reaches the served forward only through
    ``_replicate``, which ``quantize`` and ``quantize_qat`` call."""
    pred = resnet_predictor()
    imgs, centers = frames
    before = pred.predict(imgs, centers)
    with torch.no_grad():
        pred.model.final1.bias.add_(0.5)
    np.testing.assert_array_equal(pred.predict(imgs, centers), before)
    pred._replicate()
    assert np.abs(pred.predict(imgs, centers) - before).max() > 0


def qat_batch():
    img = depth(4, seed=5)
    jt = np.random.RandomState(6).uniform(-0.8, 0.8, (4, J, 3)).astype(
        np.float32)
    return {"img": img, "jt_uvd": jt}


def _float32():
    return resnet_predictor("float32")


def _hourglass_bf16():
    cfg = hourglass_config(img_size=IMG, compute_dtype="bfloat16")
    return Predictor(cfg, port_model(cfg.net, seeded_state(
        cfg.net, 4, "serve")), device="cpu")


def _quantized():
    pred = resnet_predictor()
    pred.quantize(depth(8, seed=7))
    return pred


def _qat():
    pred = resnet_predictor()
    pred.quantize_qat([qat_batch()], steps=1, lr=1e-5)
    assert all(m.mode == "int8" for m in quant_layers(pred.model).values())
    return pred


def _data_mesh():
    return resnet_predictor(mesh=make_mesh(devices=["cpu"] * 2))


def _spatial_mesh():
    return resnet_predictor(mesh=spatial_mesh(devices=["cpu"] * 2))


@pytest.mark.parametrize("make", [_float32, _hourglass_bf16, _quantized,
                                  _qat, _data_mesh, _spatial_mesh],
                         ids=lambda f: f.__name__.strip("_"))
def test_these_predictors_do_not_engage_the_form(make, form_calls, frames):
    """float32; hourglass_1 in bf16; int8 after ``quantize`` or
    ``quantize_qat``; a data mesh; a spatial mesh: each serves the module
    as before, and ``n_folded_frames`` stays 0."""
    pred = make()
    imgs, centers = frames
    assert np.isfinite(pred.predict(imgs, centers)).all()
    pred.predict_normalized(depth(2))
    assert not pred._folded and form_calls == []
    assert pred.n_folded_frames == 0 and pred.n_frames == 5


def test_export_program_traces_the_module(form_calls, frames):
    """A folded Predictor's ``export_program`` traces ``self.model``:
    the program holds its BatchNorms, and the counter stays put."""
    pred = resnet_predictor()
    imgs, centers = frames
    pred.predict(imgs, centers)
    calls, folded = list(form_calls), pred.n_folded_frames
    program = pred.export_program(8)
    assert form_calls == calls and pred.n_folded_frames == folded == 3
    ops = {str(n.target) for n in torch.export.load(
        io.BytesIO(program)).graph.nodes if n.op == "call_function"}
    assert any("batch_norm" in op for op in ops), sorted(ops)


def test_healthz_reports_folded_share(frames):
    """``/healthz`` ``folded_share``: 0 before any call, 1 once a folded
    Predictor served; 0 for one that does not fold."""
    imgs, centers = frames

    def share_after(pred):
        with AWRServer(pred, port=0, max_batch=8).start() as srv:
            url = f"http://127.0.0.1:{srv.port}/healthz"
            with urllib.request.urlopen(url, timeout=60) as r:
                before = json.loads(r.read())["folded_share"]
            srv.batcher.predict_batch(imgs, centers)
            with urllib.request.urlopen(url, timeout=60) as r:
                return before, json.loads(r.read())["folded_share"]

    assert share_after(resnet_predictor()) == (0.0, 1.0)
    assert share_after(_float32()) == (0.0, 0.0)
    assert folded_share(object()) == 0.0
