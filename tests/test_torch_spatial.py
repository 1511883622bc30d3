"""Spatial (image-H) serving: the port's ``Predictor`` on a
``spatial_mesh`` against the JAX package's on the conftest's 8-device CPU
mesh, against its own one-device Predictor, and the pieces beneath it:
each layer kind run band by band against the whole layer (float64), the
row-window decode merged over bands against the full decode, the halo
rows gathered, the bucket rule, the ValueError of rows that do not
divide, int8, and a ``BatchingPredictor`` over it.  PyTorch on one
thread (``one_thread``)."""

import functools

import numpy as np
import pytest
import torch
from torch import nn
from torch_port_weights import random_variables, resnet_variables
from torch_port_weights import one_thread  # noqa: F401

from awr_tpu.config import Config as JaxConfig
from awr_tpu.parallel.mesh import spatial_mesh as jax_spatial_mesh
from awr_tpu.serving import Predictor as JaxPredictor
from awr_tpu_torch.config import hourglass_config, resnet_config
from awr_tpu_torch.data.device import crop_normalize_batch
from awr_tpu_torch.data.synthetic import synthetic_frames
from awr_tpu_torch.geometry import xyz2uvd_np
from awr_tpu_torch.models import build_model
from awr_tpu_torch.models.common import (ConvTranspose2d, max_pool,
                                         max_pool_torch, upsample_nearest_2x)
from awr_tpu_torch.models.quant import (QuantConv, QuantConvTranspose,
                                        set_int8)
from awr_tpu_torch.models.weights import load_flax_variables
from awr_tpu_torch.ops import library
from awr_tpu_torch.ops.functional import (merge_softmax_bands,
                                          offset2joint_softmax,
                                          offset2joint_softmax_rows,
                                          offset2joint_softmax_stats)
from awr_tpu_torch.parallel import (SPATIAL_AXIS, spatial_mesh,
                                    spatial_sharding)
from awr_tpu_torch.parallel.spatial import Banded, BandRunner, band_bounds
from awr_tpu_torch.serving import Predictor

MESHES = (2, 4, 8)
RESNET_IMG = 64  # tests/test_parallel.py's spatial test
HOURGLASS_IMG = 32  # F = 16: rows 16 -> 8 -> 4 -> 2 -> 1 in the hourglass
INT8_ATOL = 1e-3  # tests/test_torch_quant.py's, which says why


def cpu_mesh(n):
    return spatial_mesh(devices=["cpu"] * n)


# ------------------------------------------------ against the JAX package

def jax_test_image():
    """tests/test_parallel.py's spatial input: background with a
    uniform(-0.5, 0.5) square, one frame."""
    rng = np.random.RandomState(7)
    img = np.ones((1, RESNET_IMG, RESNET_IMG), np.float32)
    img[:, 16:48, 16:48] = rng.uniform(-0.5, 0.5, (1, 32, 32)).astype(
        np.float32)
    return img


@pytest.fixture(scope="module")
def nets():
    """By net: (JAX config, flax variables, port config, a maker of the
    port's Predictor: one device without a mesh)."""
    out = {}
    jcfg = JaxConfig(net="resnet_18", kernel_size=1.0, img_size=RESNET_IMG,
                     batch_size=8, vis_freq=0, use_pallas=False,
                     print_freq=1000)
    out["resnet_18"] = (jcfg, resnet_variables(18, 2, RESNET_IMG, seed=0)[1],
                        resnet_config(18, img_size=RESNET_IMG))
    jcfg = JaxConfig(net="hourglass_1", kernel_size=0.4,
                     img_size=HOURGLASS_IMG, batch_size=8, vis_freq=0,
                     use_pallas=False, print_freq=1000)
    out["hourglass_1"] = (jcfg, random_variables(1, seed=2)[1],
                          hourglass_config(img_size=HOURGLASS_IMG))

    def port(net, mesh=None):
        _, variables, cfg = out[net]
        model = load_flax_variables(build_model(cfg.net, cfg.jt_num),
                                    variables)
        return Predictor(cfg, model, device=None if mesh else "cpu",
                         mesh=mesh)

    return out, port


@functools.lru_cache(maxsize=None)
def _one_device(port, net):
    return port(net).predict_normalized(inputs(net))


def one_device(nets, net):
    """The port's one-device joints of ``inputs(net)``, computed once."""
    return _one_device(nets[1], net)


def inputs(net):
    if net == "resnet_18":
        return jax_test_image()
    g = np.random.RandomState(9)
    img = np.ones((3, HOURGLASS_IMG, HOURGLASS_IMG), np.float32)
    img[:, 6:30, 4:28] = g.uniform(-0.8, 0.8, (3, 24, 24))
    return img


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("net", ["resnet_18", "hourglass_1"])
def test_spatial_predictor_matches_jax_spatial_predictor(nets, net, n):
    """The port on ``spatial_mesh(devices=["cpu"] * n)`` against the JAX
    Predictor on ``spatial_mesh(n)`` and against the port's one device,
    at tests/test_parallel.py's bar (rtol and atol 1e-4).  resnet_18 at
    img 64 has 4 rows at its deepest level, hourglass_1 at img 32 has 1:
    on 8 bands most of those bands hold none."""
    table, port = nets
    jcfg, variables, _ = table[net]
    img = inputs(net)
    pred = port(net, cpu_mesh(n))
    assert pred._spatial and len(pred._replicas) == n
    got = pred.predict_normalized(img)
    want = JaxPredictor(jcfg, variables,
                        mesh=jax_spatial_mesh(n)).predict_normalized(img)
    assert got.shape == want.shape == (len(img), 14, 3)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, one_device(nets, net), rtol=1e-4,
                               atol=1e-4)
    # the halo exchange happened (the JAX test's collective-permute), and
    # no band gathered more than the widest window's reach (the 5x5 stem:
    # two rows each side), so none gathered a whole tensor of its 16 or
    # more rows
    gathered = pred._infer.runner.gathered
    assert sum(map(sum, gathered.values())) > 0
    assert max(map(max, gathered.values())) <= 4


@pytest.mark.parametrize("net", ["resnet_18", "hourglass_1"])
def test_spatial_predict_matches_one_device(nets, net):
    """Raw frames through ``predict`` and ``predict_async``: the first
    device crops, the bands infer; the joints are the one-device
    Predictor's, within 1e-5 normalized on the frames' crops and 1e-5
    relative in camera px and mm (the data mode's bar)."""
    table, port = nets
    cfg = table[net][2]
    imgs, _, centers = synthetic_frames(3, 14, seed=11)
    one, pred = port(net), port(net, cpu_mesh(4))
    crops, _ = crop_normalize_batch(
        torch.from_numpy(imgs), xyz2uvd_np(centers, cfg.paras, cfg.flip),
        np.tile(cfg.cube, (3, 1)), cfg.paras, cfg.img_size)
    np.testing.assert_allclose(pred.predict_normalized(crops.numpy()),
                               one.predict_normalized(crops.numpy()),
                               rtol=0, atol=1e-5)
    want = one.predict(imgs, centers)
    for got in (pred.predict(imgs, centers),
                pred.predict_async(imgs, centers)()):
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_spatial_bucket_equals_jax_rule(nets):
    """No mesh rounding in spatial mode (JAX ``serving.py:347``): 1 -> 8,
    9 -> 16 on 8 bands; the same buckets as the JAX spatial Predictor
    for every batch of 1 to 300 on meshes of 2 to 8."""
    table, port = nets
    jcfg, variables, _ = table["resnet_18"]
    jax_p = JaxPredictor(jcfg, variables, mesh=jax_spatial_mesh(8))
    pred = port("resnet_18", cpu_mesh(8))
    assert (pred._bucket(1), pred._bucket(9)) == (8, 16)
    for size in range(2, 9):
        pred.mesh = cpu_mesh(size)
        assert ([pred._bucket(n) for n in range(1, 301)]
                == [jax_p._bucket(n) for n in range(1, 301)]), size


def test_rows_that_do_not_divide_raise(nets):
    """64 rows over 3 bands: ``ValueError``, as ``jax.device_put`` onto
    ``P(None, "spatial")`` raises; the mesh and its sharding."""
    _, port = nets
    mesh = cpu_mesh(3)
    assert mesh.axis_name == SPATIAL_AXIS
    with pytest.raises(ValueError, match="does not split"):
        spatial_sharding(mesh).put(torch.zeros(1, 64, 64))
    assert [t.shape[1] for t in spatial_sharding(cpu_mesh(4)).put(
        torch.zeros(1, 64, 64))] == [16] * 4
    with pytest.raises(ValueError, match="does not split"):
        port("resnet_18", mesh).predict_normalized(jax_test_image())


def test_spatial_int8_matches_one_device_int8(nets):
    """``quantize`` under a spatial mesh calibrates on the first device:
    the scales are bit-equal to the one-device Predictor's (which
    tests/test_torch_quant.py holds to the JAX package's), and every band
    replica serves int8 with them; the joints are the one-device int8
    Predictor's within ``INT8_ATOL``.  The JAX spatial int8 step is no
    reference here: it does not compile on the CPU mesh (XLA's HLO
    verifier rejects an s8 broadcast in ``layer4_0/conv2``)."""
    from awr_tpu_torch.models.quant import quant_layers

    _, port = nets
    g = np.random.RandomState(3)
    calib = g.uniform(-1, 1, (8, RESNET_IMG, RESNET_IMG)).astype(np.float32)
    imgs = g.uniform(-1, 1, (3, RESNET_IMG, RESNET_IMG)).astype(np.float32)
    pred, one = port("resnet_18", cpu_mesh(4)), port("resnet_18")
    for p in (pred, one):
        p.quantize(calib)
    for k in one.quant:
        assert torch.equal(pred.quant[k], one.quant[k]), k
    for _, model, _ in pred._replicas:
        for k, m in quant_layers(model).items():
            assert m.mode == "int8" and torch.equal(m.act_scale,
                                                    pred.quant[k]), k
    assert pred._infer.runner.models[3] is pred._replicas[3][1]
    np.testing.assert_allclose(pred.predict_normalized(imgs),
                               one.predict_normalized(imgs), rtol=0,
                               atol=INT8_ATOL)


def test_spatial_quantize_qat_serves_every_band_in_int8(nets):
    """``quantize_qat`` under a spatial mesh fine-tunes on the first
    device, as the one-device Predictor does (the same losses), and every
    band replica then serves the kept weights in int8 with its scales:
    the joints are the one-device Predictor's within ``INT8_ATOL``."""
    from awr_tpu_torch.models.quant import quant_layers

    _, port = nets
    g = np.random.RandomState(6)
    img = inputs("hourglass_1")
    tune = {"img": img, "jt_uvd": g.uniform(-0.8, 0.8, (len(img), 14, 3))
            .astype(np.float32)}
    pred, one = port("hourglass_1", cpu_mesh(2)), port("hourglass_1")
    losses = [p.quantize_qat([tune], steps=1, lr=1e-5) for p in (pred, one)]
    assert losses[0] == losses[1]
    for _, model, _ in pred._replicas:
        for k, m in quant_layers(model).items():
            assert m.mode == "int8" and torch.equal(m.act_scale,
                                                    pred.quant[k]), k
        for k, v in model.state_dict().items():
            assert torch.equal(v, pred.model.state_dict()[k]), k
    np.testing.assert_allclose(pred.predict_normalized(img),
                               one.predict_normalized(img), rtol=0,
                               atol=INT8_ATOL)


def test_batching_over_spatial_mesh(nets):
    """A ``BatchingPredictor`` over a spatial Predictor gives ``predict``'s
    joints (JAX ``tests/test_batching.py:135``)."""
    from awr_tpu_torch.batching import BatchingPredictor

    _, port = nets
    pred = port("hourglass_1", cpu_mesh(4))
    imgs, _, centers = synthetic_frames(4, 14, seed=5)
    want = pred.predict(imgs, centers)
    with BatchingPredictor(pred, max_batch=8, max_wait_ms=50.0) as bp:
        futs = [bp.submit(imgs[i], centers[i]) for i in range(4)]
        got = np.stack([f.result(timeout=120) for f in futs])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


# ------------------------------------------------ the band runner's layers

class Upsample(nn.Module):
    def forward(self, x):
        return upsample_nearest_2x(x)


class Pointwise(nn.Module):
    """The ops that run band by band with no exchange: eval BatchNorm,
    ReLU, a skip add, a channel cat, a cast and ``contiguous``."""

    def __init__(self):
        super().__init__()
        self.bn = nn.BatchNorm2d(3).eval()
        with torch.no_grad():
            self.bn.running_mean.uniform_(-1, 1)
            self.bn.running_var.uniform_(0.5, 2)
        self.relu = nn.ReLU()

    def forward(self, x):
        y = self.relu(self.bn(x)) + x
        return torch.cat([y, torch.relu(x).to(torch.float64)], 1).contiguous()


def layer(kind):
    """(module, channels in): each kind of the two backbones' layers."""
    g = torch.Generator().manual_seed(0)
    quant = kind.startswith("int8")
    conv = QuantConv if quant else nn.Conv2d
    mods = {
        "conv5x5": lambda: conv(3, 4, 5, 1, 2),
        "conv3x3": lambda: conv(3, 4, 3, 1, 1),
        "conv3x3_s2": lambda: conv(3, 4, 3, 2, 1, bias=False),
        "conv1x1_s2": lambda: conv(3, 4, 1, 2, 0, bias=False),
        "conv1x1": lambda: conv(3, 4, 1),
        "pool2x2": max_pool,
        "pool3x3_s2": lambda: max_pool_torch(3, 2, 1),
        "deconv": lambda: (QuantConvTranspose if quant else ConvTranspose2d)(
            3, 4, 4, 2, 1, bias=False),
        "upsample": Upsample,
        "pointwise": Pointwise,
    }
    m = mods[kind.replace("int8_", "")]()
    for p in m.parameters():
        with torch.no_grad():
            p.copy_(torch.rand(p.shape, generator=g) * 2 - 1)
    return nn.Sequential(m).eval()


KINDS = ["conv5x5", "conv3x3", "conv3x3_s2", "conv1x1_s2", "conv1x1",
         "pool2x2", "pool3x3_s2", "deconv", "upsample", "pointwise"]
# heights: fewer rows than bands (empty bands), odd, even
HEIGHTS = (3, 7, 16)


def run_banded(model, x, n):
    runner = BandRunner(cpu_mesh(n), [model] * n)
    bounds = band_bounds(x.shape[-2], n)
    out = runner(Banded([x[..., a:b, :] if b > a else None for a, b in
                         zip(bounds, bounds[1:])], x.shape[-2]))
    assert len(out.parts) == n
    assert [p is None for p in out.parts] == [
        a == b for a, b in zip(band_bounds(out.H, n),
                               band_bounds(out.H, n)[1:])]
    return torch.cat([p for p in out.parts if p is not None], -2), runner


@pytest.mark.parametrize("kind", KINDS)
def test_banded_layer_equals_whole_layer(kind):
    """Each layer kind band by band equals the whole layer in float64 to
    1e-12, over 1 to 8 bands and heights with empty bands; the max pools
    pad with -inf (an all-negative input shows it)."""
    model = layer(kind).double()
    g = torch.Generator().manual_seed(1)
    for H in HEIGHTS:
        x = torch.rand((2, 3, H, 6), generator=g, dtype=torch.float64) - 0.5
        if kind.startswith("pool"):
            x = x - 1.0
        want = model(x)
        for n in range(1, 9):
            got, _ = run_banded(model, x, n)
            assert got.shape == want.shape, (H, n)
            torch.testing.assert_close(got, want, rtol=0, atol=1e-12,
                                       msg=f"H={H} n={n}")


@pytest.mark.parametrize("kind", ["int8_conv3x3_s2", "int8_conv5x5",
                                  "int8_deconv"])
def test_banded_int8_layer_equals_whole_layer(kind):
    """The int8 conv (im2col + the int8 GEMM) and deconv (the polyphase
    int8 deconv) on each band's slab: bit-equal to the whole layer."""
    model = layer(kind)
    set_int8(model, {"0": torch.tensor(0.004)})
    g = torch.Generator().manual_seed(2)
    x = torch.rand((2, 3, 12, 8), generator=g) - 0.5
    want = model(x)
    for n in (2, 5, 8):
        got, _ = run_banded(model, x, n)
        assert torch.equal(got, want), n


def test_halo_rows_are_the_windows_not_whole_tensors():
    """Each band of a 3x3 s1 conv gathers one row from each neighbour,
    the 5x5 stem two, a 1x1 conv none, the deconv one input row each
    side; where bands are at least as tall as the window no band gathers
    more than the window's reach, so none gathers a whole tensor."""
    g = torch.Generator().manual_seed(3)
    x = torch.rand((1, 3, 32, 4), generator=g, dtype=torch.float64)
    reach = {"conv3x3": 1, "conv5x5": 2, "conv1x1": 0, "conv3x3_s2": 1,
             "pool3x3_s2": 1, "pool2x2": 0, "deconv": 1, "upsample": 1}
    for kind, r in reach.items():
        _, runner = run_banded(layer(kind).double(), x, 4)
        (rows,) = runner.gathered.values()
        inner = rows[1:-1]
        assert max(rows) <= 2 * r and max(rows) < 8, (kind, rows)
        if kind in ("conv3x3", "conv5x5"):
            assert inner == [2 * r, 2 * r] and rows[0] == rows[-1] == r
        if r == 0:
            assert rows == [0, 0, 0, 0], kind


def test_unknown_node_raises():
    """A node the runner has no rule for raises, whole-tensor fallback
    nowhere: a reshape, a Linear, training-mode BatchNorm, a cat along
    the rows."""

    class Reshape(nn.Module):
        def forward(self, x):
            return x.reshape(x.shape[0], -1)

    class RowCat(nn.Module):
        def forward(self, x):
            return torch.cat([x, x], dim=2)

    x = Banded([torch.zeros(1, 3, 2, 4)] * 2, 4)
    for model in (Reshape(), nn.Sequential(nn.Linear(4, 4)), RowCat(),
                  nn.Sequential(nn.BatchNorm2d(3).train())):
        with pytest.raises(NotImplementedError, match="spatial bands"):
            BandRunner(cpu_mesh(2), [model] * 2)(x)


# ------------------------------------------------ the row-window decode

def decode_inputs(dtype, B=3, F=16, H=32, J=14):
    g = np.random.RandomState(4)
    img = np.ones((B, H, H))
    fg = img[:, H // 5:, H // 8:H - H // 8]
    fg[...] = g.uniform(-1, 0.95, fg.shape)
    img[0] = 1.0  # an all-background frame
    off = g.randn(B, 4 * J, F, F) * 0.3
    return (torch.from_numpy(off).to(dtype),
            torch.from_numpy(img).to(dtype))


@pytest.mark.parametrize("dtype,atol", [(torch.float64, 1e-12),
                                        (torch.float32, 1e-6)])
def test_row_windows_merged_equal_the_full_decode(dtype, atol):
    """The plain row-window decode of n bands (1 to 8, some with fewer
    map rows than bands would give), each reading only its depth rows,
    merged: the full decode and its statistics."""
    off, img = decode_inputs(dtype)
    F, S = off.shape[2], img.shape[1]
    want = offset2joint_softmax(off, img, 0.4)
    want_stats = offset2joint_softmax_stats(off, img)
    for n in range(1, 9):
        parts = []
        bounds = band_bounds(F, n)
        for r0, r1 in zip(bounds, bounds[1:]):
            i0, i1 = (r0 * S) // F, ((r1 - 1) * S) // F + 1
            parts.append(offset2joint_softmax_rows(
                off[:, :, r0:r1], img[:, i0:i1], 0.4, r0, i0, S))
        got, stats = merge_softmax_bands(parts)
        torch.testing.assert_close(got, want, rtol=0, atol=atol)
        torch.testing.assert_close(stats[..., 0], want_stats[..., 0],
                                   rtol=0, atol=0)
        torch.testing.assert_close(stats[..., 1], want_stats[..., 1],
                                   rtol=atol, atol=0)


def test_row_window_of_the_whole_map_is_the_decode():
    """Rows [0, F) with the whole depth: the decode and its statistics
    bit for bit; a window whose depth rows are not given raises."""
    off, img = decode_inputs(torch.float32)
    out, stats = offset2joint_softmax_rows(off, img, 0.4, 0)
    assert torch.equal(out, offset2joint_softmax(off, img, 0.4))
    assert torch.equal(stats, offset2joint_softmax_stats(off, img))
    with pytest.raises(ValueError, match="outside"):
        offset2joint_softmax_rows(off[:, :, 8:], img[:, 16:24], 0.4, 8, 16,
                                  32)


def test_decode_rows_op_passes_opcheck():
    """``awr_tpu_torch::decode_rows``: its schema, fake implementation and
    dispatch (``torch.library.opcheck``; no gradient is registered: it
    serves only), and its CPU result is the plain window decode."""
    off, img = decode_inputs(torch.float32, B=2, F=8, H=16)
    args = (off[:, :, 2:5].contiguous(), img[:, 4:10].contiguous(), 0.4, 2,
            4, 16)
    torch.library.opcheck(library.decode_rows, args,
                          test_utils=("test_schema", "test_faketensor"))
    out, stats = library.decode_rows(*args)
    want = offset2joint_softmax_rows(*args)
    assert torch.equal(out, want[0]) and torch.equal(stats, want[1])
