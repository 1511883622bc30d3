"""The port's int8 path against the JAX package's: the plain int8 kernels
against ``awr_tpu.ops.pallas_int8`` (interpret mode), the quant modules
against ``awr_tpu.models.quant`` on identical operands (mode "qat" with
its gradients too), calibration, and ``Predictor.quantize`` end to end on
both backbones.

Bars: the integer functions and the modules are exact (the modules to 1
float32 ulp) on the same int8 operands.  Across a whole net the two
sides' float layers (BatchNorm, adds) differ in the last bits, and a code
sitting on a rounding boundary then flips by one step; so the net is held
to a stated tolerance instead."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch_port_weights import flax_variables, resnet_variables
from torch_port_weights import one_thread  # noqa: F401

from awr_tpu.config import hourglass_config as jax_hourglass_config
from awr_tpu.config import resnet_config as jax_resnet_config
from awr_tpu.models import build_model as jax_build_model
from awr_tpu.models import quant as jq
from awr_tpu.ops.pallas_int8 import deconv4x4s2_int8 as jax_deconv
from awr_tpu.ops.pallas_int8 import int8_matmul as jax_int8_matmul
from awr_tpu.ops.pallas_int8 import prep_deconv_weights as jax_prep
from awr_tpu.serving import Predictor as JaxPredictor
from awr_tpu_torch.config import hourglass_config, resnet_config
from awr_tpu_torch.data.device import crop_normalize_batch
from awr_tpu_torch.data.synthetic import synthetic_frames
from awr_tpu_torch.geometry import xyz2uvd_np
from awr_tpu_torch.config import DTYPES
from awr_tpu_torch.models import build_model
from awr_tpu_torch.models import quant
from awr_tpu_torch.models.weights import (load_flax_quant,
                                          load_flax_variables,
                                          load_reference_state_dict)
from awr_tpu_torch.ops import int8
from awr_tpu_torch.serving import Predictor

IMG = 32


def codes(rng, shape):
    return rng.randint(-127, 128, shape).astype(np.int8)


# --- the plain int8 kernels against the Pallas kernels (interpret mode)

@pytest.mark.parametrize("M,K,N", [(256, 64, 32), (128, 25, 16)])
def test_int8_matmul_matches_pallas(M, K, N):
    rng = np.random.RandomState(K)
    a, b = codes(rng, (M, K)), codes(rng, (K, N))
    want = np.asarray(jax_int8_matmul(jnp.asarray(a), jnp.asarray(b),
                                      tile_m=128, interpret=True))
    got = int8.int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_prep_deconv_weights_matches_jax():
    """The tap map applies to the ConvTranspose2d weight's kh/kw axes: the
    port's (C_in, C_out, 4, 4) weight is the flax (4, 4, C_out, C_in)
    kernel permuted (3, 2, 0, 1)."""
    wq = codes(np.random.RandomState(3), (4, 4, 5, 7))
    want = np.asarray(jax_prep(jnp.asarray(wq)))
    got = int8.prep_deconv_weights(torch.from_numpy(wq.transpose(3, 2, 0, 1)))
    assert got.shape == (4, 4 * 7, 5)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("B,H,W,cin,cout", [
    (2, 4, 4, 8, 16), (1, 8, 6, 16, 8), (3, 5, 7, 8, 8),
    (1, 2, 3, 512, 8),  # the width of resnet_18's first deconv
])
def test_deconv_matches_pallas(B, H, W, cin, cout):
    rng = np.random.RandomState(B * 100 + H)
    xq, wq = codes(rng, (B, H, W, cin)), codes(rng, (4, 4, cout, cin))
    scale = rng.uniform(0.5, 2.0, (cout,)).astype(np.float32)
    want = np.asarray(jax_deconv(jnp.asarray(xq), jnp.asarray(wq),
                                 jnp.asarray(scale), out_dtype=jnp.float32,
                                 interpret=True))  # (B, 2H, 2W, C_out)
    got = int8.deconv4x4s2_int8(torch.from_numpy(xq),
                                torch.from_numpy(wq.transpose(3, 2, 0, 1)),
                                torch.from_numpy(scale))
    assert got.shape == (B, cout, 2 * H, 2 * W) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want.transpose(0, 3, 1, 2))


def test_int8_plain_versions_check_their_inputs():
    a = torch.zeros(4, 3, dtype=torch.int8)
    with pytest.raises(TypeError):
        int8.int8_matmul(a.float(), a.t())
    with pytest.raises(ValueError):
        int8.int8_matmul(a, a)
    with pytest.raises(ValueError):
        int8.deconv4x4s2_int8(torch.zeros(1, 2, 2, 3, dtype=torch.int8),
                              torch.zeros(4, 5, 4, 4, dtype=torch.int8),
                              torch.ones(5))


# --- quantizers and the quant modules against awr_tpu.models.quant

def test_quantizers_match_jax():
    rng = np.random.RandomState(0)
    x = (rng.randn(2, 6, 5, 7) * 3).astype(np.float32)
    s = np.float32(0.0371)
    want, _ = jq._quantize_acts(jnp.asarray(x), jnp.asarray(s))
    got, _ = quant._quantize_acts(torch.from_numpy(x), torch.tensor(s))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want, np.float32))
    k = (rng.randn(3, 3, 7, 11) * 0.1).astype(np.float32)  # flax HWIO
    wq, ws = jq._quantize_weights(jnp.asarray(k), (0, 1, 2))
    pq, ps = quant._quantize_weights(
        torch.from_numpy(k.transpose(3, 2, 0, 1)), (1, 2, 3))
    np.testing.assert_array_equal(pq.numpy(), np.asarray(
        wq, np.float32).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(ps.numpy().reshape(-1),
                                  np.asarray(ws).reshape(-1))


def _port_conv(kernel_hwio, stride, pad, scale):
    kh, _, cin, cout = kernel_hwio.shape
    m = quant.QuantConv(cin, cout, kh, stride, pad, bias=False)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(kernel_hwio.transpose(3, 2, 0, 1)))
        m.act_scale.fill_(float(scale))
    m.mode = "int8"
    return m


# (kernel, stride, C_in, C_out): the stem, a 3x3, a strided 3x3, a
# strided 1x1 downsample
CONVS = [(5, 1, 1, 16), (3, 1, 8, 16), (3, 2, 16, 8), (1, 2, 8, 16)]


@pytest.mark.parametrize("k,stride,cin,cout", CONVS)
def test_quant_conv_matches_jax(k, stride, cin, cout):
    rng = np.random.RandomState(k * 10 + stride)
    x = rng.uniform(-1, 1, (2, 9, 10, cin)).astype(np.float32)
    kern = (rng.randn(k, k, cin, cout) * 0.2).astype(np.float32)
    scale = np.float32(0.9 / 127)
    pad = (k - 1) // 2
    jmod = jq.QuantConv(cout, (k, k), strides=(stride, stride),
                        padding=((pad, pad), (pad, pad)), mode="int8")
    want = np.asarray(jmod.apply({"params": {"kernel": kern},
                                  "quant": {"act_scale": scale}},
                                 jnp.asarray(x)))
    with torch.no_grad():
        got = _port_conv(kern, stride, pad, scale)(
            torch.from_numpy(x.transpose(0, 3, 1, 2)))
    np.testing.assert_array_max_ulp(got.numpy(), want.transpose(0, 3, 1, 2),
                                    maxulp=1)


def test_quant_conv_transpose_matches_jax():
    rng = np.random.RandomState(5)
    x = rng.uniform(-1, 1, (2, 6, 5, 16)).astype(np.float32)
    kern = (rng.randn(4, 4, 8, 16) * 0.1).astype(np.float32)  # (kh,kw,out,in)
    scale = np.float32(0.8 / 127)
    jmod = jq.QuantConvTranspose(8, mode="int8")
    want = np.asarray(jmod.apply({"params": {"kernel": kern},
                                  "quant": {"act_scale": scale}},
                                 jnp.asarray(x)))
    m = quant.QuantConvTranspose(16, 8, 4, 2, 1, bias=False)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(kern.transpose(3, 2, 0, 1)))
        m.act_scale.fill_(float(scale))
        m.mode = "int8"
        got = m(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    np.testing.assert_array_max_ulp(got.numpy(), want.transpose(0, 3, 1, 2),
                                    maxulp=1)


# --- mode "qat" against the JAX package's, forward and gradients

# (layer, input scale): a 3x3 conv whose calibrated scale clips about 40 %
# of the input codes at +-127, a 5x5 stem-like conv and the deconv with a
# zero stored scale (the batch's max|x| / 127)
QAT_LAYERS = [("conv3", 0.6), ("conv5", 0.0), ("deconv", 0.5),
              ("deconv", 0.0)]
# Relative to each tensor's max |value|.  Both sides form the same
# float32 codes and scales (the quantizers are bit-equal) and convolve
# them in float32 in another summation order: measured 1.3e-7 at most
# (forward, input and weight gradients).  bfloat16 output: the same
# float32 conv rounded once to bfloat16, where a sum within its float32
# roundoff of a rounding boundary rounds the other way: one bfloat16 ulp,
# 2**-8 of the value.
QAT_RTOL_OF_MAX = {"float32": 1e-5, "bfloat16": 2.0 ** -8}


def _qat_layers(kind, rng, dtype):
    """(JAX module, params, port module, NHWC input): seeded operands."""
    if kind == "deconv":
        kern = (rng.randn(4, 4, 8, 16) * 0.1).astype(np.float32)
        jmod = jq.QuantConvTranspose(8, mode="qat", dtype=dtype)
        m = quant.QuantConvTranspose(16, 8, 4, 2, 1, bias=False)
        params = {"kernel": kern}
        w = kern.transpose(3, 2, 0, 1)
        cin = 16
    else:
        k, cin = (3, 8) if kind == "conv3" else (5, 1)
        kern = (rng.randn(k, k, cin, 16) * 0.2).astype(np.float32)
        bias = (rng.randn(16) * 0.1).astype(np.float32)
        jmod = jq.QuantConv(16, (k, k), padding=((k // 2,) * 2,) * 2,
                            use_bias=True, mode="qat", dtype=dtype)
        m = quant.QuantConv(cin, 16, k, 1, k // 2)
        params = {"kernel": kern, "bias": bias}
        w = kern.transpose(3, 2, 0, 1)
        with torch.no_grad():
            m.bias.copy_(torch.from_numpy(bias))
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(w))
    x = rng.uniform(-1, 1, (2, 7, 9, cin)).astype(np.float32)
    return jmod, params, m, x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,scale", QAT_LAYERS)
def test_qat_modules_match_jax(kind, scale, dtype):
    """Forward, input and weight gradients of one layer in mode "qat":
    the straight-through gradient is 1 at every input element, those
    clipped at +-127 codes too (the JAX ``_ste`` has no clip mask), and
    the layer leaves the caller's TF32 setting as it found it."""
    rng = np.random.RandomState(len(kind) * 10 + int(scale * 10))
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    jmod, params, m, x = _qat_layers(kind, rng, jdt)
    s = np.float32(scale * np.abs(x).max() / 127)
    y_shape = jax.eval_shape(lambda: jmod.apply(
        {"params": params, "quant": {"act_scale": s}}, jnp.asarray(x))).shape
    g = rng.randn(*y_shape).astype(np.float32)

    def f(xx, kk):
        p = dict(params, kernel=kk)
        return jmod.apply({"params": p, "quant": {"act_scale": s}}, xx)
    y, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(params["kernel"]))
    gx, gk = vjp(jnp.asarray(g, y.dtype))

    m.compute_dtype = DTYPES[dtype]
    m.mode = "qat"
    with torch.no_grad():
        m.act_scale.fill_(float(s))
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2)).requires_grad_()
    torch.backends.cudnn.allow_tf32 = True
    try:
        got = m(xt)
        got.backward(torch.from_numpy(g.transpose(0, 3, 1, 2)).to(got.dtype))
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = False
    assert got.dtype == DTYPES[dtype]
    perm = (3, 2, 0, 1)
    rtol = QAT_RTOL_OF_MAX[dtype]
    for name, a, b in (
            ("forward", got.detach().float().numpy(),
             np.asarray(y, np.float32).transpose(0, 3, 1, 2)),
            ("input grad", xt.grad.numpy(),
             np.asarray(gx, np.float32).transpose(0, 3, 1, 2)),
            ("weight grad", m.weight.grad.numpy(),
             np.asarray(gk, np.float32).transpose(perm))):
        scale_ = np.abs(b).max()
        assert scale_ > 0, name
        np.testing.assert_allclose(a, b, rtol=0, atol=rtol * scale_,
                                   err_msg=name)
    # the clipped inputs get the gradient of the identity too
    s_in = s if s > 0 else np.abs(x).max() / 127
    clipped = (np.abs(x) / s_in > 127.5).transpose(0, 3, 1, 2)
    assert clipped.any() == (scale > 0)
    if clipped.any():
        assert np.abs(xt.grad.numpy()[clipped]).max() > 0


@pytest.mark.parametrize("k,stride,cin,cout", CONVS)
def test_int8_conv_wiring(monkeypatch, k, stride, cin, cout):
    """im2col -> int8 GEMM -> dequant, the GEMM recorded and run by its
    plain version, against a float64 direct conv of the same codes:
    exact.  The GEMM's B is the transposed view of the contiguous (C_out,
    K) weight, which the CUDA wrapper takes without a copy."""
    calls = []

    def gemm(a, b):
        calls.append((a.dtype, tuple(a.shape), a.is_contiguous(),
                      b.t().is_contiguous(), tuple(b.shape)))
        return int8.int8_matmul(a, b)

    monkeypatch.setattr(quant, "_int8_matmul", gemm)
    rng = np.random.RandomState(k + cin)
    x = torch.from_numpy(rng.uniform(-1, 1, (2, cin, 11, 9)).astype(np.float32))
    kern = (rng.randn(k, k, cin, cout) * 0.2).astype(np.float32)
    pad = (k - 1) // 2
    m = _port_conv(kern, stride, pad, 1.0 / 127)
    with torch.no_grad():
        got = m(x)
    xq, s_in = quant._quantize_acts(x, m.act_scale)
    wq, s_w = quant._quantize_weights(m.weight, (1, 2, 3))
    acc = F.conv2d(xq.double(), wq.double(), stride=stride, padding=pad)
    want = acc.float() * (s_in * s_w.view(1, -1, 1, 1))
    assert torch.equal(got, want)
    oh, ow = want.shape[2:]
    assert calls == [(torch.int8, (2 * oh * ow, cin * k * k), True, True,
                      (cin * k * k, cout))]


def test_int8_deconv_wiring(monkeypatch):
    """The deconv gets contiguous NHWC int8 codes, the int8 weight,
    ``s_in * s_w`` and the output dtype (float32 without a compute
    dtype); the result is a float64 conv_transpose of the codes."""
    calls = []

    def deconv(xq, wq, scale, out_dtype):
        calls.append((xq.dtype, xq.is_contiguous(), tuple(xq.shape),
                      wq.dtype, out_dtype))
        return int8.deconv4x4s2_int8(xq, wq, scale, out_dtype)

    monkeypatch.setattr(quant, "_int8_deconv", deconv)
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.uniform(-1, 1, (2, 16, 5, 6)).astype(np.float32))
    m = quant.QuantConvTranspose(16, 8, 4, 2, 1, bias=False)
    with torch.no_grad():
        m.weight.normal_(0, 0.1, generator=torch.Generator().manual_seed(0))
        m.act_scale.fill_(1.0 / 127)
        m.mode = "int8"
        got = m(x)
    xq, s_in = quant._quantize_acts(x, m.act_scale)
    wq, s_w = quant._quantize_weights(m.weight, (0, 2, 3))
    want = (F.conv_transpose2d(xq.double(), wq.double(), stride=2, padding=1)
            .float() * (s_in * s_w.view(1, -1, 1, 1)))
    assert torch.equal(got, want)
    assert calls == [(torch.int8, True, (2, 5, 6, 16), torch.int8,
                      torch.float32)]


@pytest.mark.parametrize("n", [1, 2, 10001, 99991])
def test_calib_amax_matches_jnp_percentile(n):
    """Against ``jnp.percentile`` under ``jit``, as the JAX ``calibrate``
    runs it (op by op, JAX forms the float32 rank differently, which on
    a heavy tail picks another pair of neighbours)."""
    x = np.random.RandomState(n).standard_cauchy(n).astype(np.float32)
    ax = jnp.abs(jnp.asarray(x))
    for p in (99.99, 99.0, 100.0):
        want = float(jax.jit(lambda a, p=p: jnp.max(a) if p >= 100
                             else jnp.percentile(a, p))(ax))
        got = float(quant._calib_amax(torch.from_numpy(x), p))
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=str(p))


# --- calibration and Predictor.quantize on resnet_18

@pytest.fixture(scope="module")
def resnet18():
    return resnet_variables(18, 2, IMG, seed=7)[1]


@pytest.fixture(scope="module")
def crops():
    """40 normalized synthetic crops: two calibration batches (32 + 8)."""
    cfg = resnet_config(img_size=IMG)
    frames, _, centers = synthetic_frames(40, 14, seed=5)
    img, _ = crop_normalize_batch(
        torch.from_numpy(frames), xyz2uvd_np(centers, cfg.paras, cfg.flip),
        np.tile(cfg.cube, (40, 1)), cfg.paras, IMG)
    return img.numpy()


def port_predictor(variables):
    cfg = resnet_config(img_size=IMG)
    model = load_flax_variables(build_model(cfg.net, cfg.jt_num), variables)
    return Predictor(cfg, model, device="cpu")


@pytest.mark.parametrize("percentile", [100.0, 99.99])
def test_calibrate_matches_jax(resnet18, crops, percentile):
    pred = port_predictor(resnet18)
    cal = jax_build_model("resnet_18", 14, 2, quant_mode="calib")
    want = jq.calibrate(cal, resnet18["params"], resnet18["batch_stats"],
                        [crops[i:i + 32] for i in (0, 32)],
                        percentile=percentile)
    got = quant.calibrate(pred.model, [torch.from_numpy(crops[i:i + 32])
                                       for i in (0, 32)], percentile)
    want = load_flax_quant(pred.model, want)
    assert got.keys() == want.keys() and len(got) == 23
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    assert all(m.mode == "off" for m in quant.quant_layers(pred.model).values())


# Normalized-uvd joint tolerance of the int8 Predictor against the JAX
# one.  The two sides' BatchNorms round differently (torch forms x *
# alpha + beta, the JAX package (x - mean) * rsqrt * scale + bias); a few
# ulps in layer1 flip an activation code by one step there, and each
# flip moves the next layers' inputs by more than a step, so codes flip
# on down the net.  Measured 3.9e-4 with each side's own scales, 2.5e-4
# with the JAX scales carried across, against an int8-vs-float32 drift
# of 5.8e-4; a one-ulp change of the input flips no code.
INT8_ATOL = 1e-3


def test_predictor_quantize_matches_jax(resnet18, crops):
    jax_pred = JaxPredictor(jax_resnet_config(img_size=IMG, use_pallas=False),
                            resnet18)
    pred = port_predictor(resnet18)
    fp = pred.predict_normalized(crops[:8])
    sd_keys = list(pred.model.state_dict())

    jax_pred.quantize(crops)
    pred.quantize(crops)
    want = jax_pred.predict_normalized(crops[:8])
    got = pred.predict_normalized(crops[:8])
    np.testing.assert_allclose(got, want, rtol=0, atol=INT8_ATOL)
    # the int8 forward is really another forward, and stays close
    assert 0 < np.abs(got - fp).max() < 0.05
    assert list(pred.model.state_dict()) == sd_keys

    # the JAX scales carried across: the same scales on both sides
    pred.quant = load_flax_quant(pred.model, jax_pred.quant)
    pred._switch_int8()
    got = pred.predict_normalized(crops[:8])
    np.testing.assert_allclose(got, want, rtol=0, atol=INT8_ATOL)

    # the quantized model's weights load back into a float model
    fresh = load_reference_state_dict(build_model("resnet_18", 14),
                                      pred.model.state_dict())
    assert all(m.mode == "off" for m in quant.quant_layers(fresh).values())


def test_set_int8_checks_layer_names():
    model = build_model("resnet_18", 14)
    scales = {n: torch.tensor(0.01) for n in quant.quant_layers(model)}
    with pytest.raises(KeyError, match="missing"):
        quant.set_int8(model, dict(list(scales.items())[1:]))
    with pytest.raises(ValueError, match="mode"):
        quant.set_quant_mode(model, "int4")
    quant.set_int8(model, scales)
    assert all(torch.equal(m.act_scale, torch.tensor(0.01))
               for m in quant.quant_layers(model).values())


# --- the int8 hourglass: every ConvBlock conv but the merges' quantized

# Normalized-uvd joint tolerance of the int8 hourglass_1 Predictor against
# the JAX one, for INT8_ATOL's reason: the two sides' BatchNorms round
# differently, and a code on a rounding boundary flips by one step; at
# 16 x 16 maps each flip reaches a large share of the next layers, so the
# differences grow down the net's 55 int8 convs.  Measured on the joints
# (one calibration batch of 32 crops): max 0.0092, mean 5.1e-4 with each
# side's own scales, max 0.0092, mean 2.3e-4 with the JAX scales, against
# an int8-vs-float32 drift of max 0.039, mean 3.3e-3; a one-ulp change of
# the input moves the port's own joints by 2.8e-6.
HG_INT8_ATOL = 0.02
HG_INT8_MEAN = 2e-3


@pytest.fixture(scope="module")
def hourglass1():
    return flax_variables(1, seed=4)[1]


def test_hourglass_predictor_quantize_matches_jax(hourglass1, crops):
    jax_pred = JaxPredictor(
        jax_hourglass_config(img_size=IMG, use_pallas=False), hourglass1)
    cfg = hourglass_config(img_size=IMG)
    pred = Predictor(cfg, load_flax_variables(
        build_model(cfg.net, cfg.jt_num), hourglass1), device="cpu")
    fp = pred.predict_normalized(crops[:8])
    sd_keys = list(pred.model.state_dict())

    jax_pred.quantize(crops[:32])
    pred.quantize(crops[:32])
    assert len(pred.quant) == len(quant.quant_layers(pred.model)) == 55
    assert "outs_1.0" not in pred.quant
    want = jax_pred.predict_normalized(crops[:8])
    got = pred.predict_normalized(crops[:8])
    np.testing.assert_allclose(got, want, rtol=0, atol=HG_INT8_ATOL)
    assert np.abs(got - want).mean() < HG_INT8_MEAN
    assert 0 < np.abs(got - fp).max() < 0.05
    assert list(pred.model.state_dict()) == sd_keys
    # the map leaves the int8 model contiguous, as the CUDA decode takes it
    with torch.no_grad():
        maps = pred.model(torch.from_numpy(crops[:8])[:, None])
    assert maps.is_contiguous() and maps[-1].is_contiguous()

    # the JAX scales carried across
    pred.quant = load_flax_quant(pred.model, jax_pred.quant)
    assert len(pred.quant) == 55
    pred._switch_int8()
    got = pred.predict_normalized(crops[:8])
    np.testing.assert_allclose(got, want, rtol=0, atol=HG_INT8_ATOL)
    assert np.abs(got - want).mean() < HG_INT8_MEAN

    fresh = load_reference_state_dict(build_model("hourglass_1", 14),
                                      pred.model.state_dict())
    assert all(m.mode == "off" for m in quant.quant_layers(fresh).values())
    with pytest.raises(KeyError):
        load_flax_quant(fresh, {"pre_conv": jax_pred.quant["pre_conv"]})
