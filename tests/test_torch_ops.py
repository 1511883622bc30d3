"""The port's encode, decode, decode backward, resize and preprocessing
against the JAX package, on seeded numpy inputs fed to both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from awr_tpu.data.device import crop_normalize_batch as jax_crop_normalize
from awr_tpu.data.synthetic import SyntheticHandDataset
from awr_tpu.data.synthetic import render_hand_depth as jax_render
from awr_tpu.data.transforms import crop_params_np as jax_crop_params
from awr_tpu.geometry import uvd2xyz_np as jax_uvd2xyz
from awr_tpu.geometry import xyz2uvd_np as jax_xyz2uvd
from awr_tpu.ops import joint2offset as jax_encode
from awr_tpu.ops import offset2joint_softmax as jax_decode
from awr_tpu.ops.functional import FG_THRESHOLD as JAX_FG_THRESHOLD
from awr_tpu.ops.functional import SOFTMAX_TEMP as JAX_SOFTMAX_TEMP
from awr_tpu.ops.functional import resize_nearest as jax_resize
from awr_tpu.ops.pallas_decode import decode_pallas
from awr_tpu.ops.pallas_encode import encode_pallas
from awr_tpu_torch import kernels
from awr_tpu_torch.config import NYU_PARAS, hourglass_config, resnet_config
from awr_tpu_torch.data.device import crop_normalize_batch
from awr_tpu_torch.data.synthetic import render_hand_depth, synthetic_frames
from awr_tpu_torch.data.transforms import crop_params_np
from awr_tpu_torch.geometry import uvd2xyz_np, xyz2uvd_np
from awr_tpu_torch.models import build_model
from awr_tpu_torch.models.common import torch_default_init_
from awr_tpu_torch.ops import decode, decode_cuda, encode_cuda, folded, library
from awr_tpu_torch.ops.decode import decode_offsets
from awr_tpu_torch.ops.encode import encode_offsets
from awr_tpu_torch.ops.functional import (joint2offset, offset2joint_softmax,
                                          offset2joint_softmax_backward,
                                          offset2joint_softmax_stats,
                                          resize_nearest)
from awr_tpu_torch.serving import Predictor
from awr_tpu_torch.training.steps import infer

J = 14
KERNEL = 0.4


def decode_inputs(F, frame, seed=0):
    """B = 2 maps (NHWC, as the JAX package takes them) and (2, 2F, 2F)
    depth: a foreground square on background, all background, or all
    foreground."""
    rng = np.random.RandomState(seed)
    H = 2 * F
    img = np.ones((2, H, H), np.float32)
    if frame == "mixed":
        img[:, H // 4:3 * H // 4, H // 4:3 * H // 4] = -0.3
        img[1, :2, :] = 0.5
    elif frame == "foreground":
        img[:] = rng.uniform(-1, 0.9, img.shape)
    off = (rng.randn(2, F, F, 4 * J) * 0.3).astype(np.float32)
    return off, img


def port_decode(off_nhwc, img):
    off = torch.from_numpy(np.ascontiguousarray(off_nhwc.transpose(0, 3, 1, 2)))
    return offset2joint_softmax(off, torch.from_numpy(img), KERNEL).numpy()


@pytest.mark.parametrize("frame", ["mixed", "background", "foreground"])
@pytest.mark.parametrize("F", [8, 16])
def test_decode_matches_jnp(F, frame):
    off, img = decode_inputs(F, frame)
    want = np.asarray(jax_decode(jnp.asarray(off), jnp.asarray(img), KERNEL))
    np.testing.assert_allclose(port_decode(off, img), want,
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("frame", ["mixed", "background", "foreground"])
@pytest.mark.parametrize("F", [8, 16])
def test_decode_matches_pallas_interpret(F, frame):
    off, img = decode_inputs(F, frame, seed=1)
    want = np.asarray(decode_pallas(jnp.asarray(off), jnp.asarray(img),
                                    KERNEL, interpret=True))
    np.testing.assert_allclose(port_decode(off, img), want,
                               rtol=1e-5, atol=1e-6)


def test_decode_dispatch_runs_plain_on_cpu():
    off, img = decode_inputs(8, "mixed")
    off_t = torch.from_numpy(np.ascontiguousarray(off.transpose(0, 3, 1, 2)))
    before = kernels.LAUNCHES["decode"]
    got = decode_offsets(off_t, torch.from_numpy(img), KERNEL)
    assert kernels.LAUNCHES["decode"] == before
    np.testing.assert_array_equal(got.numpy(), port_decode(off, img))


def test_decode_bf16_map_is_decoded_in_float32():
    off, img = decode_inputs(8, "mixed")
    off_t = torch.from_numpy(
        np.ascontiguousarray(off.transpose(0, 3, 1, 2))).bfloat16()
    got = offset2joint_softmax(off_t, torch.from_numpy(img), KERNEL)
    want = offset2joint_softmax(off_t.float(), torch.from_numpy(img), KERNEL)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("offset,img,error,match", [
    (torch.zeros(2, 4 * J, 8, 8), torch.zeros(2, 16, 16), ValueError, "CUDA"),
    (torch.zeros(2, 4 * J, 8, 8, dtype=torch.float64), torch.zeros(2, 16, 16),
     TypeError, "float32"),
    (torch.zeros(2, 4 * J, 8, 8), torch.zeros(2, 16, 16).half(), TypeError,
     "float32"),
    (torch.zeros(2, 4 * J - 1, 8, 8), torch.zeros(2, 16, 16), ValueError,
     "4J"),
    (torch.zeros(2, 4 * J, 8, 6), torch.zeros(2, 16, 16), ValueError, "4J"),
    (torch.zeros(2, 4 * J, 8, 8), torch.zeros(3, 16, 16), ValueError, "4J"),
    (torch.zeros(0, 4 * J, 8, 8), torch.zeros(0, 16, 16), ValueError, "4J"),
    (torch.zeros(2, 4 * J, 8, 8), torch.zeros(2, 256), ValueError, "4J"),
    (torch.zeros(2, 8, 8, 4 * J).permute(0, 3, 1, 2), torch.zeros(2, 16, 16),
     ValueError, "contiguous"),
])
def test_kernel_wrapper_refuses(offset, img, error, match):
    before = kernels.LAUNCHES["decode"]
    with pytest.raises(error, match=match):
        decode_cuda.offset2joint_softmax_cuda(offset, img, KERNEL)
    assert kernels.LAUNCHES["decode"] == before


def encode_inputs(F, frame, seed=0):
    """Joints in [-0.8, 0.8] and the decode's (2, 2F, 2F) frames."""
    _, img = decode_inputs(F, frame, seed)
    jt = np.random.RandomState(seed + 100).uniform(-0.8, 0.8, (2, J, 3))
    return jt.astype(np.float32), img


def port_encode(jt, img, F):
    out = joint2offset(torch.from_numpy(jt), torch.from_numpy(img), KERNEL, F)
    return out.numpy().transpose(0, 2, 3, 1)  # NHWC, as the JAX package's


@pytest.mark.parametrize("frame", ["mixed", "background", "foreground"])
@pytest.mark.parametrize("F", [8, 16])
def test_encode_matches_jnp(F, frame):
    jt, img = encode_inputs(F, frame)
    want = np.asarray(jax_encode(jnp.asarray(jt), jnp.asarray(img), KERNEL, F))
    got = port_encode(jt, img, F)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert (np.count_nonzero(got) > 0) == (frame != "background")


@pytest.mark.parametrize("frame", ["mixed", "background", "foreground"])
@pytest.mark.parametrize("F", [8, 16])
def test_encode_matches_pallas_interpret(F, frame):
    jt, img = encode_inputs(F, frame, seed=1)
    want = np.asarray(encode_pallas(jnp.asarray(jt), jnp.asarray(img), KERNEL,
                                    F, interpret=True))
    np.testing.assert_allclose(port_encode(jt, img, F), want, rtol=1e-5,
                               atol=1e-6)


def test_encode_dispatch_runs_plain_on_cpu():
    jt, img = encode_inputs(8, "mixed")
    jt_t = torch.from_numpy(jt).requires_grad_()
    before = kernels.LAUNCHES["encode"]
    got = encode_offsets(jt_t, torch.from_numpy(img), KERNEL, 8)
    assert kernels.LAUNCHES["encode"] == before
    assert not got.requires_grad  # a target: no gradient, as stop_gradient
    np.testing.assert_array_equal(got.numpy().transpose(0, 2, 3, 1),
                                  port_encode(jt, img, 8))


@pytest.mark.parametrize("jt,img,error,match", [
    (torch.zeros(2, J, 3), torch.zeros(2, 16, 16), ValueError, "CUDA"),
    (torch.zeros(2, J, 3, dtype=torch.float64), torch.zeros(2, 16, 16),
     TypeError, "float32"),
    (torch.zeros(2, J, 3), torch.zeros(2, 16, 16).half(), TypeError,
     "float32"),
    (torch.zeros(2, J, 2), torch.zeros(2, 16, 16), ValueError, "B, J, 3"),
    (torch.zeros(2, J, 3), torch.zeros(3, 16, 16), ValueError, "B, J, 3"),
    (torch.zeros(0, J, 3), torch.zeros(0, 16, 16), ValueError, "B, J, 3"),
    (torch.zeros(2, 3, J).transpose(1, 2), torch.zeros(2, 16, 16),
     ValueError, "contiguous"),
])
def test_encode_wrapper_refuses(jt, img, error, match):
    before = kernels.LAUNCHES["encode"]
    with pytest.raises(error, match=match):
        encode_cuda.joint2offset_cuda(jt, img, KERNEL, 8)
    assert kernels.LAUNCHES["encode"] == before


def jax_decode_vjp(off_nhwc, img, g):
    _, vjp = jax.vjp(lambda o: jax_decode(o, jnp.asarray(img), KERNEL),
                     jnp.asarray(off_nhwc))
    return np.asarray(vjp(jnp.asarray(g))[0]).transpose(0, 3, 1, 2)


# float64: the closed form and autodiff agree to roundoff.  float32:
# dL/dht_p carries 30 w_p (g.t_p - g.out), a difference of two sums over
# F^2 pixels taken in other orders; one float32 rounding of g.out, times
# 30 w_p, reaches a few float32 ulps of max |grad| (measured up to 1.4e-6
# of max |grad|), so atol is stated relative to max |grad|: 4e-6 of it.
BACKWARD_TOL = {np.float64: dict(rtol=1e-10, atol=1e-10),
                np.float32: dict(rtol=1e-5, atol=4e-6)}


@pytest.mark.parametrize("with_stats", [False, True])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("frame", ["mixed", "background", "foreground"])
@pytest.mark.parametrize("F", [8, 16])
def test_decode_backward_matches_jax_vjp_and_autograd(F, frame, dtype,
                                                      with_stats):
    """The closed form, from its own softmax or (as the CUDA backward
    takes it) from the forward's saved statistics."""
    off, img = decode_inputs(F, frame, seed=2)
    off, img = off.astype(dtype), img.astype(dtype)
    g = np.random.RandomState(F).randn(2, J, 3).astype(dtype)
    with jax.enable_x64(dtype == np.float64):
        want = jax_decode_vjp(off, img, g)
    off_t = torch.from_numpy(np.ascontiguousarray(off.transpose(0, 3, 1, 2)))
    img_t = torch.from_numpy(img)
    stats = offset2joint_softmax_stats(off_t, img_t) if with_stats else None
    got = offset2joint_softmax_backward(off_t, img_t, KERNEL,
                                        torch.from_numpy(g), stats).numpy()
    leaf = off_t.clone().requires_grad_()
    offset2joint_softmax(leaf, img_t, KERNEL).backward(torch.from_numpy(g))
    tol = dict(BACKWARD_TOL[dtype])
    tol["atol"] *= max(np.abs(want).max(), 1.0)
    assert got.dtype == dtype
    np.testing.assert_allclose(got, want, **tol)
    np.testing.assert_allclose(got, leaf.grad.numpy(), **tol)
    if frame == "background":
        assert not got.any()


def test_decode_backward_bf16_map_gives_bf16_gradient():
    off, img = decode_inputs(8, "mixed")
    off_t = torch.from_numpy(
        np.ascontiguousarray(off.transpose(0, 3, 1, 2))).bfloat16()
    g = torch.randn(2, J, 3, generator=torch.Generator().manual_seed(0))
    got = offset2joint_softmax_backward(off_t, torch.from_numpy(img), KERNEL, g)
    want = offset2joint_softmax_backward(off_t.float(), torch.from_numpy(img),
                                         KERNEL, g)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want.bfloat16(), rtol=0, atol=0)


def test_decode_autograd_function_wiring():
    """The decode op's autograd registration, on the CPU: the output has
    a grad_fn that saved the map, the depth, the joints and the softmax
    statistics; the backward calls the op ``decode_backward`` once, with
    the forward's output and statistics; and the gradient is autograd's
    through the plain forward, bit for bit in float64 and float32 (the
    float64 multi-step parity tests amplify one ulp).  No gradient under
    ``inference_mode``.  (tests/test_torch_cuda.py runs the kernels.)"""
    calls = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.namespace == "awr_tpu_torch":
                calls.append((func.__name__, args))
            return func(*args, **(kwargs or {}))

    off, img = decode_inputs(8, "mixed")
    for dtype in (torch.float64, torch.float32):
        calls.clear()
        off_t = torch.from_numpy(
            np.ascontiguousarray(off.transpose(0, 3, 1, 2))).to(dtype)
        img_t = torch.from_numpy(img).to(dtype)
        g = torch.randn(2, J, 3, generator=torch.Generator().manual_seed(1),
                        dtype=dtype)
        leaf = off_t.clone().requires_grad_()
        with Record():
            out = decode.decode_offsets(leaf, img_t, KERNEL)
            assert out.grad_fn is not None
            saved = out.grad_fn.saved_tensors
            assert len(saved) == 4 and torch.equal(saved[2], out.detach())
            assert torch.equal(saved[3],
                               offset2joint_softmax_stats(off_t, img_t))
            out.backward(g)
        assert [c[0] for c in calls] == ["decode.default",
                                         "decode_backward.default"]
        assert torch.equal(calls[1][1][2], out.detach())
        assert calls[1][1][3] is saved[3]
        ref = off_t.clone().requires_grad_()
        offset2joint_softmax(ref, img_t, KERNEL).backward(g)
        assert leaf.grad.dtype == dtype
        assert torch.equal(leaf.grad, ref.grad)
    with torch.inference_mode():
        assert decode.decode_offsets(off_t, img_t, KERNEL).grad_fn is None


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("frame", ["mixed", "background", "foreground"])
@pytest.mark.parametrize("F", [8, 16])
def test_decode_stats_match_float64(F, frame, dtype):
    """(max, sum) of the masked softmax logits against float64 numpy on
    the JAX package's own nearest resize and thresholds.  float32: the
    max is one rounding of 30 h; the sum adds F^2 terms exp(l - m), each
    within a few ulps of |l - m| <= 60 (|h| < 2 here), so rtol 1e-5."""
    off, img = decode_inputs(F, frame, seed=3)
    img_f = np.asarray(jax_resize(jnp.asarray(img), F), np.float64)
    mask = (img_f < JAX_FG_THRESHOLD).reshape(2, F * F, 1)
    logit = (off.astype(np.float64).reshape(2, F * F, 4 * J)[..., 3 * J:]
             * mask * JAX_SOFTMAX_TEMP)
    m = logit.max(axis=1)
    want = np.stack([m, np.exp(logit - m[:, None]).sum(axis=1)], axis=-1)
    off_t = torch.from_numpy(
        np.ascontiguousarray(off.transpose(0, 3, 1, 2)).astype(dtype))
    got = offset2joint_softmax_stats(off_t, torch.from_numpy(img)).numpy()
    assert got.shape == (2, J, 2) and got.dtype == dtype
    rtol = 1e-12 if dtype == np.float64 else 1e-5
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0)
    if frame == "background":
        # every logit is 0: the max is 0, the sum counts the pixels
        np.testing.assert_array_equal(got, np.tile([0.0, F * F], (2, J, 1)))


def test_decode_stats_max_is_the_softmax_max():
    """The statistics' max is bit-equal to the one torch.softmax inside
    offset2joint_softmax subtracts (same spelling of the logit), and the
    weights they give match the softmax's."""
    off, img = decode_inputs(16, "mixed", seed=4)
    off_t = torch.from_numpy(np.ascontiguousarray(off.transpose(0, 3, 1, 2)))
    img_t = torch.from_numpy(img)
    stats = offset2joint_softmax_stats(off_t, img_t)
    mask = (resize_nearest(img_t, 16) < 0.99).float().reshape(2, 1, 256)
    logit = off_t.reshape(2, 4 * J, 256)[:, 3 * J:] * mask * 30.0
    assert torch.equal(stats[..., 0], logit.max(-1).values)
    w = torch.exp(logit - stats[..., :1]) / stats[..., 1:]
    torch.testing.assert_close(w, torch.softmax(logit, -1), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("size", [5, 8, 16, 24])
def test_resize_nearest_exact(size):
    img = np.random.RandomState(size).randn(2, 16, 24).astype(np.float32)
    want = np.asarray(jax_resize(jnp.asarray(img), size))
    got = resize_nearest(torch.from_numpy(img), size).numpy()
    np.testing.assert_array_equal(got, want)


def raw_batch(n=6, seed=3):
    """Raw frames from the JAX package's renderer, with centers in uvd."""
    g = np.random.RandomState(seed)
    centers = np.stack([g.uniform(-80, 80, n), g.uniform(-60, 60, n),
                        g.uniform(650, 950, n)], axis=1)
    joints = centers[:, None] + g.uniform(-70, 70, (n, J, 3))
    frames = np.stack([jax_render(c, j, NYU_PARAS)
                       for c, j in zip(centers, joints)])
    cubes = np.tile([300.0, 300.0, 300.0], (n, 1))
    cubes[1] = (250.0, 280.0, 220.0)
    return frames, jax_xyz2uvd(centers, NYU_PARAS, -1), cubes


def test_geometry_matches():
    pts = np.random.RandomState(0).uniform(-100, 900, (4, J, 3))
    pts[..., 2] = np.abs(pts[..., 2]) + 300
    for flip in (1, -1):
        np.testing.assert_array_equal(xyz2uvd_np(pts, NYU_PARAS, flip),
                                      jax_xyz2uvd(pts, NYU_PARAS, flip))
        np.testing.assert_array_equal(uvd2xyz_np(pts, NYU_PARAS, flip),
                                      jax_uvd2xyz(pts, NYU_PARAS, flip))


@pytest.mark.parametrize("dsize", [64, 128])
def test_crop_params_exact(dsize):
    _, centers_uvd, cubes = raw_batch()
    got = crop_params_np(centers_uvd, cubes, NYU_PARAS, dsize)
    want = jax_crop_params(centers_uvd, cubes, NYU_PARAS, dsize)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("dsize", [64, 128])
def test_crop_normalize_bit_identical(dsize):
    frames, centers_uvd, cubes = raw_batch()
    want, want_M = jax_crop_normalize(frames, centers_uvd, cubes,
                                      np.asarray(NYU_PARAS), dsize)
    got, got_M = crop_normalize_batch(torch.from_numpy(frames), centers_uvd,
                                      cubes, NYU_PARAS, dsize)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_M, want_M)


def test_synthetic_frames_match_dataset():
    frames, joints, centers = synthetic_frames(3, J, seed=5)
    ds = SyntheticHandDataset(3, J, 128, seed=5, mode="raw")
    for i in range(3):
        img, jt, c = ds.raw_item(i)
        np.testing.assert_array_equal(frames[i], img)
        np.testing.assert_array_equal(joints[i], jt)
        np.testing.assert_array_equal(centers[i], c)
    np.testing.assert_array_equal(
        render_hand_depth(centers[0], joints[0], NYU_PARAS, (120, 160)),
        jax_render(centers[0], joints[0], NYU_PARAS, (120, 160)))


# --- the custom ops of awr_tpu_torch/ops/library.py

def _opcheck_cases():
    """Each op at small shapes through its CPU implementation: the
    decode with a float32 and a bfloat16 map (and a map that requires a
    gradient, which reaches the autograd registration), its backward,
    the encode, the int8 GEMM, the deconv writing float32 and bfloat16,
    and the bf16 inference form's three passes (the epilogue with and
    without a residual, the heads' conversion, the stem)."""
    g = torch.Generator().manual_seed(0)
    off = torch.randn(2, 56, 8, 8, generator=g) * 0.3
    img = torch.rand(2, 16, 16, generator=g) * 2 - 1
    img[:, :4] = 1.0
    jt = torch.rand(2, 14, 3, generator=g) * 1.6 - 0.8
    out, stats = library.decode(off, img, 0.4)
    a = torch.randint(-127, 128, (40, 48), generator=g, dtype=torch.int8)
    b = torch.randint(-127, 128, (24, 48), generator=g, dtype=torch.int8)
    xq = torch.randint(-127, 128, (2, 3, 5, 16), generator=g,
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (16, 8, 4, 4), generator=g,
                       dtype=torch.int8)
    scale = torch.rand(8, generator=g) * 1e-3
    y, z = (torch.randn(2, 16, 5, 3, generator=g).bfloat16().contiguous(
        memory_format=torch.channels_last) for _ in range(2))
    bias = torch.randn(16, generator=g)
    depth = torch.rand(2, 1, 9, 7, generator=g) * 2 - 1
    stem = (torch.randn(64, 1, 5, 5, generator=g) * 0.3).bfloat16()
    return {
        "decode_f32": (library.decode, (off, img, 0.4)),
        "decode_bf16": (library.decode, (off.bfloat16(), img, 0.4)),
        "decode_grad": (library.decode,
                        (off.clone().requires_grad_(), img, 0.4)),
        "decode_backward": (library.decode_backward,
                            (off, img, out, stats,
                             torch.randn(2, 14, 3, generator=g), 0.4)),
        "encode": (library.encode, (jt, img, 0.4, 8)),
        "int8_matmul": (library.int8_matmul, (a, b.t())),
        "deconv_f32": (library.deconv4x4s2_int8,
                       (xq, wq, scale, torch.float32)),
        "deconv_bf16": (library.deconv4x4s2_int8,
                        (xq, wq, scale, torch.bfloat16)),
        "bias_relu": (torch.ops.awr_tpu_torch.bias_relu_.default,
                      (y, bias, None)),
        "bias_relu_residual": (torch.ops.awr_tpu_torch.bias_relu_.default,
                               (y, bias, z)),
        "head_out": (library.head_out, (y, bias)),
        "stem_pool": (library.stem_pool, (depth, stem, bias.repeat(4))),
    }


@pytest.mark.parametrize("name", list(_opcheck_cases()))
def test_custom_op_passes_opcheck(name):
    op, args = _opcheck_cases()[name]
    torch.library.opcheck(op, args)


def test_ops_give_the_plain_versions():
    """On CPU tensors each op is its plain version, bit for bit."""
    c = _opcheck_cases()
    off, img, k = c["decode_f32"][1]
    out, stats = library.decode(off, img, k)
    assert torch.equal(out, offset2joint_softmax(off, img, k))
    assert torch.equal(stats, offset2joint_softmax_stats(off, img))
    jt, img, k, f = c["encode"][1]
    assert torch.equal(library.encode(jt, img, k, f),
                       joint2offset(jt, img, k, f))
    _, (y, bias, z) = c["bias_relu_residual"]
    want = folded.bias_relu_(y.clone(), bias, z)
    got = y.clone()
    assert library.bias_relu_(got, bias, z) is got
    assert torch.equal(got, want)
    assert torch.equal(library.head_out(y, bias), folded.head_out(y, bias))
    args = c["stem_pool"][1]
    assert torch.equal(library.stem_pool(*args), folded.stem_pool(*args))


def _random_predictor(net, int8):
    """A CPU Predictor of ``net`` at img 32 with PyTorch's default init
    (seeded), after ``quantize`` with ``int8``; and 8 normalized crops of
    synthetic frames."""
    cfg = (hourglass_config if net == "hourglass_1" else resnet_config)(
        img_size=32)
    model = torch_default_init_(
        build_model(cfg.net, cfg.jt_num, cfg.downsample),
        torch.Generator().manual_seed(0))
    pred = Predictor(cfg, model, device="cpu")
    imgs, _, centers = synthetic_frames(8, J, seed=13)
    crops = crop_normalize_batch(
        torch.from_numpy(imgs), xyz2uvd_np(centers, pred.paras, pred.flip),
        np.tile(cfg.cube, (8, 1)), pred.paras, 32)[0].numpy()
    if int8:
        pred.quantize(crops)
    return pred, crops


@pytest.mark.parametrize("net,int8", [("hourglass_1", False),
                                      ("resnet_18", True)])
def test_compile_traces_through_the_kernels(net, int8):
    """``torch.compile(backend="aot_eager", fullgraph=True)`` of the
    inference step, float32 hourglass_1 and int8 resnet_18 (GEMMs and
    deconvs): no ``ctypes`` call breaks the graph, and the compiled step
    gives the eager step's joints."""
    pred, crops = _random_predictor(net, int8)
    k = pred.cfg.kernel_size
    step = torch.compile(lambda x: infer(pred.model, x, k),
                         backend="aot_eager", fullgraph=True)
    x = torch.from_numpy(crops)
    with torch.no_grad():
        got = step(x)
        want = infer(pred.model, x, k)
    assert torch.equal(got, want)
