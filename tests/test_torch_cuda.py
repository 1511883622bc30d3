"""The hand-written CUDA kernels (decode, decode backward, encode, int8
GEMM, int8 deconv) against their plain PyTorch versions, on the card, and
an int8 resnet_18 request through them.  Needs no JAX; skips without a
GPU.  On a machine with one:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q
"""

import numpy as np
import pytest
import torch

from awr_tpu_torch.config import resnet_config
from awr_tpu_torch.models import build_model
from awr_tpu_torch.models.common import torch_default_init_
from awr_tpu_torch.ops import decode_cuda, encode_cuda, int8, int8_cuda
from awr_tpu_torch.ops.decode import decode_offsets
from awr_tpu_torch.ops.encode import encode_offsets
from awr_tpu_torch.ops.functional import (joint2offset, offset2joint_softmax,
                                          offset2joint_softmax_backward)
from awr_tpu_torch.serving import Predictor

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


SHAPES = [(1, 8), (3, 16), (32, 64)]
J = 14


def inputs(cuda, B, F, dtype=torch.float32):
    """A seeded (B, 4J, F, F) map, (B, 2F, 2F) depth with one
    all-background frame, and (B, J, 3) joints."""
    rng = np.random.RandomState(B * F)
    H = 2 * F
    img = np.ones((B, H, H), np.float32)
    img[:, H // 4:3 * H // 4, H // 4:] = rng.uniform(-1, 0.9, (H // 2, 3 * H // 4))
    img[0] = 1.0
    off = torch.from_numpy(rng.randn(B, 4 * J, F, F).astype(np.float32) * 0.3)
    jt = torch.from_numpy(rng.uniform(-0.8, 0.8, (B, J, 3)).astype(np.float32))
    return (off.to(cuda, dtype), torch.from_numpy(img).to(cuda),
            jt.to(cuda))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,F", SHAPES)
def test_decode_kernel_matches_plain(cuda, B, F, dtype):
    off, img, _ = inputs(cuda, B, F, dtype)
    before = decode_cuda.LAUNCHES
    got = decode_offsets(off, img, 0.4)
    torch.cuda.synchronize()
    assert decode_cuda.LAUNCHES == before + 1
    want = offset2joint_softmax(off.float(), img, 0.4)
    # float32 sums over F*F pixels in another order
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("B,F", SHAPES)
def test_encode_kernel_matches_plain(cuda, B, F):
    _, img, jt = inputs(cuda, B, F)
    before = encode_cuda.LAUNCHES
    got = encode_offsets(jt, img, 0.4, F)
    torch.cuda.synchronize()
    assert encode_cuda.LAUNCHES == before + 1
    assert got.shape == (B, 4 * J, F, F) and not got.requires_grad
    # the kernel spells every operation as the plain version does, in
    # IEEE float32 without contraction
    torch.testing.assert_close(got, joint2offset(jt, img, 0.4, F), rtol=0,
                               atol=1e-5)


# float32: sums over F*F pixels in another order, and a difference of
# two of them in dL/dht, so the bound is relative to max |grad|;
# bfloat16: one bfloat16 rounding of the float32 gradient
BACKWARD_ATOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,F", SHAPES)
def test_decode_backward_kernel_matches_plain(cuda, B, F, dtype):
    off, img, _ = inputs(cuda, B, F, dtype)
    g = torch.randn(B, J, 3, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(B))
    out = decode_cuda.offset2joint_softmax_cuda(off, img, 0.4)
    before = decode_cuda.BACKWARD_LAUNCHES
    got = decode_cuda.offset2joint_softmax_backward_cuda(off, img, out, g,
                                                         0.4)
    torch.cuda.synchronize()
    assert decode_cuda.BACKWARD_LAUNCHES == before + 1
    want = offset2joint_softmax_backward(off, img, 0.4, g)
    assert got.dtype == dtype and got.shape == off.shape
    atol = BACKWARD_ATOL[dtype] * float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)
    assert not got[0].any()  # the all-background frame


def test_decode_offsets_has_a_kernel_gradient(cuda):
    off, img, _ = inputs(cuda, 3, 16)
    x = off.clone().requires_grad_()
    before = (decode_cuda.LAUNCHES, decode_cuda.BACKWARD_LAUNCHES)
    out = decode_offsets(x, img, 0.4)
    assert out.grad_fn is not None
    g = torch.randn_like(out)
    out.backward(g)
    torch.cuda.synchronize()
    assert (decode_cuda.LAUNCHES, decode_cuda.BACKWARD_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    want = offset2joint_softmax_backward(off, img, 0.4, g)
    torch.testing.assert_close(x.grad, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))
    with torch.inference_mode():
        assert decode_offsets(off, img, 0.4).grad_fn is None
    assert decode_cuda.BACKWARD_LAUNCHES == before[1] + 1


def int8_codes(cuda, shape, seed):
    g = torch.Generator(cuda).manual_seed(seed)
    return torch.randint(-127, 128, shape, generator=g, device=cuda,
                         dtype=torch.int8)


# (M, K, N): odd M and K (byte loads), the stem, layer1's 3x3, a deconv
# phase's shape
GEMM_SHAPES = [(1000, 25, 64), (333, 40, 24), (4096, 576, 64),
               (32768, 1024, 256)]


@pytest.mark.parametrize("M,K,N", GEMM_SHAPES)
def test_int8_gemm_kernel_matches_plain(cuda, M, K, N):
    a, b = int8_codes(cuda, (M, K), M), int8_codes(cuda, (K, N), K)
    before = int8_cuda.GEMM_LAUNCHES
    got = int8_cuda.int8_matmul_cuda(a, b)
    torch.cuda.synchronize()
    assert int8_cuda.GEMM_LAUNCHES == before + 1
    assert got.dtype == torch.int32 and got.shape == (M, N)
    assert torch.equal(got, int8.int8_matmul(a, b))
    if K % 8 == 0 and N % 8 == 0:
        assert torch.equal(got, torch._int_mm(a, b))
    # B as the transposed view of a conv weight: the same result
    assert torch.equal(int8_cuda.int8_matmul_cuda(a, b.t().contiguous().t()),
                       got)


# (B, H, W, C_in, C_out): resnet_18's three decoder deconvs at B = 2, and
# an odd shape
DECONV_SHAPES = [(2, 8, 8, 512, 256), (2, 16, 16, 256, 256),
                 (2, 32, 32, 256, 256), (3, 5, 7, 16, 24)]


@pytest.mark.parametrize("B,H,W,cin,cout", DECONV_SHAPES)
def test_int8_deconv_kernel_matches_plain(cuda, B, H, W, cin, cout):
    xq = int8_codes(cuda, (B, H, W, cin), H)
    wq = int8_codes(cuda, (cin, cout, 4, 4), cin)
    scale = torch.empty(cout, device=cuda).uniform_(
        0.5, 2.0, generator=torch.Generator(cuda).manual_seed(cout))
    before = int8_cuda.DECONV_LAUNCHES
    got = int8_cuda.deconv4x4s2_int8_cuda(xq, wq, scale)
    torch.cuda.synchronize()
    assert int8_cuda.DECONV_LAUNCHES == before + 1
    assert got.shape == (B, cout, 2 * H, 2 * W)
    assert torch.equal(got, int8.deconv4x4s2_int8(xq, wq, scale))


def test_int8_resnet18_request_launches(cuda):
    """One int8 request: 20 GEMMs (every encoder conv), 3 deconvs, 1
    decode, and nothing else; the joints stay near the float32 ones."""
    cfg = resnet_config(img_size=64)
    model = torch_default_init_(build_model(cfg.net, cfg.jt_num),
                                torch.Generator().manual_seed(0))
    pred = Predictor(cfg, model, device=cuda)
    img = np.random.RandomState(0).uniform(-1, 1, (8, 64, 64)).astype(
        np.float32)
    fp = pred.predict_normalized(img)
    pred.quantize(img)
    before = (int8_cuda.GEMM_LAUNCHES, int8_cuda.DECONV_LAUNCHES,
              decode_cuda.LAUNCHES, encode_cuda.LAUNCHES)
    q8 = pred.predict_normalized(img)
    after = (int8_cuda.GEMM_LAUNCHES, int8_cuda.DECONV_LAUNCHES,
             decode_cuda.LAUNCHES, encode_cuda.LAUNCHES)
    assert [y - x for x, y in zip(before, after)] == [20, 3, 1, 0]
    assert np.isfinite(q8).all() and np.abs(q8 - fp).max() < 0.05
