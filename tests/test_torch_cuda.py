"""The hand-written CUDA kernels (decode and its softmax statistics,
decode backward, encode, int8 GEMM, int8 deconv) against their plain
PyTorch versions, on the card, int8 requests of both backbones through
them, the QAT fine-tune's launches, fallback and TF32 rule, and the
``Predictor.predict_async`` contract the batching layer pipelines on.  Needs no
JAX; skips without a GPU.  On a machine with one:

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
                                          offset2joint_softmax_backward,
                                          offset2joint_softmax_stats)
from awr_tpu_torch.serving import Predictor

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# (B, F, H): the decode's maps at B from 1 to 32 (bucket 8: a batch-1
# request), F from 8 to 128 (H = F: the identity resize of resnet ds 1),
# and F = 10 (F % 4 != 0: scalar loads) with H = 25, no multiple of F
SHAPES = [(1, 8, 16), (3, 16, 32), (16, 16, 32), (8, 64, 128),
          (32, 64, 128), (2, 32, 64), (4, 128, 128), (1, 10, 25)]
ENCODE_SHAPES = [(1, 8), (3, 16), (32, 64)]
J = 14


def inputs(cuda, B, F, dtype=torch.float32, H=None, J=J):
    """A seeded (B, 4J, F, F) map, (B, H, H) depth (H = 2F by default)
    with one all-background frame, and (B, J, 3) joints."""
    rng = np.random.RandomState(B * F)
    H = H or 2 * F
    img = np.ones((B, H, H), np.float32)
    img[:, H // 4:3 * H // 4, H // 4:] = rng.uniform(
        -1, 0.9, (3 * H // 4 - H // 4, H - H // 4))
    img[0] = 1.0
    off = torch.from_numpy(rng.randn(B, 4 * J, F, F).astype(np.float32) * 0.3)
    jt = torch.from_numpy(rng.uniform(-0.8, 0.8, (B, J, 3)).astype(np.float32))
    return (off.to(cuda, dtype), torch.from_numpy(img).to(cuda),
            jt.to(cuda))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,F,H", SHAPES)
def test_decode_kernel_matches_plain(cuda, B, F, H, dtype):
    off, img, _ = inputs(cuda, B, F, dtype, H)
    before = decode_cuda.LAUNCHES
    got = decode_offsets(off, img, 0.4)
    torch.cuda.synchronize()
    assert decode_cuda.LAUNCHES == before + 1
    want = offset2joint_softmax(off.float(), img, 0.4)
    # float32 sums over F*F pixels in another order
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)


def assert_stats_match(got, want):
    """The max is order-free and spelled as the plain version spells it:
    bit-equal.  The sum: float32 over F*F pixels in another order."""
    assert got.shape == want.shape and got.dtype == torch.float32
    assert torch.equal(got[..., 0], want[..., 0])
    torch.testing.assert_close(got[..., 1], want[..., 1], rtol=1e-6, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,F,H", SHAPES)
def test_decode_kernel_stats_match_plain(cuda, B, F, H, dtype):
    off, img, _ = inputs(cuda, B, F, dtype, H)
    out, stats = decode_cuda.offset2joint_softmax_cuda(off, img, 0.4)
    torch.cuda.synchronize()
    # one reduction order: a second launch gives the same bits
    again = decode_cuda.offset2joint_softmax_cuda(off, img, 0.4)
    assert torch.equal(out, again[0]) and torch.equal(stats, again[1])
    assert_stats_match(stats, offset2joint_softmax_stats(off, img))
    # the all-background frame: every logit 0
    assert torch.equal(stats[0, :, 1], torch.full_like(stats[0, :, 1], F * F))


def test_decode_unaligned_map(cuda):
    """A map whose base is not 16-byte aligned is copied for the vector
    loads; the gradient comes back in a fresh tensor."""
    off, img, _ = inputs(cuda, 2, 16)
    base = torch.empty(off.numel() + 1, device=cuda)
    x = base[1:].view(off.shape)
    x.copy_(off)
    assert x.data_ptr() % 16 != 0
    out, stats = decode_cuda.offset2joint_softmax_cuda(x, img, 0.4)
    torch.testing.assert_close(out, offset2joint_softmax(off, img, 0.4),
                               rtol=0, atol=2e-5)
    g = torch.ones_like(out)
    want = offset2joint_softmax_backward(off, img, 0.4, g)
    got = decode_cuda.offset2joint_softmax_backward_cuda(x, img, out, stats,
                                                         g, 0.4)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("B,F", ENCODE_SHAPES)
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
@pytest.mark.parametrize("B,F,H", SHAPES)
def test_decode_backward_kernel_matches_plain(cuda, B, F, H, dtype):
    """The backward from the forward's saved statistics, against the
    plain closed form with its own softmax."""
    off, img, _ = inputs(cuda, B, F, dtype, H)
    g = torch.randn(B, J, 3, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(B))
    out, stats = decode_cuda.offset2joint_softmax_cuda(off, img, 0.4)
    before = decode_cuda.BACKWARD_LAUNCHES
    got = decode_cuda.offset2joint_softmax_backward_cuda(off, img, out, stats,
                                                         g, 0.4)
    torch.cuda.synchronize()
    assert decode_cuda.BACKWARD_LAUNCHES == before + 1
    want = offset2joint_softmax_backward(off, img, 0.4, g)
    assert got.dtype == dtype and got.shape == off.shape
    atol = BACKWARD_ATOL[dtype] * float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)
    assert not got[0].any()  # the all-background frame


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,F,H", [(32, 64, 128), (3, 16, 32)])
@pytest.mark.parametrize("joints", [16, 21])
def test_kernels_at_icvl_msra_hands17_joint_counts(cuda, joints, B, F, H,
                                                   dtype):
    """ICVL's 16 and MSRA's and HANDS17's 21 joints: the decode, its
    statistics and backward, and the encode, each one launch, against
    their plain versions at the bars of the J = 14 tests above."""
    off, img, jt = inputs(cuda, B, F, dtype, H, J=joints)
    before = (decode_cuda.LAUNCHES, decode_cuda.BACKWARD_LAUNCHES,
              encode_cuda.LAUNCHES)
    out, stats = decode_cuda.offset2joint_softmax_cuda(off, img, 0.4)
    g = torch.randn(B, joints, 3, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(B))
    grad = decode_cuda.offset2joint_softmax_backward_cuda(off, img, out,
                                                          stats, g, 0.4)
    enc = encode_offsets(jt, img, 0.4, F)
    torch.cuda.synchronize()
    assert (decode_cuda.LAUNCHES, decode_cuda.BACKWARD_LAUNCHES,
            encode_cuda.LAUNCHES) == tuple(n + 1 for n in before)
    assert out.shape == (B, joints, 3) and enc.shape == (B, 4 * joints, F, F)
    torch.testing.assert_close(out, offset2joint_softmax(off.float(), img,
                                                         0.4),
                               rtol=0, atol=2e-5)
    assert_stats_match(stats, offset2joint_softmax_stats(off, img))
    want = offset2joint_softmax_backward(off, img, 0.4, g)
    atol = BACKWARD_ATOL[dtype] * float(want.float().abs().max())
    torch.testing.assert_close(grad.float(), want.float(), rtol=0, atol=atol)
    torch.testing.assert_close(enc, joint2offset(jt, img, 0.4, F), rtol=0,
                               atol=1e-5)


def test_decode_offsets_has_a_kernel_gradient(cuda):
    """One forward launch and one backward launch, the backward from the
    statistics the forward saved."""
    off, img, _ = inputs(cuda, 3, 16)
    x = off.clone().requires_grad_()
    before = (decode_cuda.LAUNCHES, decode_cuda.BACKWARD_LAUNCHES)
    out = decode_offsets(x, img, 0.4)
    assert out.grad_fn is not None
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 4
    assert_stats_match(saved[3], offset2joint_softmax_stats(off, img))
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


def int_mm(a, b):
    """``torch._int_mm(a, b)``, or None where cuBLAS refuses the shape (K
    and N must be multiples of 8; K = 48 is refused too)."""
    if a.shape[1] % 8 or b.shape[1] % 8:
        return None
    try:
        return torch._int_mm(a, b)
    except RuntimeError:
        return None


# (M, K, N): odd M and K % 16 != 0 (the byte-load path), the stem,
# layer1's 3x3, a deconv phase's shape; layer4's 3x3 at buckets 32 and 8
# (the latter splits K); N no multiple of the tile (24, 40); M below one
# warpgroup's 64 rows; K = 48, no multiple of the 128-byte K stage;
# N % 4 != 0 (the tile stored from registers), also where N % 4 == 0
# would split K
GEMM_SHAPES = [(1000, 25, 64), (333, 40, 24), (4096, 576, 64),
               (32768, 1024, 256), (2048, 4608, 512), (512, 4608, 512),
               (1000, 256, 24), (777, 128, 40), (37, 512, 128),
               (300, 48, 64), (100, 64, 30), (512, 4608, 510)]


@pytest.mark.parametrize("M,K,N", GEMM_SHAPES)
def test_int8_gemm_kernel_matches_plain(cuda, M, K, N):
    a, b = int8_codes(cuda, (M, K), M), int8_codes(cuda, (K, N), K)
    before = int8_cuda.GEMM_LAUNCHES
    got = int8_cuda.int8_matmul_cuda(a, b)
    torch.cuda.synchronize()
    assert int8_cuda.GEMM_LAUNCHES == before + 1
    assert got.dtype == torch.int32 and got.shape == (M, N)
    assert torch.equal(got, int8.int8_matmul(a, b))
    lib = int_mm(a, b)
    assert lib is None or torch.equal(got, lib)
    # B as the transposed view of a conv weight: the same result
    assert torch.equal(int8_cuda.int8_matmul_cuda(a, b.t().contiguous().t()),
                       got)


# layer4's 3x3 convs at bucket 8: 32 tiles, so K is split
@pytest.mark.parametrize("M,K,N", [(512, 4608, 512), (512, 2304, 512)])
def test_int8_gemm_split_k_is_deterministic(cuda, M, K, N):
    """Split-K adds int32 partial sums with atomics in any order: integer
    addition is associative, so two runs agree bit for bit."""
    assert int8_cuda.gemm_plan(M, K, N).split > 1
    a, b = int8_codes(cuda, (M, K), 1), int8_codes(cuda, (K, N), 2)
    first = int8_cuda.int8_matmul_cuda(a, b)
    second = int8_cuda.int8_matmul_cuda(a, b)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert torch.equal(first, int8.int8_matmul(a, b))


def test_int8_gemm_unaligned_operand(cuda):
    """A view whose base is not 16-byte aligned is copied for TMA."""
    base = int8_codes(cuda, (300 * 64 + 1,), 3)
    a = base[1:].view(300, 64)
    b = int8_codes(cuda, (64, 128), 4)
    assert a.data_ptr() % 16 != 0
    assert torch.equal(int8_cuda.int8_matmul_cuda(a, b),
                       int8.int8_matmul(a, b))


def test_library_smem_matches_the_plan(cuda):
    for bn in (0, 64, 128):
        assert int8_cuda.library_smem(bn) == int8_cuda.tc_smem(bn)


# (B, H, W, C_in, C_out): resnet_18's three decoder deconvs at B = 2,
# deconv0 at bucket 8, an odd shape (odd W: the output is stored from
# shared memory by the threads, not by TMA), an even W with partial pixel
# and channel tiles (TMA clips the output box; in bfloat16, W % 4 == 2:
# stored by the threads), and W % 4 == 0 with partial tiles (TMA in both)
DECONV_SHAPES = [(2, 8, 8, 512, 256), (2, 16, 16, 256, 256),
                 (2, 32, 32, 256, 256), (8, 8, 8, 512, 256),
                 (3, 5, 7, 16, 24), (2, 6, 10, 32, 200),
                 (2, 6, 12, 32, 200)]


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,cin,cout", DECONV_SHAPES)
def test_int8_deconv_kernel_matches_plain(cuda, B, H, W, cin, cout,
                                          out_dtype):
    """Bit-equal in both output dtypes: the same float32 product, rounded
    once to bfloat16 in the kernel's epilogue and in the plain version."""
    xq = int8_codes(cuda, (B, H, W, cin), H)
    wq = int8_codes(cuda, (cin, cout, 4, 4), cin)
    scale = torch.empty(cout, device=cuda).uniform_(
        0.5, 2.0, generator=torch.Generator(cuda).manual_seed(cout))
    counter = ("DECONV_BF16_LAUNCHES" if out_dtype == torch.bfloat16
               else "DECONV_LAUNCHES")
    before = (int8_cuda.DECONV_LAUNCHES, int8_cuda.DECONV_BF16_LAUNCHES)
    got = int8_cuda.deconv4x4s2_int8_cuda(xq, wq, scale, out_dtype)
    torch.cuda.synchronize()
    after = (int8_cuda.DECONV_LAUNCHES, int8_cuda.DECONV_BF16_LAUNCHES)
    assert [a - b for a, b in zip(after, before)] == (
        [0, 1] if counter == "DECONV_BF16_LAUNCHES" else [1, 0])
    assert got.shape == (B, cout, 2 * H, 2 * W) and got.dtype == out_dtype
    assert torch.equal(got, int8.deconv4x4s2_int8(xq, wq, scale, out_dtype))


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_int8_resnet18_request_launches(cuda, compute_dtype):
    """One int8 request: 20 GEMMs (every encoder conv), 3 deconvs (with
    the compute dtype's output), 1 decode, and nothing else; the joints
    stay near the float32 ones."""
    cfg = resnet_config(img_size=64, compute_dtype=compute_dtype)
    model = torch_default_init_(build_model(cfg.net, cfg.jt_num),
                                torch.Generator().manual_seed(0))
    pred = Predictor(cfg, model, device=cuda)
    fp32 = Predictor(cfg.replace(compute_dtype="float32"),
                     build_model(cfg.net, cfg.jt_num), device=cuda)
    fp32.model.load_state_dict(model.state_dict())
    img = np.random.RandomState(0).uniform(-1, 1, (8, 64, 64)).astype(
        np.float32)
    fp = fp32.predict_normalized(img)
    pred.quantize(img)
    counters = lambda: (int8_cuda.GEMM_LAUNCHES,  # noqa: E731
                        int8_cuda.DECONV_LAUNCHES,
                        int8_cuda.DECONV_BF16_LAUNCHES,
                        decode_cuda.LAUNCHES, encode_cuda.LAUNCHES)
    before = counters()
    q8 = pred.predict_normalized(img)
    after = counters()
    deconvs = [0, 3] if compute_dtype == "bfloat16" else [3, 0]
    assert [y - x for x, y in zip(before, after)] == [20, *deconvs, 1, 0]
    assert np.isfinite(q8).all() and np.abs(q8 - fp).max() < 0.05


@pytest.mark.parametrize("net", ["hourglass_1", "resnet_18"])
def test_remat_step_on_the_card(cuda, net):
    """One train step with and without remat from the same weights: the
    batch counters equal; the running statistics and the gradients
    within 1e-4 of each tensor's max |value| (some cuDNN kernels sum in
    another order from one launch to the next; a second BatchNorm update
    would move a statistic by 90 % of the first).  Conv biases that feed
    a train-mode BatchNorm have a gradient of 0 in exact arithmetic, so
    theirs is roundoff and is left out."""
    from awr_tpu_torch.config import hourglass_config
    from awr_tpu_torch.training.optim import make_optimizer
    from awr_tpu_torch.training.steps import make_train_step

    _, img, jt = inputs(cuda, 4, 32, H=64)
    cfg = (resnet_config if net.startswith("resnet") else hourglass_config)(
        img_size=64, coord_weight=1.0)
    sd = torch_default_init_(build_model(net, J),
                             torch.Generator().manual_seed(0)).state_dict()
    runs = []
    for remat in (False, True):
        model = build_model(net, J, remat=remat)
        model.load_state_dict(sd)
        model.to(cuda)
        make_train_step(model, make_optimizer(model.parameters(), "adam",
                                              1e-3), cfg)(
            dict(img=img, jt_uvd=jt))
        runs.append(({k: p.grad for k, p in model.named_parameters()},
                     dict(model.named_buffers())))
    (g0, b0), (g1, b1) = runs
    roundoff = {f"{n}.bias" for n, m in model.named_modules()
                if isinstance(m, torch.nn.Conv2d) and m.bias is not None
                and not n.startswith(("outs_1.", "outs_2.", "final"))}

    def close(got, want):
        return float((got - want).abs().max()) <= 1e-4 * float(
            want.abs().max())

    for k in b0:
        if k.endswith("num_batches_tracked"):
            assert torch.equal(b0[k], b1[k]) and int(b1[k]) == 1, k
        else:
            assert close(b1[k], b0[k]), k
    for k in g0:
        if k not in roundoff:
            assert close(g1[k], g0[k]), k


@pytest.mark.parametrize("net", ["hourglass_1", "resnet_18"])
def test_bf16_train_step_on_the_card(cuda, net):
    """A bf16 train step on the card: cuDNN takes the bf16 convs and the
    bf16 input of the float32 BatchNorms; the parameters, their
    gradients and the running statistics stay float32; the loss (of the
    float32 map) within 5 % of the float32 step's from the same weights
    (on the CPU: 0.07-0.23 %).  The gradients are not compared: at
    random weights, bf16 and float32 gradients of one step point apart
    (cosine 0.46-0.65 on the CPU, the JAX package's alike)."""
    from awr_tpu_torch.config import hourglass_config
    from awr_tpu_torch.training.optim import make_optimizer
    from awr_tpu_torch.training.steps import make_train_step

    _, img, jt = inputs(cuda, 4, 32, H=64)
    cfg = (resnet_config if net.startswith("resnet") else hourglass_config)(
        img_size=64, coord_weight=0.1)
    sd = torch_default_init_(build_model(net, J),
                             torch.Generator().manual_seed(0)).state_dict()
    losses = {}
    for dtype in (torch.float32, torch.bfloat16):
        model = build_model(net, J, compute_dtype=dtype)
        model.load_state_dict(sd)
        model.to(cuda)
        m = make_train_step(model, make_optimizer(model.parameters(), "adam",
                                                  1e-3), cfg)(
            dict(img=img, jt_uvd=jt))
        losses[dtype] = float(m["loss"])
        assert all(p.dtype == p.grad.dtype == torch.float32
                   for p in model.parameters())
        assert all(b.dtype in (torch.float32, torch.int64)
                   for b in model.buffers())
    assert np.isfinite(losses[torch.bfloat16])
    np.testing.assert_allclose(losses[torch.bfloat16], losses[torch.float32],
                               rtol=0.05)


def test_trainer_epoch_on_the_card(cuda, tmp_path):
    """One raw-mode epoch of the Trainer on the card: pinned staging on
    the steps' stream, one encode, decode and decode backward a train
    step, one encode and decode an eval step, a checkpoint."""
    from awr_tpu_torch.config import hourglass_config
    from awr_tpu_torch.data.synthetic import SyntheticHandDataset
    from awr_tpu_torch.training.trainer import Trainer

    cfg = hourglass_config(img_size=32, batch_size=4, vis_freq=0,
                           print_freq=1000, max_epoch=1, coord_weight=0.1)
    tr = Trainer(cfg,
                 SyntheticHandDataset(8, J, 32, phase="train", mode="raw"),
                 SyntheticHandDataset(4, J, 32, phase="test", seed=1,
                                      mode="raw"),
                 workdir=str(tmp_path), device="cuda")
    before = (encode_cuda.LAUNCHES, decode_cuda.LAUNCHES,
              decode_cuda.BACKWARD_LAUNCHES)
    tr.train()
    tr.close()
    after = (encode_cuda.LAUNCHES, decode_cuda.LAUNCHES,
             decode_cuda.BACKWARD_LAUNCHES)
    assert [a - b for a, b in zip(after, before)] == [3, 3, 2]
    assert (tmp_path / "ckpt" / "1.pth").exists()
    assert tr.best_records["epoch"] == 1
    assert np.isfinite(tr.best_records["MPE"])


def hourglass_int8_predictor(cuda, compute_dtype="float32", img=64):
    from awr_tpu_torch.config import hourglass_config

    cfg = hourglass_config(img_size=img, compute_dtype=compute_dtype)
    model = torch_default_init_(build_model(cfg.net, cfg.jt_num),
                                torch.Generator().manual_seed(0))
    return Predictor(cfg, model, device=cuda)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_int8_hourglass_request_launches(cuda, compute_dtype):
    """One int8 hourglass_1 request: 55 int8 GEMMs (the stem, every
    residual conv and skip, feature_conv; not the heads or merges), one
    decode, nothing else; a contiguous map; joints near the float32
    ones."""
    pred = hourglass_int8_predictor(cuda, compute_dtype)
    fp32 = hourglass_int8_predictor(cuda)
    fp32.model.load_state_dict(pred.model.state_dict())
    img = np.random.RandomState(1).uniform(-1, 1, (8, 64, 64)).astype(
        np.float32)
    fp = fp32.predict_normalized(img)
    pred.quantize(img)
    before = (int8_cuda.GEMM_LAUNCHES, decode_cuda.LAUNCHES,
              encode_cuda.LAUNCHES)
    q8 = pred.predict_normalized(img)
    after = (int8_cuda.GEMM_LAUNCHES, decode_cuda.LAUNCHES,
             encode_cuda.LAUNCHES)
    assert [y - x for x, y in zip(before, after)] == [55, 1, 0]
    with torch.no_grad():
        maps = pred.model(torch.from_numpy(img).to(cuda)[:, None])
    assert maps.is_contiguous()
    assert np.isfinite(q8).all() and np.abs(q8 - fp).max() < 0.05


def test_int8_gemm_past_2_31_elements(cuda):
    """The int8 hourglass_1 stem's 3x3 GEMM at B = 256: 4,194,304 rows of
    K = 576, an A of 2.4e9 bytes (M * K past 2**31)."""
    M, K, N = 256 * 128 * 128, 576, 64
    a = int8_codes(cuda, (M, K), 1)
    b = int8_codes(cuda, (N, K), 2).t()
    got = int8_cuda.int8_matmul_cuda(a, b)
    assert torch.equal(got, int8.int8_matmul(a, b))


@pytest.mark.parametrize("net", ["hourglass_1", "resnet_18"])
def test_qat_on_the_card(cuda, net):
    """quantize_qat on the card: per QAT step one encode, one decode and
    one decode backward, no int8 kernel; the holdout scores both
    candidates through the int8 kernels; a ruinous lr falls back to the
    PTQ weights and BatchNorm statistics bit for bit."""
    from awr_tpu_torch.config import hourglass_config, resnet_config

    make = hourglass_config if net.startswith("hourglass") else resnet_config
    cfg = make(img_size=64)
    model = torch_default_init_(build_model(cfg.net, cfg.jt_num),
                                torch.Generator().manual_seed(0))
    rng = np.random.RandomState(2)
    tune = {"img": rng.uniform(-1, 1, (4, 64, 64)).astype(np.float32),
            "jt_uvd": rng.uniform(-0.8, 0.8, (4, J, 3)).astype(np.float32)}
    pred = Predictor(cfg, model, device=cuda)
    pred.quantize(tune["img"])
    layers = pred.quant
    gemms = 55 if net.startswith("hourglass") else 20
    deconvs = len(layers) - gemms
    counters = lambda: (int8_cuda.GEMM_LAUNCHES,  # noqa: E731
                        int8_cuda.DECONV_LAUNCHES, encode_cuda.LAUNCHES,
                        decode_cuda.LAUNCHES, decode_cuda.BACKWARD_LAUNCHES)
    holdout = {"img": tune["img"], "jt_uvd": pred.predict_normalized(
        tune["img"])}
    before = counters()
    losses = pred.quantize_qat([tune], steps=3, lr=1e-5,
                               holdout_batches=[holdout])
    after = counters()
    assert [y - x for x, y in zip(before, after)] == [
        2 * gemms, 2 * deconvs, 3 + 2, 3 + 2, 3]
    assert np.isfinite(losses).all()

    sd = {k: v.clone() for k, v in pred.model.state_dict().items()}
    pred.quantize_qat([tune], steps=3, lr=50.0, holdout_batches=[holdout])
    assert pred.qat_validation["fell_back"] is True
    assert all(torch.equal(v, sd[k])
               for k, v in pred.model.state_dict().items())


def test_qat_conv_ignores_global_tf32(cuda):
    """The QAT conv runs in IEEE float32 forward and backward whatever
    ``torch.backends.cudnn.allow_tf32`` says, and leaves it as it was."""
    from awr_tpu_torch.models.quant import QuantConv

    g = torch.Generator(cuda).manual_seed(3)
    x = torch.randn(8, 64, 32, 32, device=cuda, generator=g)
    m = QuantConv(64, 64, 3, 1, 1).to(cuda)
    m.mode = "qat"
    m.act_scale.fill_(float(x.abs().max()) / 127)
    out = {}
    for tf32 in (False, True):
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            xx = x.clone().requires_grad_()
            y = m(xx)
            y.square().sum().backward()
            assert torch.backends.cudnn.allow_tf32 is tf32
        finally:
            torch.backends.cudnn.allow_tf32 = False
        out[tf32] = (y.detach(), xx.grad, m.weight.grad.clone())
        m.weight.grad = None
    for a, b in zip(out[False], out[True]):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def test_quantizers_match_the_cpu_bit_for_bit(cuda):
    """Weight codes and scales, activation codes and a calibrated scale
    are the same on the card as on the CPU: an int8 Predictor on the card
    serves the CPU's integers (a scale one ulp off would move the
    dequantized outputs and flip a code at a rounding tie)."""
    from awr_tpu_torch.models import quant

    rng = np.random.RandomState(5)
    w = torch.from_numpy((rng.randn(256, 128, 3, 3)
                          * rng.uniform(1e-3, 1.0, (256, 1, 1, 1)))
                         .astype(np.float32))
    x = torch.from_numpy(rng.randn(4, 128, 16, 16).astype(np.float32))
    s = torch.tensor(0.0123, dtype=torch.float32)
    amax = torch.from_numpy(rng.uniform(1e-4, 50.0, 100_000)
                            .astype(np.float32))
    cpu = (quant._quantize_weights(w, (1, 2, 3)), quant._quantize_acts(x, s),
           quant._over_qmax(amax))
    card = (quant._quantize_weights(w.to(cuda), (1, 2, 3)),
            quant._quantize_acts(x.to(cuda), s.to(cuda)),
            quant._over_qmax(amax.to(cuda)))
    for got, want in zip(card[:2], cpu[:2]):
        for g, c in zip(got, want):
            assert torch.equal(g.cpu(), c)
    assert torch.equal(card[2].cpu(), cpu[2])


def test_predict_async_does_not_wait_for_the_next_dispatch(cuda):
    """The ``predict_async`` contract the batching layer pipelines on: a
    second request's dispatch does not wait for the first's device work,
    and the first's ``finalize`` returns while the second's work still
    runs, with the joints of a blocking ``predict``."""
    import time

    from awr_tpu_torch.config import hourglass_config
    from awr_tpu_torch.data.synthetic import synthetic_frames

    cfg = hourglass_config()
    model = build_model(cfg.net, cfg.jt_num)
    torch_default_init_(model, torch.Generator().manual_seed(0))
    pred = Predictor(cfg, model, device=cuda)
    imgs, _, centers = synthetic_frames(8, 14, seed=0)
    imgs, centers = np.tile(imgs, (16, 1, 1)), np.tile(centers, (16, 1))
    want = pred.predict(imgs, centers)
    for _ in range(2):  # the pinned blocks of two requests in flight
        first, second = (pred.predict_async(imgs, centers) for _ in "ab")
        first(), second()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    a_end = torch.cuda.Event(enable_timing=True)
    start.record()
    fin_a = pred.predict_async(imgs, centers)
    a_end.record()
    t0 = time.perf_counter()
    fin_b = pred.predict_async(imgs, centers)
    b_host_ms = (time.perf_counter() - t0) * 1e3
    b_end = torch.cuda.Event()
    b_end.record()
    out_a = fin_a()
    b_running = not b_end.query()
    out_b = fin_b()
    a_device_ms = start.elapsed_time(a_end)
    assert b_host_ms < 0.5 * a_device_ms, (b_host_ms, a_device_ms)
    assert b_running
    np.testing.assert_array_equal(out_a, want)
    np.testing.assert_array_equal(out_b, want)


@pytest.mark.parametrize("B", [3, 8])  # below the bucket of 8, and at it
def test_predict_pads_a_reversed_view_into_pinned_memory(cuda, B):
    """The pinned fill of ``predict_async`` takes a float32 view with
    negative strides, with the joints of its contiguous copy."""
    from awr_tpu_torch.config import hourglass_config
    from awr_tpu_torch.data.synthetic import synthetic_frames

    cfg = hourglass_config(img_size=64)
    model = build_model(cfg.net, cfg.jt_num)
    torch_default_init_(model, torch.Generator().manual_seed(0))
    pred = Predictor(cfg, model, device=cuda)
    imgs, _, centers = synthetic_frames(B, 14, seed=0)
    view = imgs[:, :, ::-1]
    np.testing.assert_array_equal(
        pred.predict(view, centers),
        pred.predict(np.ascontiguousarray(view), centers))
