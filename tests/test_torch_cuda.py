"""The hand-written CUDA kernels (decode and its softmax statistics,
decode backward, encode, int8 GEMM, int8 deconv) against their plain
PyTorch versions, on the card, and an int8 resnet_18 request through
them.  Needs no JAX; skips without a GPU.  On a machine with one:

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


def inputs(cuda, B, F, dtype=torch.float32, H=None):
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
# shared memory by the threads, not by TMA), and an even W with partial
# pixel and channel tiles (TMA clips the output box)
DECONV_SHAPES = [(2, 8, 8, 512, 256), (2, 16, 16, 256, 256),
                 (2, 32, 32, 256, 256), (8, 8, 8, 512, 256),
                 (3, 5, 7, 16, 24), (2, 6, 10, 32, 200)]


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


def test_trainer_epoch_on_the_card(cuda, tmp_path):
    """One raw-mode epoch of the Trainer on the card: pinned staging on
    the steps' stream, one encode, decode and decode backward a train
    step, one encode and decode an eval step, a checkpoint."""
    from awr_tpu_torch.config import hourglass_config
    from awr_tpu_torch.data.synthetic import SyntheticHandDataset
    from awr_tpu_torch.training.trainer import Trainer

    cfg = hourglass_config(img_size=32, batch_size=4, vis_freq=0,
                           print_freq=1000, max_epoch=1, coord_weight=0.1)
    tr = Trainer(cfg, SyntheticHandDataset(8, J, 32, phase="train"),
                 SyntheticHandDataset(4, J, 32, phase="test", seed=1),
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
