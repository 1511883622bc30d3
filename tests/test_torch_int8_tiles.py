"""The host side of the int8 tensor-core kernels, on the CPU: the tile and
split chooser (``gemm_plan``, ``deconv_plan``) over every int8 GEMM and
deconv of resnet_18 and resnet_50 at the serving buckets, and the kernel
library's hash over the headers it includes."""

import pytest
import torch

from awr_tpu_torch import kernels
from awr_tpu_torch.models import build_model
from awr_tpu_torch.models.quant import QuantConv, QuantConvTranspose
from awr_tpu_torch.ops import int8_cuda

BUCKETS = (8, 32, 256)


def layer_shapes(net):
    """Per-sample (M / B, K, N) of every int8 conv and (H, W, C_in, C_out)
    of every int8 deconv of ``net`` at img 128, ds 2, from one float
    forward at B = 1."""
    model = build_model(net, 14, 2).eval()
    convs, deconvs = [], []

    def record(m, args):
        _, c, H, W = args[0].shape
        if isinstance(m, QuantConvTranspose):
            deconvs.append((H, W, c, m.out_channels))
            return
        (kh, kw), (sh, sw), (ph, pw) = m.kernel_size, m.stride, m.padding
        M = ((H + 2 * ph - kh) // sh + 1) * ((W + 2 * pw - kw) // sw + 1)
        convs.append((M, c * kh * kw, m.out_channels))

    hooks = [m.register_forward_pre_hook(record) for m in model.modules()
             if isinstance(m, (QuantConv, QuantConvTranspose))]
    with torch.no_grad():
        model(torch.zeros(1, 1, 128, 128))
    for h in hooks:
        h.remove()
    return convs, deconvs


@pytest.fixture(scope="module", params=["resnet_18", "resnet_50"])
def shapes(request):
    return request.param, layer_shapes(request.param)


def test_resnet_layer_counts(shapes):
    net, (convs, deconvs) = shapes
    assert len(convs) == {"resnet_18": 20, "resnet_50": 53}[net]
    assert len(deconvs) == 3


@pytest.mark.parametrize("bucket", BUCKETS)
def test_gemm_plan_covers_k_and_fits(shapes, bucket):
    _, (convs, _) = shapes
    for m, K, N in convs:
        M = m * bucket
        plan = int8_cuda.gemm_plan(M, K, N)
        if K % 16:
            # TMA needs 16-byte strides: the byte-load kernel
            assert plan.path == "dp4a" and plan.split == 1
            continue
        assert plan.path == "wgmma" and plan.bn in (64, 128)
        stages = -(-K // int8_cuda.BK)
        # every split walks stages, and together they walk K once
        assert plan.split >= 1 and plan.per_split >= 1
        assert (plan.split - 1) * plan.per_split < stages
        assert plan.split * plan.per_split >= stages
        assert stages * int8_cuda.BK >= K
        assert plan.split == 1 or N % 4 == 0
        assert plan.smem == int8_cuda.tc_smem(plan.bn)
        assert 0 < plan.smem <= int8_cuda.SMEM_LIMIT


@pytest.mark.parametrize("bucket", BUCKETS)
def test_deconv_plan_fits(shapes, bucket):
    _, (_, deconvs) = shapes
    for H, W, c_in, c_out in deconvs:
        plan = int8_cuda.deconv_plan(bucket, H, W, c_in, c_out)
        assert plan.tw * plan.th * plan.tb == int8_cuda.BM
        assert max(plan.tw, plan.th, plan.tb) <= 256  # a TMA box's limit
        # the tiles cover the images (the last ones partly past the edge)
        assert plan.tw <= 2 * W and plan.th * plan.tb <= 2 * H * bucket
        assert c_in % 16 == 0
        # the staged float32 output tile fits in the ring it reuses
        assert 8 * int8_cuda.BM * int8_cuda.DECONV_BN <= plan.smem
        assert plan.smem == int8_cuda.tc_smem(0) <= int8_cuda.SMEM_LIMIT


def test_stem_takes_the_byte_load_path():
    assert int8_cuda.gemm_plan(32 * 64 * 64, 25, 64).path == "dp4a"
    assert int8_cuda.gemm_plan(100, 48, 24).path == "wgmma"
    # N % 4 != 0: C's rows are no TMA stride, so the tile is stored from
    # registers and K is never split
    plan = int8_cuda.gemm_plan(512, 4608, 510)
    assert plan.path == "wgmma" and plan.split == 1
    assert int8_cuda.gemm_plan(512, 4608, 512).split > 1


def test_library_hash_covers_headers(tmp_path, monkeypatch):
    """An edited header under csrc/ gives a new library path, so a
    source that includes it is rebuilt rather than a stale build loaded."""
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    first = kernels.library_path("k")
    assert kernels.library_path("k") == first
    (tmp_path / "h.cuh").write_text("// two\n")
    assert kernels.library_path("k") != first
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n// edited\n')
    assert kernels.library_path("k") != first
