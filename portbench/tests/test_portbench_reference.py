"""The benchmark's plain reference against the program's CPU path, at
small sizes, on the same seeded weights and inputs; and the FLOP counts
the ``mfu.*`` metrics divide by."""

import copy

import numpy as np
import pytest
import torch

from awr_tpu_torch.data import device as port_device
from awr_tpu_torch.data.synthetic import render_hand_depth
from awr_tpu_torch.models import build_model
from awr_tpu_torch.ops import functional as port_ops
from awr_tpu_torch.ops.loss import smooth_l1_loss
from awr_tpu_torch.training.optim import make_optimizer
from awr_tpu_torch.training.steps import make_train_step
from portbench import frames, harness, weights
from portbench.reference import awr, data, models, steps

NETS = ("hourglass_1", "resnet_18")


def small(net: str) -> dict:
    """The configuration at img 32 on 48x64 frames, intrinsics scaled to
    them (widths as published)."""
    cfg = harness.config(net)
    return dict(cfg, img_size=32, feature_size=16, frame_shape=[48, 64],
                paras=[58.803, 58.707, 32.0, 24.0])


def pool(cfg, n=8, seed=5):
    return frames.Pool(cfg, n, seed, "cpu")


def crops(cfg, p):
    c_uvd = data.xyz2uvd_np(p.centers, p.paras, p.flip)
    img, M = data.eval_crops(torch.from_numpy(p.frames), c_uvd,
                             p.cubes(len(p)), p.paras, cfg["img_size"])
    return img, M, c_uvd


@pytest.mark.parametrize("net", NETS)
def test_state_dict_layout(net):
    cfg = small(net)
    with torch.device("meta"):
        ref = models.build(cfg).state_dict()
        port = build_model(net, cfg["joint_num"], cfg["downsample"]
                           ).state_dict()
    assert {k: tuple(v.shape) for k, v in ref.items()} == {
        k: tuple(v.shape) for k, v in port.items()}


@pytest.mark.parametrize("net", NETS)
@pytest.mark.parametrize("train", [False, True])
def test_forward(net, train, one_thread):
    cfg = small(net)
    p = pool(cfg)
    state = weights.make(cfg, 11, p, "cpu")
    ref = weights.reference_model(cfg, state, "cpu")
    port = build_model(net, cfg["joint_num"], cfg["downsample"])
    port.load_state_dict(state)
    img = crops(cfg, p)[0][:, None]
    ref.train(train), port.train(train)
    with torch.no_grad():
        want = models.stacked(ref(img))
        got = models.stacked(port(img))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    # the heads were scaled to the offset and heatmap spread
    J = cfg["joint_num"]
    if not train:
        assert abs(float(want[-1][:, :3 * J].std()) - 0.3) < 0.1
        assert abs(float(want[-1][:, 3 * J:].std()) - 0.05) < 0.02


def test_weights_repeat_and_differ_by_seed():
    cfg = small("resnet_18")
    p = pool(cfg)
    a, b = weights.make(cfg, 3, p, "cpu"), weights.make(cfg, 3, p, "cpu")
    c = weights.make(cfg, 2 ** 31 + 7, p, "cpu")
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["layer1.0.conv1.weight"],
                           c["layer1.0.conv1.weight"])


def test_encode_decode_loss():
    g = torch.Generator().manual_seed(0)
    B, J, F, H = 3, 14, 16, 32
    img = torch.rand(B, H, H, generator=g) * 2 - 1
    img[:, :4] = 1.0
    off = torch.randn(B, 4 * J, F, F, generator=g) * 0.3
    jt = torch.rand(B, J, 3, generator=g) * 2 - 1
    for k in (0.4, 1.0):
        torch.testing.assert_close(awr.decode(off, img, k),
                                   port_ops.offset2joint_softmax(off, img, k),
                                   rtol=0, atol=0)
        torch.testing.assert_close(awr.encode(jt, img, k, F),
                                   port_ops.joint2offset(jt, img, k, F),
                                   rtol=0, atol=0)
    torch.testing.assert_close(awr.smooth_l1(off, off * 0.5),
                               smooth_l1_loss(off, off * 0.5), rtol=1e-6,
                               atol=0)


def test_eval_crops_equal_program():
    cfg = small("hourglass_1")
    p = pool(cfg)
    img, M, c_uvd = crops(cfg, p)
    got, M_p = port_device.crop_normalize_batch(
        torch.from_numpy(p.frames), c_uvd, p.cubes(len(p)),
        np.asarray(p.paras), cfg["img_size"])
    assert torch.equal(img, got)
    np.testing.assert_array_equal(M.astype(np.float32), M_p)


def test_train_batch_equal_program():
    cfg = small("hourglass_1")
    p = pool(cfg)
    B = len(p)
    aug = data.draw_augment_params(torch.Generator().manual_seed(
        data.augment_seed(9, 1, 0)), B, 10.0, 0.1, 180.0)
    aug_p = port_device.draw_augment_params(torch.Generator().manual_seed(
        data.augment_seed(9, 1, 0)), B, 10.0, 0.1, 180.0)
    for a, b in zip(aug, aug_p):
        assert torch.equal(a, b)
    img, jt_uvd = data.train_batch(
        torch.from_numpy(p.frames), p.joints, p.centers, p.cubes(B),
        p.paras, p.flip, aug, cfg["img_size"])
    c_uvd = data.xyz2uvd_np(p.centers, p.paras, p.flip).astype(np.float64)
    want = port_device.train_preprocess_batch(
        torch.from_numpy(p.frames), p.joints, c_uvd, p.cubes(B), p.paras,
        aug_p, cfg["img_size"], p.flip)
    torch.testing.assert_close(img, want["img"], rtol=0, atol=0)
    torch.testing.assert_close(jt_uvd, want["jt_uvd"], rtol=1e-6, atol=1e-6)


def test_adam_against_torch():
    g = torch.Generator().manual_seed(1)
    w = torch.randn(50, generator=g, dtype=torch.float64)
    a, b = w.clone().requires_grad_(), w.clone().requires_grad_()
    ref, port = steps.Adam([a], 1e-3), make_optimizer([b], "adam", 1e-3)
    for _ in range(3):
        grad = torch.randn(50, generator=g, dtype=torch.float64)
        a.grad, b.grad = grad.clone(), grad.clone()
        ref.step(), port.step()
    torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("net", NETS)
def test_train_step_against_program(net, one_thread):
    cfg = small(net)
    p = pool(cfg)
    state = weights.make(cfg, 4, p, "cpu")
    ref = weights.reference_model(cfg, state, "cpu")
    port = build_model(net, cfg["joint_num"], cfg["downsample"])
    port.load_state_dict(copy.deepcopy(state))
    from awr_tpu_torch.config import Config

    pcfg = Config(net=net, img_size=cfg["img_size"],
                  kernel_size=cfg["kernel_size"])
    opt_r = steps.Adam(ref.parameters(), 1e-3)
    step = make_train_step(port, make_optimizer(port.parameters(), "adam",
                                                1e-3), pcfg)
    img = crops(cfg, p)[0]
    jt = torch.rand(len(p), cfg["joint_num"], 3,
                    generator=torch.Generator().manual_seed(2)) - 0.5
    loss, jt_ref = steps.train_step(ref, opt_r, img, jt, cfg)
    m = step({"img": img, "jt_uvd": jt})
    torch.testing.assert_close(m["loss"], loss, rtol=1e-5, atol=0)
    torch.testing.assert_close(m["jt_uvd_pred"], jt_ref, rtol=1e-5,
                               atol=1e-6)
    names = dict(port.named_parameters())
    for n, q in ref.named_parameters():
        torch.testing.assert_close(q, names[n], rtol=1e-4, atol=1e-5)


def test_render_equals_program():
    cfg = small("hourglass_1")
    centers, joints = frames.hand_poses(3, cfg["joint_num"], 8)
    got = frames.render(joints, cfg["paras"], cfg["flip"], (48, 64), "cpu")
    big = frames.render(joints, harness.config("hourglass_1")["paras"], -1,
                        (480, 640), "cpu")
    for k in range(3):
        assert np.array_equal(big[k], render_hand_depth(
            centers[k], joints[k], harness.config("hourglass_1")["paras"]))
    assert got.shape == (3, 48, 64) and (got > 0).any()


@pytest.mark.parametrize("net,fwd,fwd_bwd", [("hourglass_1", 11.44, 34.26),
                                             ("resnet_18", 7.55, 22.60)])
def test_flops_pinned(net, fwd, fwd_bwd):
    cfg = harness.config(net)
    assert round(harness.reference_flops(cfg, False) / 1e9, 2) == fwd
    assert round(harness.reference_flops(cfg, True) / 1e9, 2) == fwd_bwd


@pytest.mark.parametrize("net", ["hourglass_1", "resnet_18"])
def test_reference_built_from_the_file(net):
    cfg = harness.config(net)
    with torch.device("meta"):
        n = sum(p.numel() for p in models.build(cfg).parameters())
    assert n == cfg["assumed"]["parameters"]
    # the file's widths drive the model
    wide = ({"inp_dim": 128} if cfg["arch"] == "hourglass"
            else {"stage_channels": [32, 64, 128, 256],
                  "deconv_channels": 128})
    with torch.device("meta"):
        narrow = models.build(dict(cfg, **wide))
    assert sum(p.numel() for p in narrow.parameters()) < n / 3
