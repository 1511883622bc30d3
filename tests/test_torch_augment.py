"""The port's train-path device preprocessing (crop, one-of-four
augmentation, normalize, labels) against the JAX package's, on the same
raw frames and the same numpy-made augmentation parameters.

The crop's nearest-neighbour source index differs between the two for a
few crop widths: the port takes OpenCV's, in double, as the host crop
does (tests/test_torch_host_data.py holds the two crops equal), the JAX
package the float32 quotient x * w / sw.  So these tests run the port's
preprocessing with its crop gather given the JAX package's index
(``jax_crop_index``), and compare the rest as before."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import awr_tpu_torch.data.device as port_device
from awr_tpu.data.device import train_preprocess_batch as jax_preprocess
from awr_tpu_torch.config import NYU_PARAS
from awr_tpu_torch.data.device import (draw_augment_params,
                                       train_preprocess_batch)
from awr_tpu_torch.geometry import uvd2xyz_np
from test_torch_ops import J, raw_batch

DSIZE = 64
N = 8  # each op twice
LABELS = ("jt_uvd", "jt_xyz", "M", "cube", "center_xyz")


def jax_index_crop_gather(imgs, p, dsize: int):
    """The port's crop gather with the JAX package's float32 nearest index
    (``awr_tpu/data/device.py:96-105``)."""
    B, H0, W0 = imgs.shape
    dev = imgs.device
    col = lambda k: p[k].view(B, 1, 1)  # noqa: E731
    us, ue, vs, ve = col("us"), col("ue"), col("vs"), col("ve")
    sw, sh, tx, ty = col("sw"), col("sh"), col("tx"), col("ty")
    ii = torch.arange(dsize, dtype=torch.int32, device=dev).view(1, dsize, 1)
    jj = torch.arange(dsize, dtype=torch.int32, device=dev).view(1, 1, dsize)
    in_paste = (ii >= ty) & (ii < ty + sh) & (jj >= tx) & (jj < tx + sw)
    cu = torch.minimum(torch.floor(
        (jj - tx).float() * (ue - us).float()
        / torch.clamp(sw, min=1).float()).to(torch.int32), ue - us - 1)
    cv = torch.minimum(torch.floor(
        (ii - ty).float() * (ve - vs).float()
        / torch.clamp(sh, min=1).float()).to(torch.int32), ve - vs - 1)
    su, sv = us + cu, vs + cv
    in_img = (su >= 0) & (su < W0) & (sv >= 0) & (sv < H0)
    b = torch.arange(B, device=dev).view(B, 1, 1)
    val = imgs[b, sv.clamp(0, H0 - 1).long(), su.clamp(0, W0 - 1).long()]
    zero = torch.zeros((), dtype=val.dtype, device=dev)
    val = torch.where(in_img, val, zero)
    val = port_device._z_threshold(val, p["zs"].view(B, 1, 1),
                                   p["ze"].view(B, 1, 1))
    return torch.where(in_paste, val, zero)


@pytest.fixture(autouse=True)
def jax_crop_index(monkeypatch):
    monkeypatch.setattr(port_device, "_crop_gather", jax_index_crop_gather)


def inputs(op, seed=4):
    frames, centers_uvd, cubes = raw_batch(N, seed=seed)
    g = np.random.RandomState(seed)
    jt_xyz = (uvd2xyz_np(centers_uvd, NYU_PARAS, -1)[:, None]
              + g.uniform(-60, 60, (N, J, 3))).astype(np.float32)
    aug = (np.asarray(op, np.int32),
           (g.randn(N, 3) * 10).astype(np.float32),
           np.abs(1 + g.randn(N) * 0.1).astype(np.float32),
           g.uniform(-180, 180, N).astype(np.float32))
    return frames, jt_xyz, centers_uvd, cubes, aug


def both(op, seed=4):
    frames, jt_xyz, centers_uvd, cubes, aug = inputs(op, seed)
    want = jax_preprocess(frames, jt_xyz, centers_uvd, cubes,
                          np.asarray(NYU_PARAS), tuple(map(jnp.asarray, aug)),
                          DSIZE, -1)
    got = train_preprocess_batch(torch.from_numpy(frames), jt_xyz,
                                 centers_uvd, cubes, NYU_PARAS,
                                 tuple(map(torch.from_numpy, aug)), DSIZE, -1)
    return {k: np.asarray(v) for k, v in want.items()}, {
        k: v.numpy() for k, v in got.items()}


def test_no_augmentation_is_bit_identical():
    want, got = both(np.full(N, 3))
    for k in ("img",) + LABELS:
        assert got[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("seed", [4, 5])
def test_augmentations_match(seed):
    """Ops 0-2 (trans, scale, rot) twice each, op 3 twice.  Labels within
    1e-5 relative.  Images: 3x3 inverses and bilinear weights round
    differently in the two frameworks, so a pixel near the outlier or
    z-clip threshold can land on the other side of it (it then reads
    background, +1, or the near clip, -1, on one side); those are counted
    and held to 0.1 % of the pixels, every other pixel to 1e-4 and their
    mean to 1e-6."""
    op = np.array([0, 1, 2, 3, 0, 1, 2, 3])
    want, got = both(op, seed)
    for k in LABELS:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    d = np.abs(got["img"] - want["img"])
    edge = np.isin(got["img"], (1.0, -1.0)) | np.isin(want["img"], (1.0, -1.0))
    flipped = (d > 1e-4) & edge
    assert flipped.sum() <= 1e-3 * d.size, flipped.sum()
    rest = d[~flipped]
    assert rest.max() <= 1e-4 and rest.mean() < 1e-6, (rest.max(), rest.mean())
    # the warps did move the pixels
    none = got["img"][op == 3]
    assert all(np.abs(got["img"][i] - none[0]).max() > 0.1
               for i in np.flatnonzero(op != 3))


def test_draw_augment_params():
    def draw(seed):
        return draw_augment_params(torch.Generator().manual_seed(seed), 256,
                                   10.0, 0.1, 180.0)

    op, trans, scale, rot = draw(0)
    assert op.shape == (256,) and trans.shape == (256, 3)
    assert scale.shape == (256,) and rot.shape == (256,)
    assert set(op.tolist()) == {0, 1, 2, 3}
    assert (scale > 0).all() and abs(float(scale.mean()) - 1) < 0.05
    assert 5 < float(trans.std()) < 15
    assert (rot >= -180).all() and (rot < 180).all()
    for a, b in zip(draw(0), (op, trans, scale, rot)):
        assert torch.equal(a, b)
    assert not torch.equal(draw(1)[1], trans)
