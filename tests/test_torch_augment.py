"""The port's train-path device preprocessing (crop, one-of-four
augmentation, normalize, labels) against the JAX package's, on the same
raw frames and the same numpy-made augmentation parameters."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from awr_tpu.data.device import train_preprocess_batch as jax_preprocess
from awr_tpu_torch.config import NYU_PARAS
from awr_tpu_torch.data.device import (draw_augment_params,
                                       train_preprocess_batch)
from awr_tpu_torch.geometry import uvd2xyz_np
from test_torch_ops import J, raw_batch

DSIZE = 64
N = 8  # each op twice
LABELS = ("jt_uvd", "jt_xyz", "M", "cube", "center_xyz")


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
