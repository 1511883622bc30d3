"""The port's host data modules against the JAX package's: the synthetic
dataset's raw items, the prefetching loader, the staging thread, the
evaluator and its dumps, and the figures (numpy-drawn, written by the
port's PNG writer; cv2 reads them back here, where it is installed)."""

import threading

import cv2
import numpy as np
import pytest

from awr_tpu.data.pipeline import PrefetchLoader as JaxPrefetchLoader
from awr_tpu.data.synthetic import SyntheticHandDataset as JaxSynthetic
from awr_tpu.data.transforms import normalize_labels as jax_normalize_labels
from awr_tpu.evaluation import Evaluator as JaxEvaluator
from awr_tpu.evaluation import load_prediction_txt as jax_load_txt
from awr_tpu.vis import render_pose as jax_render_pose
from awr_tpu_torch.config import NYU_PARAS
from awr_tpu_torch.data.base import DepthDataset
from awr_tpu_torch.data.pipeline import PrefetchLoader, prefetch_to_device
from awr_tpu_torch.data.synthetic import SyntheticHandDataset
from awr_tpu_torch.data.transforms import normalize_labels
from awr_tpu_torch.evaluation import Evaluator, load_prediction_txt
from awr_tpu_torch.utils.png import write_png
from awr_tpu_torch.vis import SKELETONS, plot_pose, render_pose

N = 6


# ----------------------------------------------------------- dataset


@pytest.mark.parametrize("layout", ["random", "grid"])
@pytest.mark.parametrize("seed", [0, 1])
def test_synthetic_raw_items_bit_equal_jax(layout, seed):
    ours = SyntheticHandDataset(N, 14, 128, phase="train", seed=seed,
                                layout=layout)
    theirs = JaxSynthetic(N, 14, 128, phase="train", seed=seed,
                          layout=layout, mode="raw")
    assert len(ours) == len(theirs) == N
    np.testing.assert_array_equal(ours.joints, theirs.joints)
    np.testing.assert_array_equal(ours.centers, theirs.centers)
    for i in range(N):
        got, want = ours[i], theirs[i]
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(ours.cube_for(i), theirs.cube_for(i))
    # the render cache hands out copies
    ours.raw_item(0)[0][:] = -1
    np.testing.assert_array_equal(ours.raw_item(0)[0], theirs.raw_item(0)[0])


def test_host_mode_raises():
    with pytest.raises(NotImplementedError, match="host mode"):
        SyntheticHandDataset(2, mode="host")
    with pytest.raises(NotImplementedError, match="host mode"):
        DepthDataset().process(None, None, None, None)
    with pytest.raises(ValueError, match="layout"):
        SyntheticHandDataset(2, layout="ring")


def test_normalize_labels_matches_jax():
    rng = np.random.RandomState(2)
    args = (rng.randn(14, 3) * 50, rng.rand(14, 3) * 128 + 600,
            rng.rand(3) * 800, np.array([300.0, 280.0, 250.0]), 128)
    for got, want in zip(normalize_labels(*args),
                         jax_normalize_labels(*args)):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ loader


@pytest.mark.parametrize("workers", [1, 4])
def test_prefetch_loader_matches_jax(workers):
    """The same shuffle from the same RandomState, the same batches in
    the same order, the partial last batch included."""
    ours = PrefetchLoader(SyntheticHandDataset(7, 14, 32, seed=3), 3,
                          shuffle=True, num_workers=workers,
                          rng=np.random.RandomState(11))
    theirs = JaxPrefetchLoader(JaxSynthetic(7, 14, 32, seed=3, mode="raw"),
                               3, shuffle=True, num_workers=workers,
                               rng=np.random.RandomState(11))
    got, want = list(ours), list(theirs)
    assert len(got) == len(want) == len(ours) == 3
    assert [len(b["img"]) for b in got] == [3, 3, 1]
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_prefetch_loader_drop_last_and_worker_error():
    class Bad(SyntheticHandDataset):
        def __getitem__(self, i):
            if i == 4:
                raise KeyError("bad item")
            return super().__getitem__(i)

    loader = PrefetchLoader(SyntheticHandDataset(7, 14, 32), 3,
                            drop_last=True)
    assert len(loader) == 2 and len(list(loader)) == 2
    with pytest.raises(KeyError, match="bad item"):
        list(PrefetchLoader(Bad(7, 14, 32), 2, num_workers=2))


@pytest.mark.parametrize("depth", [0, 2])
def test_prefetch_to_device_keeps_order(depth):
    threads = set()

    def stage(x):
        threads.add(threading.get_ident())
        return x * 10

    assert list(prefetch_to_device(iter(range(20)), stage, depth)) == [
        10 * i for i in range(20)]
    # depth 0 stages inline, otherwise one stager thread
    assert (threading.get_ident() in threads) == (depth == 0)
    assert len(threads) == 1


def test_prefetch_to_device_reraises_staging_error():
    def stage(x):
        if x == 3:
            raise ValueError("staging failed")
        return x

    got = []
    with pytest.raises(ValueError, match="staging failed"):
        for x in prefetch_to_device(iter(range(10)), stage, 2):
            got.append(x)
    assert got == [0, 1, 2]


# --------------------------------------------------------- evaluator


def eval_inputs(seed, singular):
    rng = np.random.RandomState(seed)
    B = 5
    M = np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))
    M[:, 0, 0] = M[:, 1, 1] = rng.uniform(0.3, 0.6, B)
    M[:, :2, 2] = rng.uniform(-200, 0, (B, 2))
    if singular:
        M[2] = 0.0  # a degenerate transmat: scored through pinv
    return (rng.uniform(-1, 1, (B, 14, 3)).astype(np.float32),
            rng.uniform(-1, 1, (B, 14, 3)).astype(np.float32),
            np.stack([rng.uniform(-80, 80, B), rng.uniform(-60, 60, B),
                      rng.uniform(650, 950, B)], 1).astype(np.float32),
            M, np.full((B, 3), 300.0, np.float32))


def evaluators(singular):
    ours = Evaluator(128, NYU_PARAS, -1, 14)
    theirs = JaxEvaluator(128, NYU_PARAS, -1, 14)
    for seed in (1, 2):
        args = eval_inputs(seed, singular)
        ours.feed_batch(*args)
        theirs.feed_batch(*args)
    single = [a[0] for a in eval_inputs(3, False)]
    ours.feed(*single)
    theirs.feed(*single)
    return ours, theirs


@pytest.mark.parametrize("singular", [False, True],
                         ids=["regular", "singular_M"])
def test_evaluator_matches_jax(singular):
    ours, theirs = evaluators(singular)
    got, want = ours.get_measures(), theirs.get_measures()
    np.testing.assert_allclose(got[:3], want[:3], rtol=1e-6)
    for g, w in zip(got[3:], want[3:]):
        np.testing.assert_allclose(g, w, rtol=1e-6)
    np.testing.assert_array_equal(ours.distances, theirs.distances)
    np.testing.assert_array_equal(ours.predictions_uvd,
                                  theirs.predictions_uvd)
    assert np.isfinite(ours.distances).all()


def test_save_predictions_text_identical(tmp_path):
    ours, theirs = evaluators(True)
    a, b = tmp_path / "ours.txt", tmp_path / "theirs.txt"
    ours.save_predictions(str(a))
    theirs.save_predictions(str(b))
    assert a.read_text() == b.read_text()
    np.testing.assert_array_equal(load_prediction_txt(str(a)),
                                  jax_load_txt(str(b)))


# ----------------------------------------------------------- figures


def test_png_writer_round_trips_through_cv2(tmp_path):
    rng = np.random.RandomState(0)
    rgb = rng.uniform(-20, 280, (9, 13, 3))
    gray = rng.randint(0, 256, (5, 7))
    write_png(str(tmp_path / "rgb.png"), rgb)
    write_png(str(tmp_path / "gray.png"), gray)
    # cv2 reads BGR; both sides round half to even and saturate
    want = np.clip(np.rint(rgb), 0, 255).astype(np.uint8)[..., ::-1]
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "rgb.png")),
                                  want)
    np.testing.assert_array_equal(
        cv2.imread(str(tmp_path / "gray.png"), cv2.IMREAD_GRAYSCALE), gray)
    with pytest.raises(ValueError, match="expected"):
        write_png(str(tmp_path / "bad.png"), np.zeros((2, 2, 4)))


def test_plot_pck_writes_a_png(tmp_path):
    ours, _ = evaluators(False)
    path = str(tmp_path / "pck.png")
    ours.plot_pck(path)
    img = cv2.imread(path)
    assert img is not None and img.shape == (480, 640, 3)
    # the curve's color is on the figure, on a white background
    assert (img == (180, 119, 31)).all(-1).any()
    assert (img == 255).all(-1).mean() > 0.5


@pytest.mark.parametrize("dataset", sorted(SKELETONS))
def test_render_pose_matches_jax(dataset):
    """At least 99 % of the pixels as cv2 draws them (measured: all),
    and exactly at every joint's center."""
    rng = np.random.RandomState(len(dataset))
    J = max(max(g) for g in SKELETONS[dataset][0]) + 1
    img = rng.uniform(-1, 1, (1, 128, 128)).astype(np.float32)
    # predictions partly off the crop, so lines are clipped
    pred = rng.uniform(-30, 160, (J, 3))
    gt = rng.uniform(0, 127, (J, 3))
    got = render_pose(img, pred, gt, dataset)
    want = jax_render_pose(img, pred, gt, dataset)
    assert got.shape == want.shape == (128, 128, 3)
    assert (got == want).all(-1).mean() >= 0.99
    for jt in (pred, gt):
        for u, v, _ in jt:
            x, y = int(u), int(v)
            if 0 <= x < 128 and 0 <= y < 128:
                np.testing.assert_array_equal(got[y, x], want[y, x])


def test_plot_pose_writes_a_png_cv2_reads(tmp_path):
    rng = np.random.RandomState(5)
    img = rng.uniform(-1, 1, (64, 64)).astype(np.float32)
    pred, gt = rng.uniform(0, 63, (14, 3)), rng.uniform(0, 63, (14, 3))
    path = str(tmp_path / "pose.png")
    plot_pose(img, path, pred, gt)
    want = np.clip(np.rint(jax_render_pose(img, pred, gt)), 0, 255)
    np.testing.assert_array_equal(cv2.imread(path), want.astype(np.uint8))
