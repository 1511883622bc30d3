"""The port's dynamic batching (``awr_tpu_torch/batching.py``) against the
JAX package's ``awr_tpu/batching.py``: the service-time model bit for
bit, the dispatch decisions under one fake clock, the joints of a
batched hourglass_1 on both packages' Predictors, and each behaviour of
``tests/test_batching.py`` on a stub predictor.  Nothing here sleeps:
every wait is on a ``threading`` primitive, and service time passes on a
fake clock (``tests/torch_serving_stub.py``)."""

import threading
from concurrent.futures import Future
from types import SimpleNamespace

import numpy as np
import pytest
from torch_port_weights import flax_variables
from torch_port_weights import one_thread  # noqa: F401
from torch_serving_stub import CENTER, IMG, WAIT_S, FakeClock, Stub, frame

import awr_tpu.batching as jax_batching
from awr_tpu.config import hourglass_config as jax_hourglass_config
from awr_tpu.serving import Predictor as JaxPredictor
from awr_tpu_torch import batching
from awr_tpu_torch.batching import (BatchingPredictor, DeadlineExceeded,
                                    QueueFull, _Request, _ServiceModel)
from awr_tpu_torch.config import hourglass_config
from awr_tpu_torch.data.synthetic import synthetic_frames
from awr_tpu_torch.models import build_model
from awr_tpu_torch.models.weights import load_flax_variables
from awr_tpu_torch.serving import Predictor

# the port's Predictor against the JAX package's on the same weights: the
# bar of tests/test_torch_serving.py (px / mm); the port against itself
# batched in other groups: the JAX package's batching bar
# (tests/test_batching.py:59)
JAX_ATOL = 0.05
RTOL, ATOL = 1e-4, 1e-3


@pytest.fixture
def clock(monkeypatch):
    """One fake clock for both packages' batching modules."""
    c = FakeClock()
    monkeypatch.setattr(batching, "_now", c)
    monkeypatch.setattr(jax_batching, "time", SimpleNamespace(perf_counter=c))
    return c


# ------------------------------------------------- the service-time model

SHAPES = [None, (IMG, IMG), (480, 640), (128, 128)]
QUERIES = [(f, s) for f in (1, 5, 8, 9, 16, 33, 64, 200)
           for s in SHAPES + [(240, 320)]]


def _read(m):
    return ([(m.estimate(f, s), m.quantile(f, s), m.variance(f, s))
             for f, s in QUERIES], m.snapshot())


@pytest.mark.parametrize("seed", range(4))
def test_service_model_is_bit_equal_to_jax(seed):
    """The same seeded observations (spikes and resets among them) over
    several buckets and frame shapes, None included: every estimate,
    quantile, variance and snapshot equal to the last bit."""
    rng = np.random.RandomState(seed)
    models = [mod._ServiceModel(Stub._bucket)
              for mod in (jax_batching, batching)]
    assert _read(models[0]) == _read(models[1])  # cold: all None, {}
    for step in range(3 * _ServiceModel.WINDOW + 20):
        frames = int(rng.choice([1, 3, 8, 12, 16, 30, 64, 100]))
        shape = SHAPES[rng.randint(len(SHAPES))]
        seconds = float(rng.lognormal(-3.0, 1.0))
        if rng.rand() < 0.03:
            seconds *= 1e3  # a stall
        for m in models:
            m.observe(frames, seconds, shape)
        if rng.rand() < 0.05:
            for m in models:
                m.reset(frames, shape)
        if step % 7 == 0:
            assert _read(models[0]) == _read(models[1]), step
    assert _read(models[0]) == _read(models[1])


# ------------------------------------- dispatch decisions under one clock

def _decisions(mod, clock, seed):
    """A scripted run of the deadline decisions of one package's
    BatchingPredictor, its threads stopped: budgets and caps at scripted
    ages and in-flight loads, dispatch-time re-checks, and the groups,
    sheds and deferrals of ``_drain`` over scripted queues."""
    rng = np.random.RandomState(seed)
    bp = mod.BatchingPredictor(Stub(), max_batch=64, max_wait_ms=0.0,
                               pipeline_depth=1, deadline_ms=300.0,
                               deadline_margin=(1.0, 1.3)[seed % 2])
    bp.close()  # the test drives the methods
    shape = (IMG, IMG)
    for b in (8, 16, 32):
        for _ in range(rng.randint(1, 6)):
            bp.service_model.observe(b, b * 0.01 * rng.uniform(0.7, 1.3),
                                     shape)

    def req(i, age, frames=1, prime=False):
        r = mod._Request(np.stack([frame(i)] * frames),
                         np.tile(CENTER, (frames, 1)), None, Future(),
                         batched=frames > 1, prime=prime)
        r.t_arrival -= age
        return r

    def ids(reqs):
        return [float(r.imgs[0, 0, 0]) for r in reqs]

    def load(groups, mean, var):
        bp._inflight_groups = groups
        bp._inflight_mean_s, bp._inflight_var_s2 = mean, var

    trace = []
    for inflight in ((0, 0.0, 0.0), (1, 0.05, 1e-4), (2, 0.12, 4e-4)):
        load(*inflight)
        for age in (0.0, 0.05, 0.12, 0.2, 0.25, 0.29, 0.31, 0.5):
            head = req(0, age)
            budget = bp._budget_s(head)
            trace.append(("cap", inflight, age, budget,
                          bp._cap_for(budget, shape), bp._cap_frames(head)))
            for sizes in ([1] * 10, [1] * 20, [3, 5, 8, 2, 9, 1, 7]):
                group = [head] + [req(i + 1, age / 2, f)
                                  for i, f in enumerate(sizes)]
                kept = bp._recheck_budget(list(group))
                trace.append(("recheck", ids(kept), ids(bp._held)))
                bp._held.clear()
    load(1, 0.05, 1e-4)
    for _ in range(3):
        reqs = [req(i, float(rng.choice([0, 0.1, 0.2, 0.26, 0.3, 0.4])),
                    int(rng.choice([1, 1, 1, 2, 5])),
                    prime=rng.rand() < 0.1) for i in range(30)]
        for r in reqs:
            bp._q.put(r)
            bp._queued_frames += r.frames
        bp._q.put(None)
        stop = False
        while not stop:
            group, stop = bp._drain()
            trace.append(("drain", ids(group), stop, ids(bp._held),
                          bp.n_shed, bp._queued_frames))
        trace.append(("shed", [i for i, r in enumerate(reqs)
                               if r.future.done()]))
    return trace


@pytest.mark.parametrize("seed", range(4))
def test_dispatch_decisions_equal_jax_under_a_fake_clock(clock, seed):
    """``_budget_s``, ``_cap_for``, ``_cap_frames``, ``_recheck_budget``
    and the shed decisions of ``_next_request``/``_drain`` on the same
    scripted requests decide identically in both packages."""
    want = _decisions(jax_batching, clock, seed)
    got = _decisions(batching, clock, seed)
    assert got == want
    # the script reaches every kind of decision
    assert any(t[0] == "recheck" and t[2] for t in got)    # deferrals
    assert any(t[0] == "shed" and t[1] for t in got)       # sheds
    caps = {t[4] for t in got if t[0] == "cap"}
    assert {0, 8, 16} <= caps


def test_recheck_shrinks_a_stale_group(clock):
    """The port's dispatch-time re-check, with the JAX test's numbers
    (tests/test_batching.py:415): a stale head's group shrinks to the
    bucket that still fits, the tail is deferred in order; an idle
    pipeline dispatches as-is."""
    bp = BatchingPredictor(Stub(), max_batch=64, max_wait_ms=0.0,
                           pipeline_depth=1, deadline_ms=300.0)
    bp.close()
    for b in (8, 16, 32):
        bp.service_model.observe(b, b * 0.01, (IMG, IMG))

    def group(n, age):
        g = [_Request(frame(i)[None], CENTER[None], None, Future())
             for i in range(n)]
        g[0].t_arrival -= age
        return g

    bp._inflight_groups = 1
    g = group(10, 0.0)
    assert bp._recheck_budget(list(g)) == g and not bp._held
    g = group(10, 0.25)
    assert bp._recheck_budget(list(g)) == g[:8]
    assert list(bp._held) == g[8:]
    bp._held.clear()
    g = group(20, 0.12)
    assert len(bp._recheck_budget(list(g))) == 16
    assert list(bp._held) == g[16:]
    bp._held.clear()
    bp._inflight_groups = 0
    g = group(10, 0.25)
    assert bp._recheck_budget(list(g)) == g


def test_cap_never_drops_below_smallest_bucket(clock):
    bp = BatchingPredictor(Stub(), max_batch=64, max_wait_ms=0.0,
                           pipeline_depth=1, deadline_ms=300.0)
    bp.close()
    bp.service_model.observe(8, 0.08, (IMG, IMG))
    head = _Request(frame(0)[None], CENTER[None], None, Future())
    head.t_arrival -= 0.28  # 20 ms left: est(8) never fits
    assert bp._cap_frames(head) == 8


# -------------------------------------- the port against the JAX package

@pytest.fixture(scope="module")
def predictors():
    _, variables = flax_variables(1, seed=2)
    jax_pred = JaxPredictor(
        jax_hourglass_config(img_size=IMG, use_pallas=False), variables)
    cfg = hourglass_config(img_size=IMG)
    model = load_flax_variables(build_model(cfg.net, cfg.jt_num), variables)
    return jax_pred, Predictor(cfg, model, device="cpu")


@pytest.fixture(scope="module")
def frames():
    imgs, _, centers = synthetic_frames(12, 14, seed=3)
    return imgs, centers


def _threaded(bp, imgs, centers, threads=4):
    """Every frame through ``bp.predict`` from ``threads`` client
    threads; the joints in frame order."""
    out = [None] * len(imgs)
    errors = []

    def client(k):
        try:
            for i in range(k, len(imgs), threads):
                out[i] = bp.predict(imgs[i], centers[i], timeout=120)
        except Exception as e:  # noqa: BLE001 - collected for the assert
            errors.append(e)

    ts = [threading.Thread(target=client, args=(k,)) for k in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in ts) and not errors, errors
    return np.stack(out)


def test_batched_hourglass_matches_jax_batched(predictors, frames):
    """12 frames from 4 client threads through each package's
    BatchingPredictor over its Predictor, the same weights (max_batch 8:
    one bucket, one JAX compile)."""
    jax_pred, pred = predictors
    imgs, centers = frames
    with jax_batching.BatchingPredictor(jax_pred, max_batch=8,
                                        max_wait_ms=20.0) as bp:
        want = _threaded(bp, imgs, centers)
    with BatchingPredictor(pred, max_batch=8, max_wait_ms=20.0) as bp:
        got = _threaded(bp, imgs, centers)
        assert bp.n_frames == len(imgs) and bp.n_dispatches >= 2
    assert got.shape == (12, 14, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=JAX_ATOL)
    np.testing.assert_allclose(got, pred.predict(imgs, centers), rtol=RTOL,
                               atol=ATOL)


def test_submissions_coalesce_and_match_direct(predictors, frames):
    _, pred = predictors
    imgs, centers = frames
    direct = pred.predict(imgs, centers)
    with BatchingPredictor(pred, max_batch=32, max_wait_ms=60_000.0) as bp:
        fb = bp.submit_batch(imgs[:5], centers[:5])
        f1 = bp.submit(imgs[5], centers[5])
        fb2 = bp.submit_batch(imgs[6:], centers[6:])
        outb, out1, outb2 = (f.result(timeout=120) for f in (fb, f1, fb2))
        assert bp.n_frames == len(imgs) and bp.n_dispatches <= 2
    assert outb.shape == (5, 14, 3) and out1.shape == (14, 3)
    np.testing.assert_allclose(outb, direct[:5], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out1, direct[5], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(outb2, direct[6:], rtol=RTOL, atol=ATOL)


def test_mixed_resolutions_one_burst(predictors, frames):
    """Frames of two camera sizes in one drain group: one dispatch each."""
    _, pred = predictors
    imgs, centers = frames
    big = np.pad(imgs[1], ((0, 8), (0, 8)))
    with BatchingPredictor(pred, max_wait_ms=60_000.0, max_batch=2) as bp:
        f_small = bp.submit(imgs[0], centers[0])
        f_big = bp.submit(big, centers[1])
        out_s, out_b = f_small.result(timeout=120), f_big.result(timeout=120)
        assert bp.n_dispatches == 2
    np.testing.assert_allclose(out_s, pred.predict(imgs[:1], centers[:1])[0],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out_b, pred.predict(big[None], centers[1:2])[0],
                               rtol=RTOL, atol=ATOL)


def test_error_delivered_to_future(predictors, frames):
    """A request that fails in the dispatcher fails its own future (or
    comes back NaN, not a faked pose); later requests still serve."""
    _, pred = predictors
    imgs, centers = frames
    with BatchingPredictor(pred, max_wait_ms=1.0) as bp:
        bad = bp.submit(np.full((IMG, IMG), np.nan, np.float32),
                        np.array([np.nan, np.nan, 0.0]))
        try:
            failed = bool(np.isnan(bad.result(timeout=120)).any())
        except Exception:  # noqa: BLE001 - either way it must not fake one
            failed = True
        assert failed
        assert np.isfinite(bp.predict(imgs[0], centers[0], timeout=120)).all()


def test_predict_async_overlapped_dispatches_match(predictors, frames):
    """Two groups dispatched before either finalizes, finalized out of
    order: the rows a blocking predict gives, bit for bit on the CPU."""
    _, pred = predictors
    imgs, centers = frames
    fin_a = pred.predict_async(imgs[:5], centers[:5])
    fin_b = pred.predict_async(imgs[5:], centers[5:])
    out_b, out_a = fin_b(), fin_a()
    np.testing.assert_array_equal(out_a, pred.predict(imgs[:5], centers[:5]))
    np.testing.assert_array_equal(out_b, pred.predict(imgs[5:], centers[5:]))


# --------------------------------------- behaviour, on the stub predictor

def test_arguments_are_checked():
    stub = Stub()
    for kw in (dict(max_batch=0), dict(pipeline_depth=0),
               dict(deadline_ms=0.0), dict(max_queue=0),
               dict(deadline_margin=0.5)):
        with pytest.raises(ValueError):
            BatchingPredictor(stub, **kw)
    with BatchingPredictor(stub) as bp:
        with pytest.raises(ValueError):
            bp.submit(np.zeros((2, IMG, IMG), np.float32), CENTER)
        with pytest.raises(ValueError):
            bp.submit_batch(frame(0), CENTER[None])
        with pytest.raises(ValueError):
            bp.submit_batch(np.stack([frame(0)] * 3), np.zeros((2, 3)))
        with pytest.raises(ValueError):
            bp.submit_batch(np.stack([frame(0)] * 3), np.zeros((3, 3)),
                            cubes=[[300.0] * 3])
        with pytest.raises(ValueError):
            bp.prime_service_model((IMG, IMG), repeats=0)


def test_deferred_requests_keep_fifo_and_complete_after_close(clock):
    """A request that does not fit the latency cap is held and leads the
    next group; requests held when ``close`` arrives still complete (the
    ``_run`` flush), in FIFO order."""
    stub = Stub(clock, gated=True)
    bp = BatchingPredictor(stub, max_batch=64, max_wait_ms=0.0,
                           pipeline_depth=1, deadline_ms=250.0)
    # cap = 8 while two groups are in flight: budget 0.25 - 0.08 fits
    # bucket 8 (median 0.02, p90 0.036 once group 0 observed 0 s), not 16
    bp.service_model.observe(8, 0.04, (IMG, IMG))
    bp.service_model.observe(16, 0.22, (IMG, IMG))
    futs = []
    for i in range(3):  # group 0 in the completer, 1 queued, 2 in put
        futs.append(bp.submit(frame(i), CENTER))
        stub.wait_dispatches(i + 1)
    futs += [bp.submit(frame(i), CENTER) for i in range(3, 10)]
    # 7 + 2 frames do not fit a cap of 8: this request is held
    futs.append(bp.submit_batch(np.stack([frame(10), frame(11)]),
                                np.tile(CENTER, (2, 1))))
    futs += [bp.submit(frame(i), CENTER) for i in range(12, 23)]
    stub.gate(0).set()
    stub.wait_dispatches(4)
    assert stub.groups[3] == list(range(3, 10))
    assert [r.imgs[:, 0, 0].tolist() for r in bp._held] == [[10.0, 11.0]]
    closer = threading.Thread(target=bp.close)
    closer.start()
    stub.open_all()
    closer.join(WAIT_S)
    assert not closer.is_alive()
    assert stub.groups[4][:2] == [10.0, 11.0]  # the held request leads
    order = [i for g in stub.groups for i in g]
    assert order == list(range(23))
    got = [np.ravel(f.result(timeout=WAIT_S)[..., 0, 0]) for f in futs]
    assert np.concatenate(got).tolist() == list(range(23))
    assert bp.n_shed == 0


def test_max_queue_rejects_when_full(clock):
    """With the completer gated shut, queued frames past ``max_queue``
    raise QueueFull at submit; every accepted request serves."""
    stub = Stub(clock, gated=True)
    bp = BatchingPredictor(stub, max_batch=1, max_wait_ms=0.0,
                           pipeline_depth=1, max_queue=2)
    try:
        futs = []
        for i in range(3):
            futs.append(bp.submit(frame(i), CENTER))
            stub.wait_dispatches(i + 1)
        futs.append(bp.submit(frame(3), CENTER))  # queued (1/2)
        futs.append(bp.submit(frame(4), CENTER))  # queued (2/2)
        with pytest.raises(QueueFull):
            bp.submit(frame(5), CENTER)
        assert bp.n_rejected == 1
        stub.open_all()
        assert [f.result(timeout=WAIT_S)[0, 0] for f in futs] == list(range(5))
    finally:
        stub.open_all()
        bp.close()


def test_deadline_sheds_instead_of_convoying(clock):
    """8x overload, stepped on the fake clock: 64 frames queue behind a
    blocker, every group takes 100 ms, the deadline is 450 ms.  Groups of
    8 dispatch while their budget covers the service; from 200 ms of age
    on, every request is shed at once instead of queueing into a convoy,
    and every served request meets the deadline."""
    hold = threading.Event()
    stub = Stub(clock, service=lambda n, hw: 0.1, gated=True, hold=hold)
    bp = BatchingPredictor(stub, max_batch=8, max_wait_ms=0.0,
                           pipeline_depth=1, deadline_ms=450.0)
    try:
        bp.service_model.observe(8, 0.1, (IMG, IMG))
        t0 = clock()
        blocker = bp.submit(frame(-1), CENTER)
        assert stub.holding.wait(WAIT_S)
        done = {}
        futs = []
        for i in range(64):
            f = bp.submit(frame(i), CENTER)
            f.add_done_callback(lambda f, i=i: done.setdefault(i, clock()))
            futs.append(f)
        hold.set()
        # budgets 0.35 and 0.25 s: r0-r7 and r8-r15 dispatch, the next
        # group waits in the pipeline's put
        stub.wait_dispatches(3)
        stub.gate(0).set()  # 0.1 s: r16-r23 at age 0.1, budget 0.15
        stub.wait_dispatches(4)
        stub.gate(1).set()  # 0.2 s: budget 0.05 < 0.1, the rest is shed
        for f in futs[24:]:
            assert isinstance(f.exception(timeout=WAIT_S), DeadlineExceeded)
        stub.open_all()
        assert blocker.result(timeout=WAIT_S)[0, 0] == -1.0
        assert [f.result(timeout=WAIT_S)[0, 0] for f in futs[:24]] == list(
            range(24))
        assert stub.groups[1:] == [list(range(k, k + 8))
                                   for k in (0, 8, 16)]
        assert bp.n_shed == 40
        assert max(done[i] - t0 for i in range(24)) < 0.45
        assert max(done[i] - t0 for i in range(24, 64)) < 0.2 + 1e-9
    finally:
        hold.set()
        stub.open_all()
        bp.close()


@pytest.mark.parametrize("margin,largest,served_min",
                         [(1.0, 16, 16), (2.0, 8, 1)])
def test_deadline_caps_group_size(clock, margin, largest, served_min):
    """Groups are capped so their bucket's predicted service fits the
    head's budget: est(32) = 320 ms never fits 300 ms; at margin 2 est(16)
    does not either."""
    hold = threading.Event()
    stub = Stub(clock, service=lambda n, hw: 0.01 * Stub._bucket(n),
                hold=hold, hold_at=1)
    bp = BatchingPredictor(stub, max_batch=64, max_wait_ms=0.0,
                           pipeline_depth=1, deadline_ms=300.0,
                           deadline_margin=margin)
    try:
        bp.predict(frame(0), CENTER, timeout=WAIT_S)  # warm: b8 = 80 ms
        futs = [bp.submit(frame(i), CENTER) for i in range(48)]
        hold.set()
        served = sum(f.exception(timeout=WAIT_S) is None for f in futs)
        assert max(len(g) for g in stub.groups[1:]) <= largest, stub.groups
        assert served >= served_min
    finally:
        hold.set()
        bp.close()


def test_poisoned_service_model_recovers_via_idle_dispatch(clock):
    """Liveness: a model that learned a pathological 120 s service must
    not shed forever; an idle pipeline dispatches the head anyway and
    the re-measured service pulls the median down."""
    stub = Stub(clock)
    bp = BatchingPredictor(stub, max_batch=8, max_wait_ms=0.0,
                           pipeline_depth=1, deadline_ms=200.0)
    try:
        bp.service_model.observe(8, 120.0, (IMG, IMG))
        assert bp.service_model.estimate(1, (IMG, IMG)) > bp.deadline_s
        assert bp.predict(frame(0), CENTER, timeout=WAIT_S)[0, 0] == 0.0
        for i in range(1, 4):
            bp.predict(frame(i), CENTER, timeout=WAIT_S)
        assert bp.service_model.estimate(8, (IMG, IMG)) == 0.0
        assert bp.n_shed == 0
    finally:
        bp.close()


def test_cancelled_future_does_not_poison_group(clock):
    hold = threading.Event()
    stub = Stub(clock, gated=True, hold=hold)
    bp = BatchingPredictor(stub, max_batch=8, max_wait_ms=0.0)
    try:
        blocker = bp.submit(frame(0), CENTER)
        assert stub.holding.wait(WAIT_S)
        f1 = bp.submit(frame(1), CENTER)
        f2 = bp.submit(frame(2), CENTER)
        hold.set()
        stub.wait_dispatches(2)
        assert stub.groups[1] == [1.0, 2.0]  # coalesced, in flight
        assert f1.cancel()
        stub.open_all()
        assert f2.result(timeout=WAIT_S)[0, 0] == 2.0
        assert blocker.result(timeout=WAIT_S)[0, 0] == 0.0
        assert f1.cancelled() and bp.n_frames == 3
    finally:
        hold.set()
        stub.open_all()
        bp.close()


def test_bad_request_does_not_fail_coalesced_neighbours(clock):
    """A malformed center fails the coalesced group's stacking; each
    request is retried alone and only the offender's future fails."""
    hold = threading.Event()
    stub = Stub(clock, hold=hold)
    bp = BatchingPredictor(stub, max_batch=8, max_wait_ms=0.0)
    try:
        bp.submit(frame(9), CENTER)  # holds the dispatcher
        assert stub.holding.wait(WAIT_S)
        ok1 = bp.submit(frame(1), CENTER)
        bad = bp.submit(frame(2), np.zeros(2))
        ok2 = bp.submit(frame(3), CENTER)
        hold.set()
        assert ok1.result(timeout=WAIT_S)[0, 0] == 1.0
        assert ok2.result(timeout=WAIT_S)[0, 0] == 3.0
        assert isinstance(bad.exception(timeout=WAIT_S), ValueError)
        assert stub.groups == [[9.0], [1.0], [3.0]]  # solo retries
    finally:
        hold.set()
        bp.close()


def test_submit_batch_larger_than_max_batch(clock):
    """max_batch caps coalescing, not request size."""
    stub = Stub(clock)
    with BatchingPredictor(stub, max_batch=4, max_wait_ms=0.0) as bp:
        imgs = np.stack([frame(i) for i in range(12)])
        out = bp.predict_batch(imgs, np.tile(CENTER, (12, 1)),
                               timeout=WAIT_S)
    assert out[:, 0, 0].tolist() == list(range(12))
    assert stub.groups == [list(range(12))]


def test_close_semantics(clock):
    """close stops admission at once, and every request accepted before it
    completes; a second close is a no-op; the context manager closes."""
    stub = Stub(clock, gated=True)
    bp = BatchingPredictor(stub, max_batch=2, max_wait_ms=0.0)
    futs = [bp.submit(frame(i), CENTER) for i in range(5)]
    bp.close(wait=False)
    with pytest.raises(RuntimeError, match="closed"):
        bp.submit(frame(5), CENTER)
    bp.close()  # already closed: returns without waiting
    stub.open_all()
    bp._worker.join(WAIT_S)
    bp._completer.join(WAIT_S)
    assert not bp._worker.is_alive() and not bp._completer.is_alive()
    assert [f.result(timeout=0)[0, 0] for f in futs] == list(range(5))
    with BatchingPredictor(Stub(clock)) as bp:
        bp.predict(frame(0), CENTER, timeout=WAIT_S)
    assert not bp._worker.is_alive() and not bp._completer.is_alive()


def test_prime_discards_the_first_dispatch(clock):
    """Every bucket gets an estimate equal to its steady service; the
    first dispatch's one-time cost (0.3 s) is kept out of it and shows in
    ``prime_stats``.  Priming bypasses max_queue and sheds nothing."""
    def service(n, hw):
        return 0.01 + Stub._bucket(n) * 0.001

    stub = Stub(clock, service=service, first_s=0.3)
    bp = BatchingPredictor(stub, max_batch=32, max_wait_ms=0.0,
                           pipeline_depth=1, max_queue=8)
    try:
        snap = bp.prime_service_model((IMG, IMG), repeats=2)
        assert set(snap) == {8, 16, 32} == stub.buckets_run
        for b, s in snap.items():
            assert s == pytest.approx(service(b, None), rel=1e-9)
            st = bp.prime_stats["per_bucket"][b]
            assert st["first_s"] == round(0.3 + service(b, None), 4)
            assert st["measure_s"] == round(2 * service(b, None), 4)
        assert bp.n_shed == bp.n_rejected == 0
    finally:
        bp.close()


def test_primed_stack_is_latency_bounded_from_the_first_group(clock):
    """Cold, the cap falls back to max_batch; primed, the first group is
    already capped at the largest bucket that fits 130 ms (b32 84 ms;
    b64 148 ms)."""
    stub = Stub(clock, service=lambda n, hw: 0.02 + 0.002 * Stub._bucket(n))
    bp = BatchingPredictor(stub, max_batch=64, max_wait_ms=0.0,
                           pipeline_depth=1, deadline_ms=130.0, max_queue=8)
    try:
        head = _Request(frame(0)[None], CENTER[None], None, Future())
        assert bp._cap_frames(head) == 64
        assert set(bp.prime_service_model((IMG, IMG), repeats=1)) == {
            8, 16, 32, 64}
        assert bp.n_shed == bp.n_rejected == 0
        head = _Request(frame(0)[None], CENTER[None], None, Future())
        assert bp._cap_frames(head) == 32
    finally:
        bp.close()


def test_mixed_resolution_estimates_stay_distinct(clock):
    """Two frame shapes through one stack: service proportional to the
    pixels keeps the big stream's estimate 16x the small one's."""
    stub = Stub(clock, service=lambda n, hw: Stub._bucket(n) * hw[0] * hw[1]
                * 4e-9)
    bp = BatchingPredictor(stub, max_batch=8, max_wait_ms=0.0,
                           pipeline_depth=1, deadline_ms=500.0)
    try:
        small, big = (IMG, IMG), (4 * IMG, 4 * IMG)
        for i in range(6):
            bp.predict(frame(i, small), CENTER, timeout=WAIT_S)
            bp.predict(frame(i, big), CENTER, timeout=WAIT_S)
        est_small = bp.service_model.estimate(8, small)
        est_big = bp.service_model.estimate(8, big)
        assert est_big == pytest.approx(16 * est_small, rel=1e-6)
    finally:
        bp.close()


def test_concurrent_clients_under_a_short_switch_interval(clock):
    """16 client threads (more than the cores) submit single frames and
    batches at once while the interpreter switches threads every
    microsecond: every request gets its own rows, and the admission and
    in-flight accounting return to zero."""
    import sys

    stub = Stub(clock, service=lambda n, hw: 0.001)
    bp = BatchingPredictor(stub, max_batch=16, max_wait_ms=0.0,
                           pipeline_depth=2, max_queue=10_000)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    errors = []

    def client(k):
        try:
            for j in range(20):
                i = 1000 * k + 10 * j
                if j % 4:
                    out = bp.predict(frame(i), CENTER, timeout=WAIT_S)
                    assert out[0, 0] == i
                else:
                    imgs = np.stack([frame(i + m) for m in range(3)])
                    out = bp.predict_batch(imgs, np.tile(CENTER, (3, 1)),
                                           timeout=WAIT_S)
                    assert out[:, 0, 0].tolist() == [i, i + 1, i + 2]
        except Exception as e:  # noqa: BLE001 - collected for the assert
            errors.append(e)

    try:
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT_S)
        assert not any(t.is_alive() for t in threads) and not errors, errors
    finally:
        sys.setswitchinterval(interval)
        bp.close()
    assert bp.n_frames == 16 * (15 * 1 + 5 * 3)
    assert bp._queued_frames == 0 and bp._inflight_groups == 0
    assert abs(bp._inflight_mean_s) < 1e-9 and abs(bp._inflight_var_s2) < 1e-9
    assert bp.n_shed == bp.n_rejected == 0
