"""The port's tracing (``awr_tpu_torch/utils/profiling.py`` ``span``) and
its always-on counters: a span costs one flag read and builds nothing
while no profiler records; under ``torch.profiler`` the Predictor's pad
and wait, the train loop's wait for a staged batch and the raw train
step's phases are ranges on the threads that run them; the Predictor's
padded rows, the batcher's queue-wait window (on a fake clock) and the
server's ``/healthz`` fields that report them."""

import base64
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch_port_weights import one_thread  # noqa: F401
from torch_serving_stub import CENTER, WAIT_S, FakeClock, Stub, frame

from awr_tpu_torch import batching
from awr_tpu_torch.batching import BatchingPredictor
from awr_tpu_torch.config import hourglass_config
from awr_tpu_torch.data.device import crop_param_tensors, draw_augment_params
from awr_tpu_torch.data.pipeline import prefetch_to_device
from awr_tpu_torch.data.synthetic import synthetic_frames
from awr_tpu_torch.geometry import xyz2uvd_np
from awr_tpu_torch.models import build_model
from awr_tpu_torch.models.common import torch_default_init_
from awr_tpu_torch.server import AWRServer
from awr_tpu_torch.serving import Predictor
from awr_tpu_torch.training.steps import make_raw_train_step
from awr_tpu_torch.utils import profiling

IMG = 32


@pytest.fixture(scope="module")
def model():
    cfg = hourglass_config(img_size=IMG)
    m = build_model(cfg.net, cfg.jt_num)
    torch_default_init_(m, torch.Generator().manual_seed(0))
    return m


@pytest.fixture(scope="module")
def frames():
    imgs, joints, centers = synthetic_frames(5, 14, seed=3)
    return imgs, joints, centers


def _predictor(model):
    return Predictor(hourglass_config(img_size=IMG), model, device="cpu")


def _profile(all_threads=False):
    kw = {}
    if all_threads:
        from torch._C._profiler import _ExperimentalConfig

        kw["experimental_config"] = _ExperimentalConfig(
            profile_all_threads=True)
    return profile(activities=[ProfilerActivity.CPU], **kw)


def _spans(prof):
    """The program's spans, ``(name without the prefix, thread, start ns,
    end ns)``, in start order."""
    out = [(e.name()[len("awr_tpu_torch."):], e.start_thread_id(),
            e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith("awr_tpu_torch.")]
    return sorted(out, key=lambda s: s[2])


def _inside(child, parent) -> bool:
    return parent[2] <= child[2] and child[3] <= parent[3]


# ------------------------------------------------------------- the span

def test_span_off_builds_nothing(monkeypatch):
    """With no profiler recording, ``span`` returns the one shared no-op
    and never constructs a range."""

    def refuse(*a, **k):
        raise AssertionError("range built with no profiler")

    monkeypatch.setattr(profiling, "_RecordFunctionFast", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    first = profiling.span("serving.pad")
    assert first is profiling.span("pipeline.wait") is profiling._NO_SPAN
    with first:
        with profiling.span("train.forward"):
            pass


def test_span_on_records_an_operator_range():
    """Under a profiler the span is ``awr_tpu_torch.<name>`` (a dot, not
    the custom ops' ``::``), an operator-scope range and not a user
    annotation, for which the profiler would also write a device-side
    range over the span's kernels."""
    with _profile() as prof:
        with profiling.span("a.b"):
            torch.zeros(3).add_(1)
    (event,) = [e for e in prof.profiler.kineto_results.events()
                if e.name().startswith("awr_tpu_torch")]
    assert event.name() == "awr_tpu_torch.a.b"
    assert not event.is_user_annotation()
    assert profiling.span("a.b") is profiling._NO_SPAN  # off again


def test_span_rests_on_the_operator_scope_range():
    """``span`` is built on ``torch._C._profiler._RecordFunctionFast``, a
    private symbol (PyTorch 2.2 and later); a PyTorch without it has to
    fail here, not fall back to ``record_function``, whose device-side
    ranges would count as busy time."""
    assert hasattr(torch._C._profiler, "_RecordFunctionFast"), (
        f"torch {torch.__version__} has no "
        f"torch._C._profiler._RecordFunctionFast, which span needs")
    assert profiling._RecordFunctionFast is (
        torch._C._profiler._RecordFunctionFast)


# --------------------------------------------------------- the Predictor

def test_predictor_spans_nest_on_the_callers_thread(model, frames):
    """``predict`` on the CPU: the pad of the raw frames, then
    ``finalize``'s wait, each once and apart, inside the caller's span
    and on its thread; the forward's decode runs between them, outside
    either."""
    imgs, _, centers = frames
    pred = _predictor(model)
    with _profile() as prof:
        with profiling.span("caller"):
            pred.predict(imgs, centers)
    spans = _spans(prof)
    assert [s[0] for s in spans] == ["caller", "serving.pad",
                                     "serving.wait"]
    caller, pad, wait = spans
    assert _inside(pad, caller) and _inside(wait, caller)
    assert pad[3] <= wait[2]
    assert pad[1] == wait[1] == caller[1]
    ops = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "awr_tpu_torch::decode"]
    assert ops and all(pad[3] <= e.start_ns() < wait[2] for e in ops)


def test_predictor_counts_padded_rows(model, frames):
    """A 5-frame call runs at bucket 8: 5 real rows and 3 padding rows;
    a full bucket adds no padding."""
    imgs, _, centers = frames
    pred = _predictor(model)
    assert (pred.n_frames, pred.n_padded_rows) == (0, 0)
    pred.predict(imgs, centers)
    assert (pred.n_frames, pred.n_padded_rows) == (5, 3)
    pred.predict(np.concatenate([imgs, imgs[:3]]),
                 np.concatenate([centers, centers[:3]]))
    assert (pred.n_frames, pred.n_padded_rows) == (13, 3)


def test_raw_frames_are_freed_before_the_forward(model, frames):
    """The raw frames' packed crop windows on the device (51 MB at the
    batch cell's B = 256, whole frames 315 MB) are no longer referenced
    when the forward runs: nothing keeps them alive past the crop."""
    import weakref

    imgs, _, centers = frames
    pred = _predictor(model)
    raw, seen = [], []
    on_device, infer = pred._frames_on_device, pred._infer

    def frames_on_device(*a):
        t = on_device(*a)
        raw.append(weakref.ref(t))
        return t

    def forward(img):
        seen.append(raw[-1]() is None)
        return infer(img)

    pred._frames_on_device, pred._infer = frames_on_device, forward
    pred.predict(imgs, centers)
    assert seen == [True]


# --------------------------------------------------------- the pipeline

def test_prefetch_spans_on_the_stager_and_the_consumer():
    """``prefetch_to_device``: the consumer's ``pipeline.wait``, one for
    each item and one for the end, on the consumer's thread; the stager
    thread names nothing (every thread recorded)."""
    with _profile(all_threads=True) as prof:
        with profiling.span("consumer"):
            got = list(prefetch_to_device(iter(range(3)),
                                          lambda x: 2 * x, 2))
    assert got == [0, 2, 4]
    consumer, *spans = _spans(prof)
    assert consumer[0] == "consumer"
    assert [s[0] for s in spans] == ["pipeline.wait"] * 4
    assert all(s[1] == consumer[1] and _inside(s, consumer) for s in spans)


# -------------------------------------------------------- the train step

def test_raw_train_step_spans(model, frames):
    """One raw-mode train step names its preprocessing, forward (with the
    supervision of its stacks inside it), backward and optimizer
    (``zero_grad`` and ``step``), in order."""
    imgs, joints, centers = frames
    cfg = hourglass_config(img_size=IMG)
    n = 2
    centers_uvd = xyz2uvd_np(centers[:n], cfg.paras, cfg.flip)
    cubes = np.tile(np.asarray(cfg.cube, np.float64), (n, 1))
    raw = dict(img=torch.from_numpy(imgs[:n]),
               jt_xyz=torch.from_numpy(joints[:n].astype(np.float32)),
               centers_uvd=torch.from_numpy(centers_uvd.astype(np.float32)),
               cubes=torch.from_numpy(cubes.astype(np.float32)))
    step_model = build_model(cfg.net, cfg.jt_num)
    step_model.load_state_dict(model.state_dict())
    opt = torch.optim.Adam(step_model.parameters(), 1e-3)
    step = make_raw_train_step(step_model, opt, cfg, cfg.paras, cfg.flip)
    crop = crop_param_tensors(centers_uvd, cubes, cfg.paras, IMG, "cpu")
    aug = draw_augment_params(torch.Generator().manual_seed(0), n)
    with _profile() as prof:
        metrics = step(raw, crop, aug)
    assert torch.isfinite(metrics["loss"])
    names = [s[0] for s in _spans(prof) if s[0].startswith("train.")]
    assert names == ["train.preprocess", "train.optimizer", "train.forward",
                     "train.supervise", "train.backward", "train.optimizer"]


# ----------------------------------------------- queue wait and /healthz

@pytest.fixture
def clock(monkeypatch):
    c = FakeClock()
    monkeypatch.setattr(batching, "_now", c)
    return c


def test_queue_wait_window_under_a_fake_clock(clock, monkeypatch):
    """A request taken at once waits 0 ms; two that queue while the
    dispatcher is held 50 ms wait 50 ms; the window keeps the last
    ``QUEUE_WAIT_WINDOW`` requests."""
    monkeypatch.setattr(BatchingPredictor, "QUEUE_WAIT_WINDOW", 2)
    hold = threading.Event()
    stub = Stub(clock, hold=hold, hold_at=0)
    bp = BatchingPredictor(stub, max_batch=8, max_wait_ms=0.0)
    try:
        assert bp.queue_wait_ms() == {"p50": None, "p95": None, "n": 0}
        futs = [bp.submit(frame(0), CENTER)]
        assert stub.holding.wait(WAIT_S)
        futs += [bp.submit(frame(i), CENTER) for i in (1, 2)]
        clock.advance(0.05)
        hold.set()
        for f in futs:
            f.result(timeout=WAIT_S)
        # waits 0, 50, 50: the window holds the last two
        w = bp.queue_wait_ms()
        assert w["n"] == 2
        assert w["p50"] == pytest.approx(50.0)
        assert w["p95"] == pytest.approx(50.0)
        bp.submit(frame(3), CENTER).result(timeout=WAIT_S)
        w = bp.queue_wait_ms()  # 50, 0
        assert w["n"] == 2
        assert w["p50"] == pytest.approx(25.0)
        assert w["p95"] == pytest.approx(47.5)
    finally:
        hold.set()
        bp.close()
    assert stub.groups == [[0.0], [1.0, 2.0], [3.0]]


def test_healthz_reports_padded_share_and_queue_wait(model, frames):
    """``/healthz`` reports the Predictor's share of padding rows and the
    batcher's queue wait: one frame runs at bucket 8, 7 rows of 8 are
    padding."""
    imgs, _, centers = frames
    pred = _predictor(model)
    with AWRServer(pred, port=0, max_batch=8).start() as srv:
        body = json.dumps({
            "img_b64": base64.b64encode(
                np.ascontiguousarray(imgs[0], "<f4").tobytes()).decode(),
            "shape": list(imgs[0].shape),
            "center_xyz": centers[0].tolist()}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/predict", data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=WAIT_S) as r:
            assert r.status == 200
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/healthz",
                                    timeout=WAIT_S) as r:
            h = json.loads(r.read())
    assert h["padded_share"] == pytest.approx(7 / 8)
    assert h["queue_wait_ms"]["n"] == 1
    assert 0.0 <= h["queue_wait_ms"]["p50"] <= h["queue_wait_ms"]["p95"]
