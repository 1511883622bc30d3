"""The readers of the program's own spans (``program_spans.py`` and the
metrics ``serving.pad_ms``, ``serving.wait_ms`` and
``train.loader_wait_ms``), on the CPU: on a synthetic trace, on a real
profiled window, and through ``harness.run_cell``."""

import time
from types import SimpleNamespace

import pytest
import torch

from portbench import harness, program_spans
from portbench.tests import cells

READERS = {"serving.pad_ms.batch": "serving.pad",
           "serving.wait_ms.batch": "serving.wait",
           "train.loader_wait_ms.train": "pipeline.wait"}
CPU = torch.autograd.DeviceType.CPU
CUDA = torch.autograd.DeviceType.CUDA


def reader(metric):
    return harness.load_module(harness.reader_path(metric))


class Event:
    """A profiler event as the readers see one."""

    def __init__(self, name, start, dur, thread=1, device=CPU):
        self._v = (name, start, dur, thread, device)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def start_thread_id(self):
        return self._v[3]

    def device_type(self):
        return self._v[4]


def fake_trace(events):
    """A ``harness.Trace`` whose profiler holds ``events``."""
    trace = harness.Trace.__new__(harness.Trace)
    results = SimpleNamespace(events=lambda: events)
    trace.prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=results))
    return trace


def ctx_of(tdata, cuda=True):
    return SimpleNamespace(trace=tdata, run=SimpleNamespace(cuda=cuda))


EVENTS = [
    Event("awr_tpu_torch.serving.pad", 1_000, 2_000_000),
    Event("awr_tpu_torch.serving.pad", 3_000_000, 4_000_000),
    Event("awr_tpu_torch.serving.wait", 8_000_000, 1_000_000),
    Event("awr_tpu_torch.pipeline.wait", 9_000_000, 500_000, thread=2),
    # outside the window, a custom op, a kernel and a harness span
    Event("awr_tpu_torch.serving.pad", 20_000_000, 9_000_000),
    Event("awr_tpu_torch::decode", 2_000, 7_000_000),
    Event("awr_tpu_torch.serving.pad", 2_000, 7_000_000, device=CUDA),
    Event("predict", 0, 10_000_000),
]


@pytest.mark.parametrize("metric,want", [
    ("serving.pad_ms.batch", 3.0), ("serving.wait_ms.batch", 1.0),
    ("train.loader_wait_ms.train", 0.5)])
def test_readers_on_a_synthetic_trace(metric, want):
    trace = fake_trace(EVENTS)  # noqa: F841 (found in this frame)
    tdata = harness.TraceData([], [], [], 0, 10_000_000)
    assert reader(metric).read(ctx_of(tdata)) == pytest.approx(want)
    # a run without a card reads nothing
    assert reader(metric).read(ctx_of(tdata, cuda=False)) is None


def test_readers_read_nothing_without_spans():
    """A program that records no spans (the benchmark's parent commits):
    every reader returns None, and none raises."""
    trace = fake_trace(EVENTS[-3:])  # noqa: F841
    tdata = harness.TraceData([], [], [], 0, 10_000_000)
    for metric in READERS:
        assert reader(metric).read(ctx_of(tdata)) is None


def test_no_trace_in_reach_reads_nothing():
    """A reader called where no frame holds the profiler beside the
    window (a harness that no longer keeps both in ``run_cell``) raises,
    rather than dropping the metrics from the line unseen."""
    tdata = harness.TraceData([], [], [], 0, 10_000_000)
    with pytest.raises(LookupError, match="no harness.Trace"):
        program_spans.spans(ctx_of(tdata), "serving.pad")
    for metric in READERS:
        with pytest.raises(LookupError):
            reader(metric).read(ctx_of(tdata))


def test_spans_of_a_profiled_window(one_thread):
    """A real window: the program's spans on the stager thread and the
    consumer's, on the trace's clock; the custom-op reduction the other
    readers read holds none of them."""
    from awr_tpu_torch.data.pipeline import prefetch_to_device
    from awr_tpu_torch.ops.decode import decode_offsets
    from awr_tpu_torch.utils.profiling import span

    with harness.Trace() as trace:
        t0 = time.perf_counter_ns()
        with span("serving.pad"):
            decode_offsets(torch.randn(2, 56, 16, 16), torch.zeros(2, 32, 32),
                           0.4)
        staged = list(prefetch_to_device(iter(range(4)), lambda x: x, 2))
        t1 = time.perf_counter_ns()
    assert staged == [0, 1, 2, 3]
    # a second past the work: the harness aligns the two clocks at its
    # first range, stamped up to a millisecond before it reads the host
    # clock, which moves the window that much earlier
    tdata = trace.reduce(t0, t1 + 10**9, [])
    assert [n for n, _, _ in tdata.ops] == ["awr_tpu_torch::decode"]
    ctx = ctx_of(tdata)
    (pad,) = program_spans.spans(ctx, "serving.pad")
    assert tdata.lo <= pad[1] < pad[2] <= tdata.hi
    waits = program_spans.spans(ctx, "pipeline.wait")
    assert len(waits) == 5 and len({w[0] for w in waits}) == 1
    assert reader("train.loader_wait_ms.train").read(ctx) > 0


def test_run_cell_hands_readers_the_window(one_thread, monkeypatch):
    """Through ``harness.run_cell`` (the batch cell, small, on the CPU):
    the readers find the window's program spans; with no card they print
    nothing."""
    found = {}
    spans = program_spans.spans

    def spy(ctx, name):
        found[name] = spans(ctx, name)
        return found[name]

    monkeypatch.setattr(program_spans, "spans", spy)
    out = cells.run("r18-batch-bf16-b256", trace=True)
    assert out["correct"]
    # a call a span, but for the window's edges: the clocks align to
    # about a millisecond
    assert len(found["serving.pad"]) >= 2
    assert abs(len(found["serving.wait"]) - len(found["serving.pad"])) <= 1
    assert not set(READERS) & set(out["metrics"])
