"""The ``hourglass_8`` configuration and its cell ``hg8-train-f32``: the
reference's size, a traced small run on the CPU that supervises every
stack, and the readers of the span ``train.supervise``
(``train.supervise_ms`` and ``train.supervise_device_ms``) on a
synthetic trace.  ``test_portbench_faults.py`` runs every cell file,
this one too: small on the CPU, sound (correct) and with ``half_batch``
and ``stale_state`` (not correct), and on a card at ``cells.CARD``
sizes, the program (correct) and the TF32 control (not correct)."""

from types import SimpleNamespace

import pytest
import torch

from portbench import harness, program_spans
from portbench.reference import models
from portbench.tests import cells

CELL = "hg8-train-f32"
CPU = torch.autograd.DeviceType.CPU
CUDA = torch.autograd.DeviceType.CUDA


def reader(metric):
    return harness.load_module(harness.reader_path(metric))


# ------------------------------------------------------- the configuration

def test_size_pinned():
    """Newell's 8-stack network of 256 features on the AWR stem and
    heads: 25,740,736 parameters, 57.19 GFLOP a frame forward and
    171.52 forward and backward at img 128, 5.0x hourglass_1's."""
    cfg = harness.config("hourglass_8")
    with torch.device("meta"):
        n = sum(p.numel() for p in models.build(cfg).parameters())
    assert n == cfg["assumed"]["parameters"] == 25_740_736
    assert round(harness.reference_flops(cfg, False) / 1e9, 2) == 57.19
    assert round(harness.reference_flops(cfg, True) / 1e9, 2) == 171.52
    one = harness.config("hourglass_1")
    # every key but the stack count and the name as hourglass_1's
    assert {k for k in cfg if cfg[k] != one.get(k)} == {
        "name", "net", "nstack", "source", "source_parts", "assumed"}
    assert harness.workload(CELL)["params"] == harness.workload(
        "hg1-train-f32")["params"]


# ----------------------------------------------------------- small runs

def test_sound_run_supervises_every_stack(one_thread, monkeypatch):
    """A traced small run is correct, and its window holds one
    ``train.supervise`` span a step (the window's steps, each a
    microbatch), which the readers find; with no card they print
    nothing."""
    found = {}
    spans = program_spans.spans

    def spy(ctx, name):
        found[name] = spans(ctx, name)
        return found[name]

    monkeypatch.setattr(program_spans, "spans", spy)
    out = cells.run(CELL, trace=True)
    assert out["correct"] is True, out["checks"]
    assert len(found["train.supervise"]) == out["attempted"] >= 1
    assert not {"train.supervise_ms.train",
                "train.supervise_device_ms.train"} & set(out["metrics"])


# ---------------------------------------------------------- the readers

class Event:
    """A profiler event as the readers see one."""

    def __init__(self, name, start, dur, thread=1, device=CPU, corr=0):
        self._v = (name, start, dur, thread, device, corr)

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

    def correlation_id(self):
        return self._v[5]


def launch(start, corr, thread=1):
    return Event("cudaLaunchKernel", start, 5_000, thread, corr=corr)


def kernel(start, dur, corr):
    return Event("decode_kernel", start, dur, 0, CUDA, corr)


SPAN = "awr_tpu_torch.train.supervise"
EVENTS = [
    # two steps' spans on thread 1
    Event(SPAN, 1_000_000, 1_000_000),
    Event(SPAN, 5_000_000, 2_000_000),
    launch(1_100_000, 11), kernel(1_500_000, 300_000, 11),
    Event("cuLaunchKernel", 1_200_000, 5_000, corr=12),
    kernel(1_900_000, 200_000, 12),
    launch(5_500_000, 13), kernel(5_600_000, 500_000, 13),
    # launched outside every span, on the span's thread
    launch(3_000_000, 14), kernel(3_100_000, 900_000, 14),
    # launched inside a span's interval on another thread
    launch(5_700_000, 15, thread=2), kernel(5_800_000, 700_000, 15),
    # an op inside a span whose id equals a kernel's correlation id is
    # no launch
    Event("aten::add", 5_100_000, 10_000, corr=14),
    # a span outside the window, with its launch and kernel
    Event(SPAN, 20_000_000, 1_000_000),
    launch(20_100_000, 16), kernel(20_200_000, 400_000, 16),
]


def fake_trace(events):
    """A ``harness.Trace`` whose profiler holds ``events``."""
    trace = harness.Trace.__new__(harness.Trace)
    results = SimpleNamespace(events=lambda: events)
    trace.prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=results))
    return trace


def ctx_of(tdata, cuda=True, steps=2):
    return SimpleNamespace(trace=tdata, run=SimpleNamespace(cuda=cuda),
                           window={"steps": steps})


def test_readers_on_a_synthetic_trace():
    """Host: the mean of the two spans in the window, 1.5 ms.  Device:
    the kernels launched inside a span on its thread (0.3 + 0.2 + 0.5
    ms) over the window's two steps; the kernel launched between the
    spans, the one launched from another thread and the span outside the
    window count nothing."""
    trace = fake_trace(EVENTS)  # noqa: F841 (found in this frame)
    tdata = harness.TraceData([], [], [], 0, 10_000_000)
    host = reader("train.supervise_ms.train")
    device = reader("train.supervise_device_ms.train")
    assert host.read(ctx_of(tdata)) == pytest.approx(1.5)
    assert device.read(ctx_of(tdata)) == pytest.approx(0.5)
    assert device.read(ctx_of(tdata, steps=1)) == pytest.approx(1.0)
    # no card, no step: nothing
    for r in (host, device):
        assert r.read(ctx_of(tdata, cuda=False)) is None
    assert device.read(ctx_of(tdata, steps=0)) is None


def test_readers_read_nothing_without_the_span():
    """A program without ``train.supervise`` (the parent of the change
    that added it): both readers return None and neither raises."""
    trace = fake_trace([e for e in EVENTS if e.name() != SPAN])  # noqa: F841
    tdata = harness.TraceData([], [], [], 0, 10_000_000)
    for metric in ("train.supervise_ms.train",
                   "train.supervise_device_ms.train"):
        assert reader(metric).read(ctx_of(tdata)) is None
