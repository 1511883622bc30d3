"""What every cell of the benchmark shares: loading its files by name,
the set-up clock, the device check, the timed window's trace, the peak
rates and FLOP counts that the metrics divide by, and the result line.

A cell is a file ``workloads/<cell>.json``; it names a configuration
``configs/<config>.json`` and a traffic kind ``traffic/<kind>.py``.  A
per-layer metric ``a.b.c`` is read by ``metrics/a_b_c.py`` or, for a
family, ``metrics/a_b.py``.  Nothing here knows a cell, a configuration,
a traffic kind or a metric by name.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
# top-level module names a run may not hold: the JAX package and JAX
FORBIDDEN = ("jax", "jaxlib", "flax", "awr_tpu")
# PyTorch's intra-op threads in a run unless the cell's ``host_threads``
# says otherwise: with all 8 of the card machine's cores the batcher's,
# the loader's and the generator's Python threads contend with them, and
# the serving tails spread twice as wide
HOST_THREADS = 4

# Published peaks of the card (NVIDIA's data sheet, dense rates), by
# ``torch.cuda.get_device_name()``: HBM bytes/s, float32 outside the
# tensor cores, bf16 on them.
CHIP_PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(hbm_bytes_per_s=3.35e12, float32=67e12,
                                  bfloat16=989e12),
}


def peaks(device_name: str) -> dict:
    if device_name not in CHIP_PEAKS:
        raise ValueError(f"no peak rates known for {device_name!r}")
    return CHIP_PEAKS[device_name]


# ---------------------------------------------------------------- files

def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(REPO / "BENCHMARK.json")


def workload(name: str) -> dict:
    return load_json(ROOT / "workloads" / f"{name}.json")


def config(name: str) -> dict:
    return load_json(ROOT / "configs" / f"{name}.json")


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "portbench_" + path.stem.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def traffic_path(kind: str) -> Path:
    return ROOT / "traffic" / f"{kind}.py"


def reader_path(metric: str):
    """The reader of ``metric``: its own file, else its family's (the
    name without its last dotted part); None if neither exists."""
    parts = metric.split(".")
    for name in (metric, ".".join(parts[:-1])):
        path = ROOT / "metrics" / (name.replace(".", "_") + ".py")
        if name and path.exists():
            return path
    return None


def cell_metrics(bench: dict, cell: str, section: str) -> list:
    """The entries of ``bench[section]`` that ``cell`` reports."""
    return [m for m in bench[section]
            if cell in m.get("workloads", [cell])]


# ------------------------------------------------------------- checks

def foreign_modules(modules=None) -> list:
    """The loaded modules whose top-level name (before the first dot) is
    one of :data:`FORBIDDEN`, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def device_problem(chips: int):
    """Why this machine cannot run a cell on ``chips`` cards, or None."""
    if not torch.cuda.is_available():
        return "no CUDA device: the benchmark measures the port on a GPU"
    if torch.cuda.device_count() < chips:
        return (f"{torch.cuda.device_count()} CUDA device(s), the cell asks "
                f"for {chips}")
    return None


def process_age_s() -> float:
    """Seconds since this process started, from /proc (0 where there is
    none)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


# -------------------------------------------------------------- flops

def reference_flops(cfg: dict, train: bool) -> float:
    """FLOPs a frame of the reference backbone at the configuration's
    image size (``FlopCounterMode``: 2 a multiply-add of each conv and
    transposed conv, elementwise work 0), forward or, with ``train``,
    forward plus backward (no gradient of the input)."""
    from torch.utils.flop_counter import FlopCounterMode

    from portbench.reference import models

    with torch.device("meta"):
        model = models.build(cfg)
    s = cfg["img_size"]
    x = torch.zeros((1, 1, s, s), device="meta")
    with FlopCounterMode(display=False) as counter:
        if train:
            models.stacked(model.train()(x)).sum().backward()
        else:
            with torch.no_grad():
                model.eval()(x)
    return float(counter.get_total_flops())


# -------------------------------------------------------------- spans

class Spans:
    """Host spans of the harness, (name, start ns, end ns) by
    ``time.perf_counter_ns``, from any thread; recorded only when on."""

    def __init__(self, on: bool):
        self.on = on
        self.items = []
        self._off = contextlib.nullcontext()

    def __call__(self, name: str):
        return self._span(name) if self.on else self._off

    @contextlib.contextmanager
    def _span(self, name):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.items.append((name, t0, time.perf_counter_ns()))


# the span that names an idle gap when several were open: the nearer
# the program's device work, the earlier
SPAN_ORDER = ("dispatch", "step", "stage", "submit", "predict", "wait",
              "loadgen")


class Trace:
    """The profiler over the timed window, reduced to the device's
    intervals and the program's custom-op calls inside it."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        kw = dict(activities=acts, record_shapes=True)
        try:
            from torch._C._profiler import _ExperimentalConfig

            # the batcher's and the stager's threads call the program
            kw["experimental_config"] = _ExperimentalConfig(
                profile_all_threads=True)
        except (ImportError, TypeError):
            pass
        self.prof = profile(**kw)

    def __enter__(self):
        from torch.profiler import record_function

        self.prof.__enter__()
        with record_function("portbench.clock"):
            self.mark = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)

    def reduce(self, t0: int, t1: int, spans) -> "TraceData":
        """The events between ``t0`` and ``t1`` (perf_counter ns)."""
        events = self.prof.profiler.kineto_results.events()
        clock = next(e for e in events if e.name() == "portbench.clock")
        off = clock.start_ns() - self.mark
        lo, hi = t0 + off, t1 + off
        cuda = torch.autograd.DeviceType.CUDA
        device, ops = [], []
        for e in events:
            s = e.start_ns()
            if e.device_type() == cuda:
                end = s + e.duration_ns()
                if end > lo and s < hi:
                    device.append((e.name(), max(s, lo), min(end, hi)))
            elif lo <= s <= hi and e.name().startswith("awr_tpu_torch::"):
                ops.append((e.name(), e.shapes(), e.dtypes()))
        host = [(n, a + off, b + off) for n, a, b in spans]
        return TraceData(device, ops, host, lo, hi)


class TraceData:
    """Device intervals ``(name, start, end)`` ns and custom-op calls
    ``(name, input shapes, input dtypes)`` within a window [lo, hi]."""

    def __init__(self, device, ops, host, lo, hi):
        self.device, self.ops, self.host = device, ops, host
        self.lo, self.hi = lo, hi
        self.window_s = (hi - lo) / 1e9
        self.busy_s, self.gaps = _union(device, lo, hi)

    def kernel_seconds(self, pattern) -> tuple:
        """(launches, seconds) of the device events whose name matches
        the compiled regex ``pattern``."""
        hits = [b - a for n, a, b in self.device if pattern.search(n)]
        return len(hits), sum(hits) / 1e9

    def op_calls(self, name: str) -> list:
        return [(s, d) for n, s, d in self.ops if n == name]

    def breakdown(self, top: int = 10) -> dict:
        by_name = {}
        for n, a, b in self.device:
            by_name[n] = by_name.get(n, 0) + (b - a)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps, key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n[:160], v / 1e9] for n, v in ops],
                "idle_gaps": [[self._doing(a, b), (b - a) / 1e9]
                              for a, b in gaps]}

    def _doing(self, a: int, b: int) -> str:
        """The harness span that overlapped [a, b] the most."""
        best, key = "none", None
        for name, s, e in self.host:
            overlap = min(b, e) - max(a, s)
            if overlap <= 0:
                continue
            rank = SPAN_ORDER.index(name) if name in SPAN_ORDER else 99
            if key is None or (overlap, -rank) > key:
                best, key = name, (overlap, -rank)
        return best


def _union(intervals, lo: int, hi: int):
    """(busy seconds of the union of ``intervals`` within [lo, hi], the
    idle gaps ``(start, end)`` between them and at the window's ends)."""
    busy, gaps, end = 0, [], lo
    for _, a, b in sorted(intervals, key=lambda x: x[1]):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if a > end:
            gaps.append((end, a))
        if b > end:
            busy += b - max(a, end)
            end = b
    if hi > end:
        gaps.append((end, hi))
    return busy / 1e9, gaps


# ------------------------------------------------------------ program

def set_tf32(on: bool):
    """Let cuDNN's convolutions and cuBLAS's float32 products round to
    TF32, or not (the configurations state float32 with TF32 off)."""
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on


def port_config(run, **kw):
    """The program's ``Config`` for a run's configuration file and
    compute dtype."""
    from awr_tpu_torch.config import Config

    c = run.cfg
    return Config(net=c["net"], dataset=c["dataset"], jt_num=c["joint_num"],
                  img_size=c["img_size"], downsample=c["downsample"],
                  kernel_size=c["kernel_size"], cube=tuple(c["cube"]),
                  compute_dtype=run.dtype, **kw)


# bytes of an element by the profiler's name of its dtype
DTYPE_BYTES = {"float": 4, "double": 8, "c10::BFloat16": 2, "c10::Half": 2,
               "int": 4, "long int": 8, "signed char": 1}


def roofline_share(ctx, op: str, kernel, cost):
    """A kernel's share of its roofline, %: the least time of a call
    (the larger of its bytes over the HBM rate and its operations over
    the float32 rate), ``cost(shapes, dtypes) -> (bytes, operations)``
    from the op's recorded inputs, averaged over the window's calls of
    ``op``, over the mean device time of the launches whose name matches
    the compiled regex ``kernel``.  None where the window has neither."""
    calls = ctx.trace.op_calls(op)
    launches, seconds = ctx.trace.kernel_seconds(kernel)
    if not calls or not launches or ctx.peaks is None:
        return None
    bound = 0.0
    for shapes, dtypes in calls:
        nbytes, ops = cost(shapes, dtypes)
        bound += max(nbytes / ctx.peaks["hbm_bytes_per_s"],
                     ops / ctx.peaks["float32"])
    return 100.0 * (bound / len(calls)) / (seconds / launches)


# ---------------------------------------------------------------- run

class Run:
    """One run of one cell: its files, the command's arguments, and what
    the traffic kind hands on from the set-up to the window and the
    check."""

    def __init__(self, cell: str, seed: int, seconds: float, trace: bool,
                 device="cuda", tmp=None, wl=None, cfg=None,
                 control=False, fault=None, rate=None):
        self.cell = cell
        self.wl = workload(cell) if wl is None else wl
        self.cfg = config(self.wl["config"]) if cfg is None else cfg
        self.params = dict(self.wl["params"])
        if rate is not None:
            self.params["rate"] = float(rate)
        self.dtype = self.wl["compute_dtype"]
        self.seed, self.seconds, self.trace = int(seed), seconds, trace
        self.device = torch.device(device)
        self.tmp = tmp  # a directory for files the program writes
        self.control, self.fault = control, fault
        self.span = Spans(trace)
        self.marks = []  # (set-up phase, perf_counter ns at its end)

    def mark(self, phase: str):
        """End a phase of the set-up (reported beside ``setup_s``)."""
        self.marks.append((phase, time.perf_counter_ns()))

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)


class MetricContext:
    """What a per-layer reader reads: the metric's name, the run, the
    window's counters and its trace."""

    def __init__(self, name, run, window, trace, device_name):
        self.name, self.run, self.window, self.trace = (name, run, window,
                                                        trace)
        self.peaks = peaks(device_name) if run.cuda else None
        self._flops = {}

    def flops(self, train: bool) -> float:
        if train not in self._flops:
            self._flops[train] = reference_flops(self.run.cfg, train)
        return self._flops[train]


def run_cell(run: Run, bench: dict, start_ns: int) -> dict:
    """Set up, measure, check.  Returns the result line as a dict, the
    checks last; raises on a foreign module."""
    kind = load_module(traffic_path(run.wl["kind"]))
    run.mark("start")
    state = kind.setup(run)
    run.sync()
    bad = foreign_modules()
    if bad:
        raise ForeignModules(bad)
    if run.cuda:
        # the peak from here: what the program holds after its set-up and
        # what the window adds, not the set-up's rendering of the frames
        torch.cuda.reset_peak_memory_stats(run.device)
    trace = Trace() if run.trace else contextlib.nullcontext()
    with trace:
        win = kind.window(run, state)
    setup_s = (win["t0"] - start_ns) / 1e9
    peak = (torch.cuda.max_memory_allocated(run.device) if run.cuda else 0)
    bad = foreign_modules()
    if bad:
        raise ForeignModules(bad)
    tdata = (trace.reduce(win["t0"], win["t1"], run.span.items)
             if run.trace else None)
    kind.release(run, state)
    checks = kind.check(run, state)

    name = torch.cuda.get_device_name(run.device) if run.cuda else "cpu"
    metrics = {}
    section = "per_layer" if run.trace else "end_to_end"
    for m in cell_metrics(bench, run.cell, section):
        if run.trace:
            path = reader_path(m["name"])
            value = None if path is None else load_module(path).read(
                MetricContext(m["name"], run, win, tdata, name))
        elif m["name"] == "setup_s":
            value = setup_s
        else:
            value = win["e2e"][m["name"]]
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    limits = run.wl["limits"]
    if not set(limits) <= set(checks):
        raise KeyError(f"limits {sorted(limits)} for checks {sorted(checks)}")
    correct = win["failed"] == 0 and all(
        math.isfinite(checks[k]) and checks[k] <= limits[k] for k in limits)
    device = {"platform": "gpu" if run.cuda else "cpu", "kind": name,
              "count": 1, "memory_peak_bytes": int(peak)}
    if run.trace:
        device.update(busy_s=tdata.busy_s, window_s=tdata.window_s)
    out = {"correct": bool(correct), "attempted": int(win["attempted"]),
           "failed": int(win["failed"]), "metrics": metrics,
           "device": device}
    if run.trace:
        out["breakdown"] = tdata.breakdown()
    out.update(win.get("notes", {}))
    # what the check read and does not compare (no limit separates it)
    other = {k: v for k, v in checks.items() if k not in limits}
    if other:
        out["uncompared"] = other
    phases, last = {}, start_ns
    for phase, t in run.marks + [("warm", win["t0"])]:
        phases[phase] = (t - last) / 1e9
        last = t
    out["setup_phases_s"] = phases
    out["checks"] = {k: {"value": float(checks[k]), "limit": limits[k]}
                     for k in limits}
    return out


class ForeignModules(RuntimeError):
    pass


def emit(out: dict, stderr=None):
    """The checks as the last lines of standard error, then the result
    as the last line of standard output."""
    stderr = stderr or sys.stderr
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=stderr)
    stderr.flush()
    print(json.dumps(out), flush=True)


def nearest_rank(values, q: float) -> float:
    """The ``q``-quantile by nearest rank (inf ranks above all)."""
    v = np.sort(np.asarray(values, np.float64))
    if len(v) == 0:
        return math.nan
    return float(v[max(0, math.ceil(q * len(v)) - 1)])


def power_limit() -> str:
    """``nvidia-smi``'s name and power limit of the cards, or why not."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"

