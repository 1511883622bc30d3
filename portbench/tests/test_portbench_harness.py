"""The benchmark's files, names and arithmetic, on the CPU."""

import json
import math
import re
import shutil
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from portbench import harness
from portbench.tests import cells

BENCH = harness.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E = {m["name"] for m in BENCH["end_to_end"]}


def test_top_level_keys():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert len(json.dumps(BENCH).encode()) < 64 * 1024


def test_check_fits_its_time():
    s, n = BENCH["run_seconds"], 24
    assert 1 <= s <= 51 and s == int(s)
    assert (2 + 14 * n) * (s + 60) + n * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert entry["chips"] == 1 and 0 < len(entry["why"]) <= 200
    wl = harness.workload(cell)
    assert (wl["name"], wl["config"], wl["traffic"]) == (
        cell, entry["config"], entry["traffic"])
    assert harness.traffic_path(wl["kind"]).exists()
    assert wl["compute_dtype"] in ("float32", "bfloat16")
    assert wl["limits"] and all(v > 0 for v in wl["limits"].values())
    conf = next(c for c in BENCH["configs"] if c["name"] == wl["config"])
    assert conf["file"] == f"portbench/configs/{wl['config']}.json"
    cfg = harness.config(wl["config"])
    assert cfg["name"] == wl["config"] and cfg["reduced"] == conf["reduced"]
    assert cfg["feature_size"] == cfg["img_size"] // cfg["downsample"]
    # the intrinsics the program takes for the dataset are the file's
    from awr_tpu_torch.config import Config
    program = Config(dataset=cfg["dataset"])
    assert list(program.paras) == cfg["paras"] and program.flip == cfg["flip"]


def test_configs_and_pairs():
    assert {c["name"] for c in BENCH["configs"]} == {
        w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["source"].startswith("https://") and not c["reduced"]
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_names_and_units():
    names = ([m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
             + CELLS + [c["name"] for c in BENCH["configs"]]
             + [w["traffic"] for w in BENCH["workloads"]])
    assert all(NAME.match(n) for n in names), names
    metric_names = [m["name"] for m in BENCH["end_to_end"]
                    + BENCH["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for path in harness.ROOT.rglob("*"):
        rel = str(path.relative_to(harness.REPO))
        assert re.match(r"^[A-Za-z0-9_.\-/]+$", rel), rel


def test_end_to_end_metrics():
    names = [m["name"] for m in BENCH["end_to_end"]]
    assert "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    assert next(m for m in BENCH["end_to_end"]
                if m["name"] == "setup_s")["bound"] == 0.25


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports(cell):
    e2e = [m["name"] for m in harness.cell_metrics(BENCH, cell,
                                                   "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.cell_metrics(BENCH, cell, "per_layer")


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_per_layer_metric(metric):
    path = harness.reader_path(metric["name"])
    assert path is not None, metric["name"]
    assert callable(harness.load_module(path).read)
    assert set(metric) == {"name", "unit", "better", "source", "layer",
                           "moves", "workloads"}
    assert metric["moves"] in E2E
    for cell in metric["workloads"]:
        assert cell in CELLS
        assert metric["moves"] in [m["name"] for m in harness.cell_metrics(
            BENCH, cell, "end_to_end")]
    assert "\n" not in metric["layer"] and len(metric["layer"]) <= 200


def test_one_layer_name_per_family():
    # decode_roofline.train and decode_roofline.serve measure one layer
    layers = {}
    for m in BENCH["per_layer"]:
        family = m["name"].rsplit(".", 1)[0]
        layers.setdefault(family, set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers


# ------------------------------------------------------- kernel bytes

def reader(name):
    return harness.load_module(harness.reader_path(name))


@pytest.mark.parametrize("B,bound_ms", [(8, 0.00223), (32, 0.00892),
                                        (256, 0.07139)])
def test_decode_bytes_reproduce_bounds(B, bound_ms):
    nbytes, ops = reader("decode_roofline.train").cost(
        [[B, 56, 64, 64], [B, 128, 128], []], ["float", "float", "Scalar"])
    assert round(nbytes / 3.35e12 * 1e3, 5) == bound_ms
    assert ops / 67e12 < nbytes / 3.35e12


def test_decode_backward_bytes_reproduce_bound():
    nbytes, _ = reader("decode_bwd_roofline.train").cost(
        [[32, 56, 64, 64], [32, 128, 128], [32, 14, 3], [32, 14, 2],
         [32, 14, 3], []], ["float"] * 5 + ["Scalar"])
    assert round(nbytes / 3.35e12 * 1e3, 5) == 0.01769


def fake_ctx(name, device, ops, cfg=None, window=None):
    trace = harness.TraceData(device, ops, [], 0, 10_000_000)
    return SimpleNamespace(name=name, trace=trace,
                           peaks=harness.peaks("NVIDIA H100 80GB HBM3"),
                           run=SimpleNamespace(cfg=cfg or {}, dtype="float32"),
                           window=window or {})


def test_encode_share_arithmetic():
    # two calls at B = 32 (bound 8.92 us each) against two launches of
    # 11.2 us: 79.7 %
    ops = [("awr_tpu_torch::encode", [[32, 14, 3], [32, 128, 128], [], []],
            ["float", "float", "Scalar", "Scalar"])] * 2
    dev = [("void encode_kernel(float const*)", 0, 11_200),
           ("void encode_kernel(float const*)", 20_000, 31_200),
           ("void decode_kernel<float, 4>(float const*)", 40_000, 50_000)]
    share = reader("encode_roofline.train").read(
        fake_ctx("encode_roofline.train", dev, ops, {"feature_size": 64}))
    assert share == pytest.approx(100 * 8.922e-6 / 11.2e-6, rel=1e-3)
    # no launch of the kernel in the window: nothing to read
    assert reader("encode_roofline.train").read(fake_ctx(
        "encode_roofline.train", dev[2:], ops, {"feature_size": 64})) is None


def test_decode_kernel_names_do_not_mix():
    dec = reader("decode_roofline.train").KERNEL
    bwd = reader("decode_bwd_roofline.train").KERNEL
    assert dec.search("void decode_kernel<float, 4>(float const*, int)")
    assert not dec.search("void decode_backward_kernel<float, 4>(float)")
    assert bwd.search("void decode_backward_kernel<float, 4>(float)")
    assert not dec.search("void encode_kernel(float const*)")


# ----------------------------------------------------------- idle time

def test_idle_share_on_overlapping_intervals():
    # a copy overlapping two kernels, a kernel inside the copy, one
    # interval reaching past the window's end (ns)
    device = [("Memcpy HtoD", 100, 400), ("k1", 300, 500), ("k2", 350, 380),
              ("k3", 700, 800), ("k4", 950, 1200)]
    t = harness.TraceData(device, [], [("step", 0, 600), ("wait", 600, 1000)],
                          0, 1000)
    assert t.busy_s == pytest.approx((400 + 100 + 50) / 1e9)
    assert t.gaps == [(0, 100), (500, 700), (800, 950)]
    ctx = SimpleNamespace(trace=t)
    assert reader("device.idle_share.train").read(ctx) == pytest.approx(45.0)
    # (500, 700) overlaps both spans alike: the step names it
    assert t.breakdown()["idle_gaps"] == [["step", 2e-7], ["wait", 1.5e-7],
                                          ["step", 1e-7]]
    assert t.breakdown()["device_ops"][0] == ["Memcpy HtoD", 3e-7]


def test_nearest_rank():
    v = list(range(1, 101))
    assert harness.nearest_rank(v, 0.95) == 95
    assert harness.nearest_rank(v, 0.5) == 50
    assert harness.nearest_rank([3.0], 0.95) == 3.0
    assert math.isnan(harness.nearest_rank([], 0.5))


def test_peaks_of_the_card_only():
    assert harness.peaks("NVIDIA H100 80GB HBM3")["float32"] == 67e12
    with pytest.raises(ValueError):
        harness.peaks("NVIDIA H100 PCIe")


def test_mfu_arithmetic():
    ctx = fake_ctx("mfu.train", [("k", 0, 5_000_000)], [],
                   harness.config("hourglass_1"), {"frames": 2})
    # 2 frames x 34.26 GFLOP in 10 ms over 67 TFLOP/s
    ctx.flops = lambda train: 34.26e9 if train else 11.44e9
    assert harness.load_module(harness.reader_path("mfu.train")).read(
        ctx) == pytest.approx(100 * 2 * 34.26e9 / 0.01 / 67e12)
    ctx.name = "mfu.serve"  # over the 5 ms busy
    assert harness.load_module(harness.reader_path("mfu.serve")).read(
        ctx) == pytest.approx(100 * 2 * 11.44e9 / 0.005 / 67e12)


# ------------------------------------------------------------- run.py

def run_py(cwd, *args):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "hg1-train-f32",
         "--seed", "2147483651", "--seconds", "1", "--trace", "0", *args],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_run_without_card_fails():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = run_py(harness.REPO)
    assert r.returncode != 0 and r.stdout == ""
    assert "no CUDA device" in r.stderr


def test_run_without_program_fails(tmp_path):
    shutil.copy(harness.REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.ROOT, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = run_py(tmp_path)
    assert r.returncode != 0 and r.stdout == ""


def test_unknown_cell_fails():
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "no-such-cell", "--seed", "1", "--seconds", "1"],
                       cwd=harness.REPO, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0 and r.stdout == ""


# ------------------------------------------------- a traced run, small

def test_traced_run_records_program_ops(one_thread):
    out = cells.run("hg1-train-f32", trace=True)
    assert out["device"]["window_s"] > 0 and out["device"]["busy_s"] == 0
    assert list(out)[-1] == "checks" and out["metrics"] == {}
    assert out["breakdown"]["idle_gaps"]


def test_traced_serving_reads_counters(one_thread):
    # the open loop is no cell of BENCHMARK.json yet: its metrics as a
    # later entry would declare them
    serve = dict(unit="%", better="higher", source="device_trace",
                 layer="x", moves="serve_p95_ms",
                 workloads=["hg1-serve-f32-open"])
    bench = dict(BENCH, per_layer=[
        dict(serve, name="batching.frames_per_dispatch", unit="frames",
             source="program_counter"),
        dict(serve, name="decode_roofline.serve"),
        dict(serve, name="device.idle_share.serve", better="lower")])
    out = cells.run("hg1-serve-f32-open", trace=True, bench=bench)
    got = out["metrics"]
    assert got["batching.frames_per_dispatch"]["value"] >= 1
    # no device on the CPU: no roofline, no idle share
    assert "decode_roofline.serve" not in got
    assert "device.idle_share.serve" not in got


def test_trace_reduce_keeps_program_ops(one_thread):
    import time

    from awr_tpu_torch.ops.decode import decode_offsets

    off = torch.randn(2, 56, 16, 16)
    img = torch.zeros(2, 32, 32)
    with harness.Trace() as tr:
        t0 = time.perf_counter_ns()
        decode_offsets(off, img, 0.4)
        t1 = time.perf_counter_ns()
    data = tr.reduce(t0, t1, [])
    calls = data.op_calls("awr_tpu_torch::decode")
    assert calls and calls[0][0][0] == [2, 56, 16, 16]
    assert calls[0][1][0] == "float"
