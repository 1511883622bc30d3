"""The port's HTTP server (``awr_tpu_torch/server.py``) against the JAX
package's ``awr_tpu/server.py`` on the same hourglass_1 weights, its
limits and overload replies, the server CLI in a subprocess, and the
kernel build's lock (the server loads kernels from its dispatcher
thread)."""

import base64
import http.client
import json
import os
import pathlib
import re
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from torch_port_weights import flax_variables
from torch_port_weights import one_thread  # noqa: F401
from torch_serving_stub import CENTER, IMG, WAIT_S, Stub, frame

from awr_tpu.config import hourglass_config as jax_hourglass_config
from awr_tpu.server import AWRServer as JaxAWRServer
from awr_tpu.serving import Predictor as JaxPredictor
from awr_tpu_torch import kernels, server
from awr_tpu_torch.config import hourglass_config, resnet_config
from awr_tpu_torch.data.device import crop_normalize_batch
from awr_tpu_torch.data.synthetic import synthetic_frames
from awr_tpu_torch.geometry import xyz2uvd_np
from awr_tpu_torch.models import build_model
from awr_tpu_torch.models.common import torch_default_init_
from awr_tpu_torch.models.weights import load_flax_variables
from awr_tpu_torch.server import AWRServer
from awr_tpu_torch.serving import Predictor

ROOT = pathlib.Path(__file__).resolve().parent.parent
# the port's joints against the JAX package's on the same weights
# (tests/test_torch_serving.py, px / mm); the server's against a direct
# predict on the same frames: the JAX package's batching bar
# (tests/test_batching.py:59)
JAX_ATOL = 0.05
RTOL, ATOL = 1e-4, 1e-3


@pytest.fixture(scope="module")
def predictors():
    _, variables = flax_variables(1, seed=5)
    jax_pred = JaxPredictor(
        jax_hourglass_config(img_size=IMG, use_pallas=False), variables)
    cfg = hourglass_config(img_size=IMG)
    model = load_flax_variables(build_model(cfg.net, cfg.jt_num), variables)
    return jax_pred, Predictor(cfg, model, device="cpu")


@pytest.fixture(scope="module")
def servers(predictors):
    # max_batch 8: every group lands on bucket 8 (one JAX compile)
    jax_pred, pred = predictors
    with JaxAWRServer(jax_pred, port=0, max_batch=8).start() as js, \
            AWRServer(pred, port=0, max_batch=8).start() as ts:
        yield js, ts


@pytest.fixture(scope="module")
def frames():
    imgs, _, centers = synthetic_frames(4, 14, seed=7)
    return imgs, centers


def _post(srv, path, obj, timeout=120):
    """(status, headers, parsed body) of a POST, 4xx/5xx included."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}{path}", data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read() or b"{}")


def _get(port, path="/healthz"):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=WAIT_S) as r:
        return json.loads(r.read())


def _b64(a):
    return base64.b64encode(np.ascontiguousarray(a, "<f4").tobytes()).decode()


def _joints(srv, path, obj):
    status, _, body = _post(srv, path, obj)
    assert status == 200, body
    return np.asarray(body["joints_uvd"])


@pytest.mark.parametrize("encoding", ["json", "b64"])
def test_predict_matches_jax_server(servers, frames, encoding):
    js, ts = servers
    imgs, centers = frames
    obj = ({"img": imgs[0].tolist()} if encoding == "json" else
           {"img_b64": _b64(imgs[0]), "shape": list(imgs[0].shape)})
    obj["center_xyz"] = centers[0].tolist()
    got, want = _joints(ts, "/predict", obj), _joints(js, "/predict", obj)
    assert got.shape == (14, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=JAX_ATOL)
    np.testing.assert_allclose(
        got, ts.predictor.predict(imgs[:1], centers[:1])[0], rtol=RTOL,
        atol=ATOL)


@pytest.mark.parametrize("encoding", ["json", "b64"])
def test_predict_batch_matches_jax_server(servers, frames, encoding):
    js, ts = servers
    imgs, centers = frames
    obj = ({"imgs": imgs.tolist()} if encoding == "json" else
           {"imgs_b64": _b64(imgs), "shape": list(imgs.shape)})
    obj["centers_xyz"] = centers.tolist()
    obj["cubes"] = [[280.0, 280.0, 300.0]] * len(imgs)
    frames_before = ts.batcher.n_frames
    got = _joints(ts, "/predict_batch", obj)
    want = _joints(js, "/predict_batch", obj)
    assert got.shape == (4, 14, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=JAX_ATOL)
    np.testing.assert_allclose(
        got, ts.predictor.predict(imgs, centers, obj["cubes"]), rtol=RTOL,
        atol=ATOL)
    assert ts.batcher.n_frames == frames_before + 4  # via the dispatcher


def test_healthz_has_the_jax_keys(servers, frames):
    js, ts = servers
    imgs, centers = frames
    _joints(ts, "/predict", {"img_b64": _b64(imgs[1]),
                             "shape": list(imgs[1].shape),
                             "center_xyz": centers[1].tolist()})
    h, hj = _get(ts.port), _get(js.port)
    # the port reports two keys more (tests/test_torch_tracing.py)
    assert set(h) == set(hj) | {"padded_share", "queue_wait_ms"}
    assert h["ok"] and h["net"] == "hourglass_1" and h["jt_num"] == 14
    assert h["int8"] is False  # hasattr(predictor, "quant") would say True
    assert h["batch_dispatches"] >= 1 and h["frames"] >= 1
    assert h["shed"] == h["rejected"] == 0
    for key, st in h["service_model_ms"].items():
        assert re.fullmatch(r"8@480x640", key), key
        assert 0 <= st["p50"] <= st["p90"] and st["n"] >= 1


def test_healthz_reports_int8_after_quantize(frames):
    cfg = hourglass_config(img_size=IMG)
    model = build_model(cfg.net, cfg.jt_num)
    torch_default_init_(model, torch.Generator().manual_seed(0))
    pred = Predictor(cfg, model, device="cpu")
    imgs, centers = frames
    crops, _ = crop_normalize_batch(
        torch.from_numpy(imgs), xyz2uvd_np(centers, cfg.paras, cfg.flip),
        np.tile(cfg.cube, (len(imgs), 1)), cfg.paras, IMG)
    with AWRServer(pred, port=0).start() as srv:
        assert _get(srv.port)["int8"] is False
        pred.quantize(crops.numpy())
        assert _get(srv.port)["int8"] is True
        got = _joints(srv, "/predict", {"img": imgs[0].tolist(),
                                        "center_xyz": centers[0].tolist()})
        np.testing.assert_allclose(got, pred.predict(imgs[:1], centers[:1])[0],
                                   rtol=RTOL, atol=ATOL)


BAD = [
    ("/predict", {"center_xyz": [0.0, 0.0, 500.0]}, 400),         # no img
    ("/predict", {"img": [[1.0]], "center_xyz": [1.0, 2.0]}, 400),
    ("/predict", {"img": [1.0, 2.0], "center_xyz": [0, 0, 500]}, 400),
    ("/predict", {"img_b64": "AAAA", "center_xyz": [0, 0, 500]}, 400),
    ("/predict", {"img": [[1.0]], "center_xyz": [0, 0, 500],
                  "cube": [1.0]}, 400),
    ("/predict_batch", {"imgs": [[[1.0]]] * 3,
                        "centers_xyz": [[0, 0, 500]] * 2}, 400),
    ("/predict_batch", {"imgs_b64": base64.b64encode(
        np.zeros((2048, 2, 2), "<f4").tobytes()).decode(),
        "shape": [2048, 2, 2], "centers_xyz": [[0, 0, 500]] * 2048}, 400),
    ("/predict", {"img": np.zeros((4097, 1)).tolist(),
                  "center_xyz": [0, 0, 500]}, 400),
    ("/nope", {}, 404),
]


@pytest.mark.parametrize("path,obj,code", BAD)
def test_malformed_requests_get_4xx(servers, path, obj, code):
    _, ts = servers
    status, _, body = _post(ts, path, obj)
    assert status == code and "error" in body, body
    assert _get(ts.port)["ok"]


def test_unknown_get_route_and_oversized_body(servers):
    _, ts = servers
    with pytest.raises(urllib.error.HTTPError) as exc:
        _get(ts.port, "/nope")
    assert exc.value.code == 404
    conn = http.client.HTTPConnection("127.0.0.1", ts.port, timeout=WAIT_S)
    try:
        conn.putrequest("POST", "/predict")
        conn.putheader("Content-Type", "application/json")
        conn.putheader("Content-Length", str(ts.max_request_bytes + 1))
        conn.endheaders()  # the body is never sent: 413 before reading
        assert conn.getresponse().status == 413
    finally:
        conn.close()


def test_overload_returns_503_with_retry_after():
    """Admission control end to end on a gated stub: with the pipeline
    and the 1-frame queue full, a request gets 503, Retry-After and a
    retryable body; the accepted ones serve once the device frees."""
    stub = Stub(gated=True)
    with AWRServer(stub, port=0, max_batch=1, max_wait_ms=0.0, max_queue=1,
                   pipeline_depth=1).start() as srv:
        results = {}

        def client(i):
            results[i] = _post(srv, "/predict", {
                "img": frame(i).tolist(), "center_xyz": CENTER.tolist()})

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(4)]
        for i, t in enumerate(threads[:3]):  # fill the dispatch pipeline
            t.start()
            stub.wait_dispatches(i + 1)
        admitted = threading.Event()
        admit = srv.batcher._admit

        def admit_spy(req):
            admit(req)
            admitted.set()

        srv.batcher._admit = admit_spy
        threads[3].start()  # queued: 1 of 1
        assert admitted.wait(WAIT_S)
        assert srv.batcher._queued_frames == 1
        status, headers, body = _post(srv, "/predict", {
            "img": frame(9).tolist(), "center_xyz": CENTER.tolist()})
        assert status == 503 and headers["Retry-After"] == "1"
        assert body["retryable"] is True and "max_queue" in body["error"]
        stub.open_all()
        for t in threads:
            t.join(WAIT_S)
        assert [results[i][0] for i in range(4)] == [200] * 4
        assert [results[i][2]["joints_uvd"][0][0] for i in range(4)] == [
            0.0, 1.0, 2.0, 3.0]
        h = _get(srv.port)
        assert h["rejected"] == 1 and h["frames"] == 4


def _tiny_resnet(path):
    model = build_model("resnet_18", 14, 2)
    torch_default_init_(model, torch.Generator().manual_seed(0))
    torch.save(model.state_dict(), path)


def test_cli_serves_on_the_cpu(tmp_path, frames):
    """``python -m awr_tpu_torch.server --device cpu``: the startup line
    names the bound port; one frame comes back as the same Predictor
    built in this process gives it."""
    pth = tmp_path / "resnet_18.pth"
    _tiny_resnet(pth)
    proc = subprocess.Popen(
        [sys.executable, "-m", "awr_tpu_torch.server", "--device", "cpu",
         "--pth", str(pth), "--img-size", str(IMG), "--port", "0"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=dict(os.environ, OMP_NUM_THREADS="1"))
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            m = re.match(r"serving resnet_18 on 127\.0\.0\.1:(\d+) "
                         r"\(int8=False\)", line)
            if m:
                break
        assert m, "".join(lines)
        port = int(m.group(1))
        assert _get(port)["net"] == "resnet_18"
        imgs, centers = frames
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/predict",
            data=json.dumps({"img_b64": _b64(imgs[0]),
                             "shape": list(imgs[0].shape),
                             "center_xyz": centers[0].tolist()}).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            got = np.asarray(json.loads(r.read())["joints_uvd"])
    finally:
        proc.terminate()
        proc.wait(timeout=WAIT_S)
    cfg = resnet_config(img_size=IMG, compute_dtype="bfloat16")
    want = Predictor.from_torch(cfg, str(pth), device="cpu").predict(
        imgs[:1], centers[:1])[0]
    assert got.shape == (14, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=JAX_ATOL)


def test_cli_without_a_device_raises_when_there_is_no_gpu(tmp_path,
                                                          monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pth = tmp_path / "resnet_18.pth"
    _tiny_resnet(pth)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        server.main(["--pth", str(pth), "--img-size", str(IMG)])


def test_concurrent_first_loads_build_once(tmp_path, monkeypatch):
    """Two threads that first load one library at once: one compiler
    runs, and both get a working library."""
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    kernels.load.cache_clear()
    popen = kernels.subprocess.Popen
    compiles = []

    def counting_popen(*a, **kw):
        compiles.append(a[0])
        return popen(*a, **kw)

    monkeypatch.setattr(kernels.subprocess, "Popen", counting_popen)
    start = threading.Barrier(2)
    libs, errors = [None, None], []

    def first_load(i):
        try:
            start.wait(WAIT_S)
            libs[i] = kernels.load("png_unfilter")
        except Exception as e:  # noqa: BLE001 - collected for the assert
            errors.append(e)

    try:
        threads = [threading.Thread(target=first_load, args=(i,))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not errors and all(lib is not None for lib in libs), errors
        assert len(compiles) == 1
        assert [p.name for p in tmp_path.iterdir()] == [
            kernels.library_path("png_unfilter").name]
    finally:
        kernels.load.cache_clear()
