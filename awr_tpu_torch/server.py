"""HTTP inference server: network clients -> dynamic batching -> GPU.

The port's copy of the JAX package's ``awr_tpu/server.py``, with the same
routes, JSON, limits and flags:

    HTTP/JSON  ->  BatchingPredictor (awr_tpu_torch/batching.py)  ->
    Predictor (awr_tpu_torch/serving.py: bucketed batches, float32 or
    bfloat16 compute, optional int8)  ->  CUDA

Stdlib-only (``http.server``); the threading server gives each
connection a thread, and those threads all feed the single dispatcher
queue, so concurrent clients coalesce into one device dispatch per drain
group.

API (all JSON):

``POST /predict``    one frame
    {"img": [[...]] (H, W) raw mm depth   (or "img_b64" + "shape":
     base64 of little-endian float32, row-major),
     "center_xyz": [x, y, z] camera mm,
     "cube": [cx, cy, cz] optional crop cube mm}
    -> {"joints_uvd": [[u px, v px, d mm] x J]}   (the reference's dump
       convention, test.py:105-108)

``POST /predict_batch``  many frames in one request (enqueued as one
    multi-row group on the same dispatcher thread that serves
    /predict, so exactly one thread ever touches the device)
    {"imgs": [...] (or "imgs_b64" + "shape"), "centers_xyz": [...],
     "cubes": optional}
    -> {"joints_uvd": [[[...]] x B]}

``GET /healthz``
    -> {"ok": true, "net": ..., "jt_num": ..., "int8": ...,
        "batch_dispatches": N, "frames": N, "shed": N, "rejected": N,
        "padded_share": x, "queue_wait_ms": {"p50", "p95", "n"},
        "service_model_ms": {...}}

Operational limits: the server binds 127.0.0.1 by default (pass
``--host 0.0.0.0`` explicitly to expose it: there is no auth), rejects
request bodies over ``--max-request-mb`` (default 64) with 413 before
reading them, and bounds accepted image shapes (H, W <= 4096;
B <= 1024) before materializing arrays.

Overload behavior: with ``--deadline-ms`` / ``--max-queue`` set, a
request that is rejected at admission (queue full) or shed past its
deadline gets **503** with ``Retry-After: 1`` and a JSON
``{"error": ..., "retryable": true}`` body, instead of queueing into a
convoy (``batching.py`` module docstring).  ``/healthz`` reports the
``shed`` and ``rejected`` counters.

Run::

    python -m awr_tpu_torch.server --pth resnet_18.pth --net resnet_18 \\
        --port 8000 [--int8-calib calib.npy] [--max-batch 64] [--device cpu]
"""

from __future__ import annotations

import argparse
import base64
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from awr_tpu_torch.batching import (BatchingPredictor, DeadlineExceeded,
                                    QueueFull)


def _decode_img(obj: dict, key: str = "img") -> np.ndarray:
    """One frame from JSON: nested lists, or base64 float32 + shape."""
    if key in obj:
        img = np.asarray(obj[key], np.float32)
    elif f"{key}_b64" in obj:
        shape = obj.get("shape")
        if not shape:
            raise ValueError(f"'{key}_b64' needs 'shape'")
        buf = base64.b64decode(obj[f"{key}_b64"])
        img = np.frombuffer(buf, dtype="<f4").reshape(shape)
    else:
        raise ValueError(f"request needs '{key}' or '{key}_b64'")
    if img.ndim != 2:
        raise ValueError(f"'{key}' must be one (H, W) frame, "
                         f"got shape {tuple(img.shape)}")
    return img


class AWRServer:
    """Owns the Predictor + batching layer and serves HTTP on a port.

    ``port=0`` binds an ephemeral port; read it back from ``self.port``
    after construction.
    """

    MAX_SIDE = 4096      # per-frame H/W bound
    MAX_FRAMES = 1024    # per-request batch bound

    def __init__(self, predictor, host: str = "127.0.0.1",
                 port: int = 8000, max_batch: int = 64,
                 max_wait_ms: float = 2.0,
                 max_request_bytes: int = 64 * 1024 * 1024,
                 deadline_ms: Optional[float] = None,
                 max_queue: Optional[int] = None,
                 pipeline_depth: int = 2,
                 deadline_margin: float = 1.0):
        self.predictor = predictor
        self.max_request_bytes = int(max_request_bytes)
        self.batcher = BatchingPredictor(predictor, max_batch=max_batch,
                                         max_wait_ms=max_wait_ms,
                                         deadline_ms=deadline_ms,
                                         max_queue=max_queue,
                                         pipeline_depth=pipeline_depth,
                                         deadline_margin=deadline_margin)
        server = self

        class Handler(BaseHTTPRequestHandler):
            # quiet: no per-request stderr lines
            def log_message(self, fmt, *args):  # noqa: D102
                pass

            def _reply(self, code: int, payload: dict,
                       extra_headers: Optional[dict] = None):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (extra_headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 (http.server API)
                if self.path != "/healthz":
                    self._reply(404, {"error": f"no route {self.path}"})
                    return
                self._reply(200, {
                    "ok": True,
                    "net": server.predictor.cfg.net,
                    "jt_num": server.predictor.cfg.jt_num,
                    "int8": is_int8(server.predictor),
                    "batch_dispatches": server.batcher.n_dispatches,
                    "frames": server.batcher.n_frames,
                    "shed": server.batcher.n_shed,
                    "rejected": server.batcher.n_rejected,
                    # the share of the rows sent to the device that were
                    # bucket padding, and the requests' queue wait (ms)
                    "padded_share": padded_share(server.predictor),
                    "queue_wait_ms": server.batcher.queue_wait_ms(),
                    # measured per-(bucket, frame-shape) service (ms)
                    # driving the deadline machinery; {} until traffic
                    # or priming.  The shed decision runs on p50 (the
                    # windowed median), the group-size cap on p90.
                    "service_model_ms": {
                        (str(b) if shape is None
                         else f"{b}@{shape[0]}x{shape[1]}"): {
                            "p50": round(st["p50_s"] * 1e3, 2),
                            "p90": round(st["p90_s"] * 1e3, 2),
                            "n": st["n"],
                        }
                        for (b, shape), st in
                        server.batcher.service_model.snapshot().items()
                    },
                })

            def do_POST(self):  # noqa: N802
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    if n > server.max_request_bytes:
                        # refuse before reading: one oversized body must
                        # not exhaust host memory
                        self._reply(413, {
                            "error": f"request body {n} bytes exceeds "
                                     f"limit {server.max_request_bytes}"})
                        return
                    obj = json.loads(self.rfile.read(n) or b"{}")
                    if self.path == "/predict":
                        out = server._predict_one(obj)
                    elif self.path == "/predict_batch":
                        out = server._predict_batch(obj)
                    else:
                        self._reply(404,
                                    {"error": f"no route {self.path}"})
                        return
                    self._reply(200, out)
                except (QueueFull, DeadlineExceeded) as e:
                    # overload, not a server fault: tell the client to
                    # back off and retry (batching.py module docstring;
                    # both paths are bounded-latency by construction)
                    self._reply(503, {"error": str(e),
                                      "retryable": True},
                                extra_headers={"Retry-After": "1"})
                except (ValueError, KeyError, json.JSONDecodeError) as e:
                    self._reply(400, {"error": str(e)})
                except Exception as e:  # noqa: BLE001 - report, don't die
                    self._reply(500, {"error": f"{type(e).__name__}: {e}"})

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ routes
    def _predict_one(self, obj: dict) -> dict:
        img = _decode_img(obj)
        center = np.asarray(obj["center_xyz"], np.float64)
        if center.shape != (3,):
            raise ValueError("'center_xyz' must be [x, y, z]")
        cube = obj.get("cube")
        if cube is not None:
            cube = np.asarray(cube, np.float64)
            if cube.shape != (3,):
                raise ValueError("'cube' must be [cx, cy, cz]")
        self._check_shape(img.shape)
        # through the dynamic batcher: concurrent HTTP threads coalesce
        joints = self.batcher.predict(img, center, cube)
        return {"joints_uvd": np.asarray(joints).tolist()}

    def _predict_batch(self, obj: dict) -> dict:
        if "imgs" in obj:
            imgs = np.asarray(obj["imgs"], np.float32)
        elif "imgs_b64" in obj:
            shape = obj.get("shape")
            if not shape:
                raise ValueError("'imgs_b64' needs 'shape'")
            imgs = np.frombuffer(base64.b64decode(obj["imgs_b64"]),
                                 dtype="<f4").reshape(shape)
        else:
            raise ValueError("request needs 'imgs' or 'imgs_b64'")
        if imgs.ndim != 3:
            raise ValueError(f"'imgs' must be (B, H, W), got "
                             f"{tuple(imgs.shape)}")
        self._check_shape(imgs.shape[1:], n_frames=imgs.shape[0])
        # through the dispatcher thread (batching.submit_batch): a
        # direct Predictor call from this handler thread would enqueue
        # on the device concurrently with the dispatcher
        out = self.batcher.predict_batch(imgs, obj["centers_xyz"],
                                         obj.get("cubes"))
        return {"joints_uvd": np.asarray(out).tolist()}

    @classmethod
    def _check_shape(cls, hw, n_frames=1):
        h, w = hw
        if h > cls.MAX_SIDE or w > cls.MAX_SIDE or h < 1 or w < 1:
            raise ValueError(f"frame shape {(h, w)} outside "
                             f"(1..{cls.MAX_SIDE})^2")
        if n_frames > cls.MAX_FRAMES:
            raise ValueError(f"{n_frames} frames exceeds per-request "
                             f"limit {cls.MAX_FRAMES}")

    # --------------------------------------------------------- lifecycle
    def serve_forever(self):
        self.httpd.serve_forever()

    def start(self) -> "AWRServer":
        """Serve on a background thread (tests / embedding)."""
        self._thread = threading.Thread(target=self.serve_forever,
                                        daemon=True, name="awr-http")
        self._thread.start()
        return self

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self.batcher.close()

    def __enter__(self) -> "AWRServer":
        return self

    def __exit__(self, *exc):
        self.close()


def is_int8(predictor) -> bool:
    """Whether the Predictor serves int8: the port's Predictor holds its
    calibrated scales in ``quant``, None until it is quantized."""
    return getattr(predictor, "quant", None) is not None


def padded_share(predictor) -> float:
    """The share of the rows the Predictor sent to the device that were
    padding up to a bucket (0 before the first)."""
    pad = getattr(predictor, "n_padded_rows", 0)
    total = getattr(predictor, "n_frames", 0) + pad
    return pad / total if total else 0.0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ckpt", default="",
                    help="the port's checkpoint directory (a Trainer's "
                         "ckpt/, Predictor.from_checkpoint)")
    ap.add_argument("--pth", default="",
                    help="reference torch .pth checkpoint")
    ap.add_argument("--net", default="resnet_18")
    ap.add_argument("--dataset", default="nyu")
    ap.add_argument("--img-size", type=int, default=128)
    ap.add_argument("--downsample", type=int, default=2)
    ap.add_argument("--compute-dtype", default="bfloat16")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cuda, or cpu)")
    ap.add_argument("--host", default="127.0.0.1",
                    help="bind address; pass 0.0.0.0 explicitly to "
                         "expose the (auth-less) server")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--max-request-mb", type=int, default=64,
                    help="reject request bodies larger than this")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request latency budget: enables latency-"
                         "bounded dispatch + load shedding (503) under "
                         "overload")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bound on queued frames; admission rejects "
                         "(503) when full")
    ap.add_argument("--pipeline-depth", type=int, default=2,
                    help="dispatched-but-unfinalized group bound "
                         "(batching.BatchingPredictor)")
    ap.add_argument("--deadline-margin", type=float, default=1.0,
                    help="scale service ESTIMATES in the deadline "
                         "math; above 1 trades served count for tighter "
                         "deadline adherence")
    ap.add_argument("--int8-calib", default="",
                    help=".npy of (N, S, S) normalized calibration "
                         "frames: serve int8 (Predictor.quantize)")
    ap.add_argument("--prime", type=int, nargs=2, default=None,
                    metavar=("H0", "W0"),
                    help="raw frame shape to prime with: runs every "
                         "dispatch bucket and seeds the service-time "
                         "model BEFORE accepting traffic, so the "
                         "deadline machinery bounds latency from the "
                         "first burst (batching.prime_service_model); "
                         "its cost is printed")
    args = ap.parse_args(argv)

    from awr_tpu_torch.config import JOINT, Config
    from awr_tpu_torch.serving import Predictor

    ks = 1.0 if args.net.startswith("resnet") else 0.4
    cfg = Config(net=args.net, dataset=args.dataset,
                 jt_num=JOINT[args.dataset], img_size=args.img_size,
                 downsample=args.downsample, kernel_size=ks,
                 compute_dtype=args.compute_dtype)
    if args.ckpt:
        pred = Predictor.from_checkpoint(cfg, args.ckpt, device=args.device)
    elif args.pth:
        pred = Predictor.from_torch(cfg, args.pth, device=args.device)
    else:
        raise SystemExit("pass --ckpt or --pth")
    if args.int8_calib:
        pred.quantize(np.load(args.int8_calib))
    srv = AWRServer(pred, host=args.host, port=args.port,
                    max_batch=args.max_batch,
                    max_wait_ms=args.max_wait_ms,
                    max_request_bytes=args.max_request_mb * 1024 * 1024,
                    deadline_ms=args.deadline_ms,
                    max_queue=args.max_queue,
                    pipeline_depth=args.pipeline_depth,
                    deadline_margin=args.deadline_margin)
    if args.prime:
        # before serving: no client traffic interleaves with priming
        snap = srv.batcher.prime_service_model(tuple(args.prime))
        print("primed service model (p90): "
              + ", ".join(f"b{k}={v * 1e3:.1f}ms"
                          for k, v in sorted(snap.items())))
        print(f"priming cost: {srv.batcher.prime_stats['total_s']:.1f}s "
              f"total; per bucket first/measure s: "
              + ", ".join(
                  f"b{b}={d['first_s']:.1f}/{d['measure_s']:.1f}"
                  for b, d in sorted(
                      srv.batcher.prime_stats['per_bucket'].items())))
    print(f"serving {cfg.net} on {args.host}:{srv.port} "
          f"(int8={is_int8(pred)})", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        srv.close()


if __name__ == "__main__":
    main()
