"""Open loop: independent users each sending one depth frame, through
the program's ``BatchingPredictor.submit``.

Parameters (the workload file's ``params``): ``rate`` (requests/s),
``pool`` (frames rendered from the seed), ``max_batch``, ``max_wait_ms``
and ``pipeline_depth`` (the batcher's; the server CLI's defaults).

The run sends ``round(rate * seconds)`` requests, due at times drawn
uniformly over the window and sorted (arrivals of a Poisson process of
that rate, given their count), each a pool frame drawn from the seed
and its hand center.  The generator runs on the calling thread and
sleeps until each request is due; a request's latency is from when it
was due until its joints were resolved on the host.  After the window
every request is waited for, up to 60 s; one that failed or never came
counts as slower than every other.  The answers are compared with the
reference's joints of their frames.
"""

from __future__ import annotations

import threading
import time
from types import SimpleNamespace

import numpy as np
import torch

from portbench import harness, predictor

GRACE_S = 60.0


def setup(run):
    from awr_tpu_torch.batching import BatchingPredictor

    p = run.params
    pred, pool, state = predictor.build(run)
    bp = BatchingPredictor(pred, max_batch=p["max_batch"],
                           max_wait_ms=p["max_wait_ms"],
                           pipeline_depth=p["pipeline_depth"])
    predictor.warm(pred, lambda f, c: bp.submit_batch(f, c).result(), pool,
                   p["max_batch"])
    n = int(round(p["rate"] * run.seconds))
    g = np.random.default_rng([run.seed, 1])
    due = np.sort(g.uniform(0.0, run.seconds, n))
    idx = g.integers(0, len(pool), n)
    return SimpleNamespace(pred=pred, bp=bp, pool=pool, state=state, due=due,
                           idx=idx, answers=[None] * n)


def window(run, st):
    n = len(st.due)
    done_ns = np.zeros(n, np.int64)
    ok = np.zeros(n, bool)
    late = np.zeros(n)
    lock, finished = threading.Lock(), threading.Event()
    count = [0]

    def resolved(i, fut):
        t = time.perf_counter_ns()
        if fut.exception() is None:
            st.answers[i], ok[i], done_ns[i] = fut.result(), True, t
        with lock:
            count[0] += 1
            if count[0] == n:
                finished.set()

    d0, f0 = st.bp.n_dispatches, st.bp.n_frames
    frames, centers = st.pool.frames, st.pool.centers
    t0 = time.perf_counter_ns()
    for i in range(n):
        due = t0 + int(st.due[i] * 1e9)
        with run.span("loadgen"):
            while (now := time.perf_counter_ns()) < due:
                time.sleep((due - now) / 1e9)
        late[i] = (now - due) / 1e6
        with run.span("submit"):
            fut = st.bp.submit(frames[st.idx[i]], centers[st.idx[i]])
        fut.add_done_callback(lambda f, i=i: resolved(i, f))
    t_close = t0 + int(run.seconds * 1e9)
    with run.span("wait"):
        finished.wait(max(0.0, (t_close - time.perf_counter_ns()) / 1e9)
                      + GRACE_S)
    run.sync()
    gave_up = time.perf_counter_ns()
    t1 = max(t_close, int(done_ns.max()) if n else t_close)
    due_ns = t0 + (st.due * 1e9).astype(np.int64)
    # one that never came waited longer than any that did: from the
    # first due time until the wait ended
    lat = np.where(ok, done_ns - due_ns, gave_up - t0) / 1e6
    served = int(ok.sum())
    quarter = [float(np.median(q)) if len(q) else None
               for q in np.array_split(lat, 4)]
    return dict(
        t0=t0, t1=t1, attempted=n, failed=n - served,
        e2e={"serve_p95_ms": harness.nearest_rank(lat, 0.95)},
        frames=served,
        dispatches=st.bp.n_dispatches - d0,
        dispatch_frames=st.bp.n_frames - f0,
        notes={"loadgen": {
            "late_ms_p50_p99_max": [float(np.median(late)) if n else 0.0,
                                    harness.nearest_rank(late, 0.99),
                                    float(late.max()) if n else 0.0],
            "latency_p50_ms_by_quarter": quarter,
            "after_close": int((ok & (done_ns > t_close)).sum())}})


def release(run, st):
    st.bp.close()
    del st.bp, st.pred
    if run.cuda:
        torch.cuda.empty_cache()


def check(run, st):
    ok = [i for i, a in enumerate(st.answers) if a is not None]
    if not ok:
        return {"joint_gap_max": float("nan"),
                "joint_gap_rms": float("nan")}
    return predictor.answer_gaps(run, st.pool, st.state, st.idx[ok],
                                 np.stack([st.answers[i] for i in ok]))
