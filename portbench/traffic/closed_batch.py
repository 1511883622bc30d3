"""Closed loop: one caller running offline inference over recorded
sequences, ``Predictor.predict`` on ``batch`` frames a call, the next
call when the last returned.  It bypasses the batcher.

Parameters: ``batch`` (frames a call), ``pool`` (frames rendered from
the seed; a multiple of ``batch``).  The pool is split, in an order drawn
from the seed, into ``pool / batch`` contiguous batches, which the calls
take in turn.  Every answer of the window is compared with the
reference's joints of its frame.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from portbench import predictor


def setup(run):
    p = run.params
    B = p["batch"]
    pred, pool, state = predictor.build(run)
    order = np.random.default_rng([run.seed, 2]).permutation(len(pool))
    batches = [order[i:i + B] for i in range(0, len(pool), B)]
    inputs = [(np.ascontiguousarray(pool.frames[b]), pool.centers[b])
              for b in batches]
    for f, c in inputs + inputs[:1]:
        pred.predict(f, c)
    return SimpleNamespace(pred=pred, pool=pool, state=state,
                           batches=batches, inputs=inputs, served=[])


def window(run, st):
    end = time.perf_counter_ns() + int(run.seconds * 1e9)
    t0 = time.perf_counter_ns()
    k = 0
    while True:
        b = k % len(st.inputs)
        with run.span("predict"):
            out = st.pred.predict(*st.inputs[b])
        st.served.append((b, out))
        k += 1
        if time.perf_counter_ns() >= end:
            break
    t1 = time.perf_counter_ns()
    frames = sum(len(out) for _, out in st.served)
    return dict(t0=t0, t1=t1, attempted=frames, failed=0,
                e2e={"batch_fps": frames / ((t1 - t0) / 1e9)},
                frames=frames, calls=k)


def release(run, st):
    del st.pred, st.inputs
    if run.cuda:
        torch.cuda.empty_cache()


def check(run, st):
    idx = np.concatenate([st.batches[b] for b, _ in st.served])
    answers = np.concatenate([out for _, out in st.served])
    return predictor.answer_gaps(run, st.pool, st.state, idx, answers)
