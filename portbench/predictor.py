"""The serving cells' shared parts: the program's ``Predictor`` built on
the benchmark's weights (or its control), the faults the check must
catch, and the comparison of every served answer with the reference.

Control (``--control``): a float32 cell serves with TF32 on, a bfloat16
cell serves the program's int8 path (``Predictor.quantize``, calibrated
on 64 of the pool's crops).  Faults (``--fault``): ``answer`` gives the
first request of every dispatch the last one's joints (alone in its
dispatch, its joints 40 px further in u); ``half_batch`` gives the
second half of every dispatch's rows the first half's answers.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import frames, harness, weights
from portbench.reference import data, steps

FAULTS = ("answer", "half_batch")
CALIB_FRAMES = 64


def build(run):
    """(Predictor, pool, the weights' state dict) for ``run``."""
    from awr_tpu_torch.serving import Predictor

    pool = frames.Pool(run.cfg, run.params["pool"], run.seed, run.device)
    run.mark("frames")
    state = weights.make(run.cfg, run.seed, pool, run.device)
    run.mark("weights")
    harness.set_tf32(False)
    pred = Predictor(harness.port_config(run), state,
                     paras=tuple(run.cfg["paras"]), flip=run.cfg["flip"],
                     device=run.device)
    if run.control:
        if run.dtype == "float32":
            harness.set_tf32(True)
        else:
            pred.quantize(weights.calib_crops(pool, run.cfg, CALIB_FRAMES,
                                              run.device))
    wrap(run, pred)
    run.mark("program")
    return pred, pool, state


def wrap(run, pred):
    """Put the harness's span "dispatch" around the Predictor's
    ``predict_async`` in traced runs (it names the idle gaps of the
    breakdown), and plant ``run.fault`` in what it returns."""
    if run.fault is not None and run.fault not in FAULTS:
        raise ValueError(f"fault {run.fault!r}: one of {FAULTS}")
    if not run.trace and run.fault is None:
        return
    inner = pred.predict_async

    def predict_async(imgs, centers_xyz, cubes=None):
        with run.span("dispatch"):
            finalize = inner(imgs, centers_xyz, cubes)
        if run.fault is None:
            return finalize

        def faulty():
            out = finalize().copy()
            if run.fault == "answer" and len(out) > 1:
                out[0] = out[-1]
            elif run.fault == "answer":
                out[0, :, 0] += 40.0
            else:
                h = len(out) // 2
                out[len(out) - h:] = out[:h]
            return out
        return faulty

    pred.predict_async = predict_async


def reference(run, pool, state, idx, block: int = 32):
    """Normalized (n, J, 3) joints of pool frames ``idx`` by the plain
    reference in float32 with TF32 off, and their crop affines, in
    blocks of ``block`` frames."""
    harness.set_tf32(False)
    model = weights.reference_model(run.cfg, state, run.device)
    s, k = run.cfg["img_size"], run.cfg["kernel_size"]
    out, Ms = [], []
    for i in range(0, len(idx), block):
        sel = idx[i:i + block]
        imgs = torch.from_numpy(pool.frames[sel]).to(run.device)
        c_uvd = data.xyz2uvd_np(pool.centers[sel], pool.paras, pool.flip)
        crops, M = data.eval_crops(imgs, c_uvd, pool.cubes(len(sel)),
                                   pool.paras, s)
        out.append(steps.infer(model, crops, k).double().cpu().numpy())
        Ms.append(M)
    return np.concatenate(out), np.concatenate(Ms)


def answer_gaps(run, pool, state, idx, answers) -> dict:
    """The widest gap and the RMS gap, in normalized crop units, between
    the served answers (camera u px, v px, d mm; one (J, 3) for each pool
    frame in ``idx``) and the reference's joints of those frames."""
    idx = np.asarray(idx)
    uniq, inv = np.unique(idx, return_inverse=True)
    ref, M = reference(run, pool, state, uniq)
    c_uvd = data.xyz2uvd_np(pool.centers[idx], pool.paras, pool.flip)
    got = data.to_normalized(np.asarray(answers), M[inv], c_uvd,
                             pool.cubes(len(idx)), run.cfg["img_size"])
    d = got - ref[inv]
    return {"joint_gap_max": float(np.abs(d).max()),
            "joint_gap_rms": float(np.sqrt(np.mean(d * d)))}


def warm(pred, submit, pool, max_batch: int, times: int = 2):
    """Run every padded batch size that groups of 1 to ``max_batch``
    frames take (``Predictor._bucket``) ``times`` through ``submit(frames,
    centers)``, which waits for its answers."""
    for b in sorted({pred._bucket(n) for n in range(1, max_batch + 1)}):
        n = min(b, max_batch)
        for _ in range(times):
            submit(pool.frames[:n], pool.centers[:n])
