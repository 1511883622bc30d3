#!/usr/bin/env python3
"""Drive the PyTorch port's train, eval and serving paths on one NVIDIA
GPU and check them.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``awr_tpu_torch/csrc`` (one
``nvcc`` per source, all at once) and holds each against its plain
PyTorch version on the card (the decode's softmax statistics too, the
decode backward from the statistics the forward saved; the int8 GEMM
also against ``torch._int_mm``).  Then, with ``hourglass_1`` at full
width (img 128, 256 channels, 14 joints; seeded random weights),
float32, TF32 off:

- train: K raw-mode Adam steps (device crop, augmentation drawn by a
  seeded ``torch.Generator`` on the card, encode, forward, decode, loss,
  backward, update) on 32 synthetic frames, between two un-augmented
  eval steps on the same batch, whose loss must fall;
- cross-device: one raw train step on the card and on the CPU from the
  same weights and augmentation;
- eval: one raw eval step;
- serve: requests through ``awr_tpu_torch.serving.Predictor``, held
  against the same Predictor on the CPU;
- serve_resnet: ``resnet_18`` (img 128, ds 2, kernel 1.0; seeded random
  weights) fp32 requests held against the CPU, ``Predictor.quantize`` on
  32 normalized crops, int8 requests through the int8 GEMM and deconv
  kernels, held against an int8 Predictor on the CPU given the card's
  scales and against the fp32 joints;
- time: CUDA-event times of the train step, the inference steps and each
  kernel beside its plain version, its bound and its library call (the
  decode at B = 8, 32 and 256); then ``torch.profiler`` breakdowns
  of the train step and of the int8 forward by kernel;
- trainer: the training CLI (``awr_tpu_torch.training.train.main``,
  hourglass_1, raw mode, B = 32, 256 synthetic train and 64 test frames)
  for 2 epochs with exact kernel launch counts, its checkpoints, a
  resume to epoch 3, the evaluation CLI on the epoch-3 checkpoint
  against the Trainer's own test MPE, ``Predictor.from_checkpoint``
  against the Trainer's eval joints, then epochs 4-6: the Trainer's
  train frames/s over warm epoch 5 beside the bare step's, and the
  card's idle share over epoch 6 (``torch.profiler``);
- train_resnet: raw resnet_18 train steps at B = 32 with exact launch
  counts, one step on the card against the CPU, the same step with
  ``remat`` against it without, and train frames/s.

Each path runs with every launch counter set to 0 just before it and is
checked to have gone through its kernels.  Each phase prints one JSON
line; then come the kernel summary line, the card's name and power
limit, and the status line.  Any failure raises and exits non-zero.
Without a GPU it exits 1 and prints no result.  Imports torch, numpy and
the port only.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from awr_tpu_torch import kernels
from awr_tpu_torch.config import hourglass_config, resnet_config
from awr_tpu_torch.data.device import (crop_normalize_batch,
                                       crop_param_tensors,
                                       draw_augment_params)
from awr_tpu_torch.data.synthetic import synthetic_frames
from awr_tpu_torch.geometry import xyz2uvd_np
from awr_tpu_torch.models import build_model
from awr_tpu_torch.models.common import torch_default_init_
from awr_tpu_torch.models.quant import QuantConv, quant_layers
from awr_tpu_torch.ops import decode_cuda, encode_cuda, int8, int8_cuda
from awr_tpu_torch.ops.functional import (joint2offset, offset2joint_softmax,
                                          offset2joint_softmax_backward,
                                          offset2joint_softmax_stats)
from awr_tpu_torch.serving import Predictor
from awr_tpu_torch.training import evaluate as evaluate_cli
from awr_tpu_torch.training import train as train_cli
from awr_tpu_torch.training.optim import make_optimizer
from awr_tpu_torch.training.steps import (make_raw_eval_step,
                                          make_raw_train_step)
from awr_tpu_torch.training.trainer import Trainer

SEED = 0
KERNEL_SIZE = 0.4
# Each hand-written kernel on the paths: its wrapper module and launch
# counter, its source, the TPU kernel (or XLA function) it replaces, and
# the main path whose launches the summary reports (the Trainer's, for
# the AWR kernels; the int8 requests', for the int8 ones).
KERNELS = [
    dict(name="decode", route="cuda", module=decode_cuda, counter="LAUNCHES",
         source="awr_tpu_torch/csrc/decode.cu",
         replaces="awr_tpu/ops/pallas_decode.py:69", path="trainer"),
    dict(name="encode", route="cuda", module=encode_cuda, counter="LAUNCHES",
         source="awr_tpu_torch/csrc/encode.cu",
         replaces="awr_tpu/ops/pallas_encode.py:40", path="trainer"),
    dict(name="decode_backward", route="cuda", module=decode_cuda,
         counter="BACKWARD_LAUNCHES", source="awr_tpu_torch/csrc/decode.cu",
         replaces="awr_tpu/ops/decode.py:37", path="trainer"),
    dict(name="int8_gemm", route="cuda", module=int8_cuda,
         counter="GEMM_LAUNCHES", source="awr_tpu_torch/csrc/int8.cu",
         replaces="awr_tpu/ops/pallas_int8.py:190", path="serve_resnet_int8"),
    dict(name="deconv_int8", route="cuda", module=int8_cuda,
         counter="DECONV_LAUNCHES", source="awr_tpu_torch/csrc/int8.cu",
         replaces="awr_tpu/ops/pallas_int8.py:89", path="serve_resnet_int8"),
]
SOURCES = sorted({k["source"].split("/")[-1][:-3] for k in KERNELS})
# float32 sums over F*F = 4096 pixels taken in another order than the
# plain version's
DECODE_ATOL = 2e-5
# the encode spells each operation as the plain version does, in IEEE
# float32 without contraction
ENCODE_ATOL = 1e-5
# relative to max |grad|: dL/dht is a difference of two softmax-weighted
# sums over F*F pixels, each taken in another order than the plain
# version's (expf against torch's exp, too); one float32 rounding of that
# difference is ~1e-7 of max |grad|.  bfloat16: one bfloat16 rounding.
BACKWARD_RTOL_OF_MAX = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
# cuDNN against the CPU's conv algorithms, TF32 off, through a 4-level
# hourglass
CPU_ATOL = 1e-3
# int8 resnet_18 on the card against the CPU, the same int8 weights and
# scales: the float layers (BatchNorm, adds) round differently on the two
# devices, which can flip an activation code by one step, and each flip
# moves the next layers' inputs; the bar of tests/test_torch_quant.py
# (the CPU port against the JAX package: 2.5e-4 to 3.9e-4)
INT8_CPU_ATOL = 1e-3
# int8 against fp32 joints, the JAX package's own bar
# (tests/test_serving.py:183)
INT8_DRIFT_MAX = 0.05
SERVE_BATCHES = (1, 8, 32)
# train step on the card against the CPU: cuDNN's backward algorithms sum
# in other orders in float32
CROSS_LOSS_RTOL = 1e-4
CROSS_BN_ATOL = 1e-4
CROSS_GRAD_COS = 0.999
TRAIN_STEPS = 20
TRAIN_BATCH = 32
CROSS_BATCH = 4
# the trainer phase's synthetic train and test sets: 8 and 2 steps an
# epoch at B = 32
TRAINER_FRAMES = 256
TRAINER_TEST_FRAMES = 64
# the Trainer's eval MPE of a checkpoint against the evaluation CLI's on
# it: the same frames through the same model in one process
EVAL_MPE_ATOL = 1e-4
RESNET_STEPS = 10
# the remat step's gradients and running statistics against the step
# without it, relative to each tensor's max |value|: the same kernels on
# the same inputs, except that some cuDNN kernels sum in another order
# from one launch to the next (on the H100 the statistics inside
# resnet_18's rematerialized blocks came out bit-equal, those of its last
# deconv, which remat leaves alone, did not).  A second BatchNorm update
# would move the statistics by 90 % of the first; the batch counters
# must be equal
REMAT_RTOL_OF_MAX = 1e-4
# (HBM bytes/s, float32 non-tensor FLOP/s, dense int8 tensor OP/s) from
# NVIDIA's data sheets; dense int8 is half the with-sparsity figure
PEAKS = {"PCIe": (2.0e12, 51e12, 1513e12), "NVL": (3.9e12, 60e12, 1671e12),
         "H100": (3.35e12, 67e12, 1979e12)}
# float operations for each (sample, joint, pixel): decode (mask, logit,
# max, exp, sum, distance, weight, three offset and three coordinate
# products and sums); encode (three differences, squares and sums, sqrt,
# heatmap, mask, three divides and four masked stores); decode backward
# (mask, logit, the weight from the saved max and sum, distance, masked
# offsets, g.v, g.t and four gradient values)
OPS = {"decode": 25, "encode": 20, "decode_backward": 30}
# the decode's softmax sum against the plain version's: float32 over F*F
# pixels in another order (the max is bit-equal)
STATS_SUM_RTOL = 1e-6


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def peaks(name: str):
    for key, val in PEAKS.items():
        if key in name:
            return val
    raise RuntimeError(f"no peak rates known for {name!r}")


def decode_inputs(B, F=64, J=14, H=128, seed=SEED):
    """A seeded (B, 4J, F, F) map and (B, H, H) depth with a foreground
    region; frame 0 is all background."""
    rng = np.random.RandomState(seed)
    img = np.ones((B, H, H), np.float32)
    img[:, H // 4:, H // 8:7 * H // 8] = rng.uniform(
        -1, 0.9, (B, 3 * H // 4, 3 * H // 4))
    img[0] = 1.0
    off = rng.randn(B, 4 * J, F, F).astype(np.float32) * 0.3
    return (torch.from_numpy(off).cuda(), torch.from_numpy(img).cuda())


def device_ms(fn, arg_sets, reps):
    """Mean device time of ``fn`` over ``reps`` calls, cycling through
    ``arg_sets`` (distinct copies, so the inputs come from HBM rather
    than L2).  A sleep kernel first backs up the stream, so the calls run
    back to back and host launch time is not counted."""
    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for i in range(reps):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps):
    """Median wall time of ``fn()`` (which ends in a device sync)."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def phase_env():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "tf32": False})
    return smi


def counts():
    return {k["name"]: getattr(k["module"], k["counter"]) for k in KERNELS}


def reset_counts() -> None:
    for k in KERNELS:
        setattr(k["module"], k["counter"], 0)


def check_launches(path: str, got: dict, want: dict) -> None:
    """``want`` names the kernels the path launches; every other kernel
    must not have launched."""
    want = {k["name"]: want.get(k["name"], 0) for k in KERNELS}
    if got != want:
        raise AssertionError(f"{path}: kernel launches {got}, expected "
                             f"{want}")


def phase_build():
    t0 = time.perf_counter()
    report = kernels.build(SOURCES)
    # the int8 tensor-core kernels' dynamic shared memory, from the
    # library (the GEMM's by tile width; 0: the deconv's)
    smem = {bn: int8_cuda.library_smem(bn) for bn in (0, 64, 128)}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": {n: {"seconds": r["seconds"],
                          "ptxas": [ln.strip() for ln in r["ptxas"].splitlines()
                                    if "entry function" in ln
                                    or "registers" in ln or "spill" in ln]}
                      for n, r in report.items()},
          "int8_tc_dynamic_smem": smem})
    if smem != {bn: int8_cuda.tc_smem(bn) for bn in smem}:
        raise AssertionError("int8 shared memory: the library and the "
                             "host's plan disagree")


def encode_inputs(B, F=64, J=14, H=128, seed=SEED):
    """:func:`decode_inputs`' depth and seeded (B, J, 3) joints."""
    _, img = decode_inputs(B, F, J, H, seed)
    rng = np.random.RandomState(seed + 1)
    jt = rng.uniform(-0.8, 0.8, (B, J, 3)).astype(np.float32)
    return torch.from_numpy(jt).cuda(), img


def phase_kernels():
    """Each kernel against its plain version at the train and serving
    shape (B = 32, F = 64, J = 14), synchronized after the launch."""
    off, img = decode_inputs(32)
    errs = {}
    dec, stat = {}, {}
    saved = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = off.to(dtype)
        got, stats = decode_cuda.offset2joint_softmax_cuda(x, img,
                                                           KERNEL_SIZE)
        torch.cuda.synchronize()
        saved[dtype] = got, stats
        name = str(dtype).split(".")[1]
        want = offset2joint_softmax(x.float(), img, KERNEL_SIZE)
        dec[name] = float((got - want).abs().max())
        if not torch.isfinite(got).all():
            raise AssertionError("decode kernel gave non-finite joints")
        plain = offset2joint_softmax_stats(x, img)
        stat[name] = {
            "max_equal": bool(torch.equal(stats[..., 0], plain[..., 0])),
            "sum_max_rel_err": float(((stats[..., 1] - plain[..., 1]).abs()
                                      / plain[..., 1]).max())}
    errs["decode"] = dec["float32"]
    emit({"phase": "kernels", "kernel": "decode", "shape": list(off.shape),
          "max_abs_err": dec, "atol": DECODE_ATOL, "stats": stat,
          "stats_sum_rtol": STATS_SUM_RTOL})
    if max(dec.values()) > DECODE_ATOL:
        raise AssertionError(f"decode kernel disagrees: {dec}")
    if not all(v["max_equal"] and v["sum_max_rel_err"] <= STATS_SUM_RTOL
               for v in stat.values()):
        raise AssertionError(f"decode statistics disagree: {stat}")

    jt, img = encode_inputs(32)
    got = encode_cuda.joint2offset_cuda(jt, img, KERNEL_SIZE, 64)
    torch.cuda.synchronize()
    want = joint2offset(jt, img, KERNEL_SIZE, 64)
    errs["encode"] = float((got - want).abs().max())
    emit({"phase": "kernels", "kernel": "encode", "shape": list(got.shape),
          "max_abs_err": errs["encode"], "atol": ENCODE_ATOL,
          "nonzero_share": float((want != 0).float().mean()),
          "pixels_differing": int((got != want).sum())})
    if not errs["encode"] <= ENCODE_ATOL:
        raise AssertionError(f"encode kernel disagrees: {errs['encode']}")

    g = torch.randn(32, 14, 3, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(SEED))
    bwd = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = off.to(dtype)
        # from the forward's saved output and statistics
        out, stats = saved[dtype]
        got = decode_cuda.offset2joint_softmax_backward_cuda(
            x, img, out, stats, g, KERNEL_SIZE)
        torch.cuda.synchronize()
        want = offset2joint_softmax_backward(x, img, KERNEL_SIZE, g).float()
        name = str(dtype).split(".")[1]
        scale = float(want.abs().max())
        bwd[name] = {"max_abs_err": float((got.float() - want).abs().max()),
                     "max_abs_grad": scale,
                     "atol": BACKWARD_RTOL_OF_MAX[name] * scale}
        if not bwd[name]["max_abs_err"] <= bwd[name]["atol"]:
            raise AssertionError(f"decode backward disagrees: {bwd}")
        if got[0].any():
            raise AssertionError("decode backward: background frame not 0")
    errs["decode_backward"] = bwd["float32"]["max_abs_err"]
    emit({"phase": "kernels", "kernel": "decode_backward",
          "shape": list(off.shape), "errors": bwd})

    # int8: exact integer results, so the bar is equality
    for M, K, N in GEMM_CHECKS:
        a, b = int8_codes((M, K), M), int8_codes((K, N), K)
        got = int8_cuda.int8_matmul_cuda(a, b)
        again = int8_cuda.int8_matmul_cuda(a, b)
        torch.cuda.synchronize()
        plain = torch.equal(got, int8.int8_matmul(a, b))
        # torch._int_mm takes K and N in multiples of 8
        lib = torch.equal(got, torch._int_mm(a, b)) if K % 8 == 0 else None
        emit({"phase": "kernels", "kernel": "int8_gemm", "shape": [M, K, N],
              "plan": int8_cuda.gemm_plan(M, K, N)._asdict(),
              "equal_plain": plain, "equal_int_mm": lib,
              "equal_second_run": torch.equal(got, again)})
        if not plain or lib is False or not torch.equal(got, again):
            raise AssertionError(f"int8 GEMM disagrees at {(M, K, N)}")
    errs["int8_gemm"] = 0.0
    for B, H, c_in, c_out in DECONV_CHECKS:
        xq, wq, scale = deconv_args(B, H, c_in, c_out)
        got = int8_cuda.deconv4x4s2_int8_cuda(xq, wq, scale)
        torch.cuda.synchronize()
        want = int8.deconv4x4s2_int8(xq, wq, scale)
        equal = torch.equal(got, want)
        emit({"phase": "kernels", "kernel": "deconv_int8",
              "shape": [B, H, H, c_in, c_out],
              "plan": int8_cuda.deconv_plan(B, H, H, c_in, c_out)._asdict(),
              "equal_plain": equal,
              "max_abs_err": float((got - want).abs().max())})
        if not equal:
            raise AssertionError(f"int8 deconv disagrees at {(B, H, c_in)}")
    errs["deconv_int8"] = 0.0
    return errs


# (M, K, N) of resnet_18's int8 GEMMs at B = 32, img 128: a deconv
# phase's shape (for the int8 probe's comparison), layer1's 3x3 conv, the
# 5x5 stem (K = 25: byte loads; torch._int_mm refuses it), layer4's and
# layer3's 3x3 convs, and layer4's at bucket 8 (split K)
GEMM_CHECKS = [(32768, 1024, 256), (131072, 576, 64), (524288, 25, 64),
               (2048, 4608, 512), (512, 4608, 512), (8192, 2304, 256)]
# (B, H, C_in, C_out) of resnet_18's three decoder deconvs at B = 32, and
# deconv0 at bucket 8
DECONV_CHECKS = [(32, 8, 512, 256), (32, 16, 256, 256), (32, 32, 256, 256),
                 (8, 8, 512, 256)]


def int8_codes(shape, seed):
    g = torch.Generator("cuda").manual_seed(seed)
    return torch.randint(-127, 128, shape, generator=g, device="cuda",
                         dtype=torch.int8)


def deconv_args(B, H, c_in, c_out, seed=SEED):
    """Seeded int8 NHWC codes, an int8 (C_in, C_out, 4, 4) weight and
    scales in [0.5, 2]."""
    scale = torch.empty(c_out, device="cuda").uniform_(
        0.5, 2.0, generator=torch.Generator("cuda").manual_seed(seed))
    return (int8_codes((B, H, H, c_in), seed + 1),
            int8_codes((c_in, c_out, 4, 4), seed + 2), scale)


def raw_inputs(cfg, frames, joints, centers, device):
    """The raw-mode step's inputs on ``device``: frames, absolute joints,
    centers in uvd and cubes, and the crop parameters."""
    B = len(frames)
    centers_uvd = xyz2uvd_np(centers, cfg.paras, cfg.flip).astype(np.float64)
    cubes = np.tile(np.asarray(cfg.cube, np.float64), (B, 1))
    f32 = lambda a: torch.from_numpy(  # noqa: E731
        np.asarray(a, np.float32)).to(device)
    raw = dict(img=f32(frames), jt_xyz=f32(joints),
               centers_uvd=f32(centers_uvd), cubes=f32(cubes))
    return raw, crop_param_tensors(centers_uvd, cubes, cfg.paras,
                                   cfg.img_size, device)


def new_model(cfg, device):
    model = build_model(cfg.net, cfg.jt_num)
    torch_default_init_(model, torch.Generator().manual_seed(SEED))
    return model.to(device)


def phase_train(cfg, frames, joints, centers):
    """K raw train steps at B = 32 between two eval steps on the batch."""
    model = new_model(cfg, "cuda")
    opt = make_optimizer(model.parameters(), cfg.optimizer, cfg.lr)
    train = make_raw_train_step(model, opt, cfg, cfg.paras, cfg.flip)
    evaluate = make_raw_eval_step(model, cfg, cfg.paras, cfg.flip)
    raw, p = raw_inputs(cfg, frames, joints, centers, "cuda")
    gen = torch.Generator("cuda").manual_seed(SEED)
    B = len(frames)

    reset_counts()
    before = evaluate(raw, p)
    metrics = [train(raw, p, draw_augment_params(gen, B, *cfg.augment_para))
               for _ in range(TRAIN_STEPS)]
    after = evaluate(raw, p)
    torch.cuda.synchronize()
    launches = counts()

    losses = [float(m["loss"]) for m in metrics]
    eval_loss = (float(before["loss"]), float(after["loss"]))
    emit({"phase": "train", "net": cfg.net, "batch": B, "steps": TRAIN_STEPS,
          "optimizer": cfg.optimizer, "lr": cfg.lr,
          "coord_weight": cfg.coord_weight, "launches": launches,
          "loss_first": losses[0], "loss_last": losses[-1],
          "loss_coord_last": float(metrics[-1]["loss_coord"]),
          "eval_loss_before": eval_loss[0], "eval_loss_after": eval_loss[1]})
    check_launches("train", launches, {
        "decode": TRAIN_STEPS + 2, "encode": TRAIN_STEPS + 2,
        "decode_backward": TRAIN_STEPS})
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite train loss: {losses}")
    if not eval_loss[1] < eval_loss[0]:
        raise AssertionError(f"eval loss did not fall: {eval_loss}")
    return model, opt, train, raw, p, launches


def zero_grad_biases(model) -> set:
    """Conv biases whose gradient is 0 in exact arithmetic: every conv
    output but the two prediction heads' (the hourglass's ``outs_*``,
    the ResNet's ``final*``) reaches the loss only through train-mode
    BatchNorms (skips, pooling and upsampling carry a channel constant
    on; each BatchNorm subtracts it), so what is left of their gradient
    is roundoff, whose direction means nothing."""
    return {f"{n}.bias" for n, m in model.named_modules()
            if isinstance(m, torch.nn.Conv2d) and m.bias is not None
            and not n.startswith(("outs_1.", "outs_2.", "final"))}


def phase_cross_device(cfg, frames, joints, centers, phase="cross_device"):
    """One raw train step at B = 4 on the card and on the CPU, from the
    same weights and the same augmentation."""
    sd = new_model(cfg, "cpu").state_dict()
    B = CROSS_BATCH
    aug = draw_augment_params(torch.Generator().manual_seed(SEED + 1), B,
                              *cfg.augment_para)
    out = {}
    for dev in ("cuda", "cpu"):
        model = build_model(cfg.net, cfg.jt_num)
        model.load_state_dict(sd)
        model.to(dev)
        step = make_raw_train_step(
            model, make_optimizer(model.parameters(), cfg.optimizer, cfg.lr),
            cfg, cfg.paras, cfg.flip)
        raw, p = raw_inputs(cfg, frames[:B], joints[:B], centers[:B], dev)
        m = step(raw, p, tuple(a.to(dev) for a in aug))
        out[dev] = dict(
            loss=float(m["loss"]),
            grads={n: q.grad.detach().double().cpu()
                   for n, q in model.named_parameters()},
            stats={n: b.detach().double().cpu()
                   for n, b in model.named_buffers() if "running" in n})
    gpu, cpu = out["cuda"], out["cpu"]
    loss_rel = abs(gpu["loss"] - cpu["loss"]) / abs(cpu["loss"])
    bn_err = max(float((gpu["stats"][n] - cpu["stats"][n]).abs().max())
                 for n in cpu["stats"])
    zero = zero_grad_biases(model)
    cosines = {n: float((gpu["grads"][n] * g).sum()
                        / (gpu["grads"][n].norm() * g.norm()))
               for n, g in cpu["grads"].items() if n not in zero}
    worst = sorted(cosines, key=cosines.get)[:5]
    emit({"phase": phase, "net": cfg.net, "batch": B,
          "loss_cuda": gpu["loss"],
          "loss_cpu": cpu["loss"], "loss_rel_err": loss_rel,
          "bn_stats_max_abs_err": bn_err,
          "grad_cos_lowest": {n: cosines[n] for n in worst},
          "params_compared": len(cosines),
          "zero_grad_biases_skipped": len(zero),
          "zero_grad_bias_grad_max": max(
              (float(cpu["grads"][n].abs().max()) for n in zero),
              default=None),
          "tolerances": {"loss_rtol": CROSS_LOSS_RTOL,
                         "bn_atol": CROSS_BN_ATOL,
                         "grad_cos": CROSS_GRAD_COS}})
    if not (loss_rel <= CROSS_LOSS_RTOL and bn_err <= CROSS_BN_ATOL
            and cosines[worst[0]] >= CROSS_GRAD_COS):
        raise AssertionError("the train step on the card disagrees with "
                             "the CPU")


def phase_eval(cfg, model, raw, p):
    evaluate = make_raw_eval_step(model, cfg, cfg.paras, cfg.flip)
    reset_counts()
    m = evaluate(raw, p)
    torch.cuda.synchronize()
    launches = counts()
    emit({"phase": "eval", "batch": raw["img"].shape[0], "launches": launches,
          "loss": float(m["loss"]),
          "jt_uvd_pred_finite": bool(torch.isfinite(m["jt_uvd_pred"]).all())})
    check_launches("eval", launches,
                   {"decode": 1, "encode": 1, "decode_backward": 0})
    if not torch.isfinite(m["jt_uvd_pred"]).all():
        raise AssertionError("eval: non-finite joints")
    return launches


def randomize_batch_norm_(model, seed=SEED):
    """Seeded BatchNorm affine params and running stats, so eval-mode BN
    is not the identity and the maps are not degenerate."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.weight.copy_(torch.from_numpy(1 + 0.2 * rng.randn(n)))
                m.bias.copy_(torch.from_numpy(0.1 * rng.randn(n)))
                m.running_mean.copy_(torch.from_numpy(0.1 * rng.randn(n)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, n)))
    return model


def phase_serve(cfg, frames, centers):
    model = build_model(cfg.net, cfg.jt_num)
    torch_default_init_(model, torch.Generator().manual_seed(SEED))
    pred = Predictor(cfg, randomize_batch_norm_(model), device="cuda")

    reset_counts()
    outs = {B: pred.predict(frames[:B], centers[:B]) for B in (1, 8, 32)}
    launches = counts()
    for B, out in outs.items():
        if out.shape != (B, cfg.jt_num, 3) or not np.isfinite(out).all():
            raise AssertionError(f"batch {B}: bad output {out.shape}")
    # inference mode: one decode launch a request, no backward, no encode
    check_launches("serve", launches, {"decode": len(outs)})

    # the same Predictor's weights on the CPU, on a batch of 2
    cpu = Predictor(cfg, pred.model.state_dict(), device="cpu")
    crop_err, norm_err, cam_err = compare_with_cpu(pred, cpu, frames,
                                                   centers)
    emit({"phase": "serve", "net": cfg.net, "img_size": cfg.img_size,
          "requests": sorted(outs), "launches": launches,
          "crop_max_abs_err": crop_err, "normalized_max_abs_err": norm_err,
          "camera_max_abs_err_px_mm": cam_err, "atol": CPU_ATOL,
          "joint_spread_px": float(outs[32][..., :2].std(axis=1).mean())})
    if crop_err > 1e-6 or norm_err > CPU_ATOL:
        raise AssertionError("GPU serving disagrees with the CPU")
    return pred, launches


def compare_with_cpu(pred, cpu, frames, centers):
    """Max abs differences, card against CPU, over two frames: of the
    crops, of ``predict_normalized`` on the CPU's crops, and of
    ``predict``."""
    cfg = pred.cfg
    centers_uvd = xyz2uvd_np(centers[:2], cfg.paras, cfg.flip)
    cubes = np.tile(cfg.cube, (2, 1))
    crops = {dev: crop_normalize_batch(
        torch.from_numpy(frames[:2]).to(dev), centers_uvd, cubes,
        cfg.paras, cfg.img_size)[0].cpu() for dev in ("cuda", "cpu")}
    crop_err = float((crops["cuda"] - crops["cpu"]).abs().max())
    norm = {name: p.predict_normalized(crops["cpu"].numpy())
            for name, p in (("cuda", pred), ("cpu", cpu))}
    norm_err = float(np.abs(norm["cuda"] - norm["cpu"]).max())
    cam_err = float(np.abs(pred.predict(frames[:2], centers[:2])
                           - cpu.predict(frames[:2], centers[:2])).max())
    return crop_err, norm_err, cam_err


def normalized_crops(cfg, frames, centers):
    """The frames' normalized (B, S, S) crops, made on the card."""
    img, _ = crop_normalize_batch(
        torch.from_numpy(frames).cuda(),
        xyz2uvd_np(centers, cfg.paras, cfg.flip),
        np.tile(cfg.cube, (len(frames), 1)), cfg.paras, cfg.img_size)
    return img.cpu().numpy()


def phase_serve_resnet(frames, centers):
    """resnet_18 fp32 requests, calibration, int8 requests; the int8
    Predictor against one on the CPU with the card's scales, and against
    the fp32 joints."""
    cfg = resnet_config()
    model = build_model(cfg.net, cfg.jt_num, cfg.downsample)
    torch_default_init_(model, torch.Generator().manual_seed(SEED))
    sd = randomize_batch_norm_(model).state_dict()
    pred, pred_q = (Predictor(cfg, sd, device="cuda") for _ in range(2))
    launches = {}

    reset_counts()
    outs = {B: pred.predict(frames[:B], centers[:B]) for B in SERVE_BATCHES}
    launches["serve_resnet_fp32"] = counts()
    for B, out in outs.items():
        if out.shape != (B, cfg.jt_num, 3) or not np.isfinite(out).all():
            raise AssertionError(f"resnet batch {B}: bad output {out.shape}")
    check_launches("serve_resnet_fp32", launches["serve_resnet_fp32"],
                   {"decode": len(outs)})
    cpu = Predictor(cfg, sd, device="cpu")
    crop_err, norm_err, cam_err = compare_with_cpu(pred, cpu, frames, centers)
    if crop_err > 1e-6 or norm_err > CPU_ATOL:
        raise AssertionError("fp32 resnet serving on the card disagrees "
                             "with the CPU")

    crops = normalized_crops(cfg, frames, centers)
    reset_counts()
    t0 = time.perf_counter()
    pred_q.quantize(crops)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    check_launches("calibrate", counts(), {})

    reset_counts()
    outs8 = {B: pred_q.predict(frames[:B], centers[:B])
             for B in SERVE_BATCHES}
    launches["serve_resnet_int8"] = counts()
    for B, out in outs8.items():
        if out.shape != (B, cfg.jt_num, 3) or not np.isfinite(out).all():
            raise AssertionError(f"int8 batch {B}: bad output {out.shape}")
    # per request: the 20 quantized convs, the 3 deconvs, one decode
    n = len(outs8)
    check_launches("serve_resnet_int8", launches["serve_resnet_int8"],
                   {"int8_gemm": 20 * n, "deconv_int8": 3 * n, "decode": n})

    cpu.quant = {k: v.cpu() for k, v in pred_q.quant.items()}
    cpu._switch_int8()
    _, norm8_err, cam8_err = compare_with_cpu(pred_q, cpu, frames, centers)
    fp, q8 = (p.predict_normalized(crops) for p in (pred, pred_q))
    drift = float(np.abs(q8 - fp).max())
    scales = [float(v) for v in pred_q.quant.values()]
    emit({"phase": "serve_resnet", "net": cfg.net, "img_size": cfg.img_size,
          "downsample": cfg.downsample, "kernel_size": cfg.kernel_size,
          "requests": sorted(outs), "launches": launches,
          "fp32": {"crop_max_abs_err": crop_err,
                   "normalized_max_abs_err": norm_err,
                   "camera_max_abs_err_px_mm": cam_err, "atol": CPU_ATOL},
          "calibration": {"frames": len(crops), "seconds": calib_s,
                          "layers": len(scales), "scale_min": min(scales),
                          "scale_max": max(scales)},
          "int8": {"normalized_max_abs_err_vs_cpu": norm8_err,
                   "camera_max_abs_err_px_mm_vs_cpu": cam8_err,
                   "atol": INT8_CPU_ATOL,
                   "drift_vs_fp32_max": drift,
                   "drift_vs_fp32_mean": float(np.abs(q8 - fp).mean()),
                   "drift_bar": INT8_DRIFT_MAX},
          "joint_spread_px": float(outs[32][..., :2].std(axis=1).mean())})
    if norm8_err > INT8_CPU_ATOL:
        raise AssertionError("int8 serving on the card disagrees with the "
                             "CPU")
    if not drift < INT8_DRIFT_MAX:
        raise AssertionError(f"int8 joints drift {drift} from fp32")
    return pred, pred_q, crops, launches


def kernel_times(fn, plain, make_args, nbytes, ops, bw, flops):
    """The kernel's and its plain version's device ms on L2-cold copies
    of the inputs, and the bound for the same work."""
    copies = max(2, -(-200_000_000 // nbytes))
    sets = [make_args() for _ in range(copies)]
    t_bytes, t_ops = nbytes / bw, ops / flops
    return {"ms": device_ms(fn, sets, 50), "plain_ms": device_ms(plain, sets, 20),
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops}


def phase_time(cfg, pred, frames, centers, bw, flops, train, raw, p):
    out = {"phase": "time"}
    for B in (1, 32, 256):
        f = np.resize(frames, (B,) + frames.shape[1:])
        c = np.resize(centers, (B, 3))
        ms = host_ms(lambda: pred.predict(f, c), {1: 20, 32: 10, 256: 5}[B])
        out[f"predict_ms_b{B}"] = ms
        out[f"predict_fps_b{B}"] = B / ms * 1e3
    # device time of forward + decode on normalized crops
    for B in (8, 32, 256):
        img = torch.rand(B, cfg.img_size, cfg.img_size, device="cuda") * 2 - 1
        out[f"infer_ms_b{B}"] = device_ms(pred._infer, [(img,)], 10)
    # device time of the raw train step at B = 32, one fixed augmentation
    B = raw["img"].shape[0]
    aug = draw_augment_params(torch.Generator("cuda").manual_seed(SEED + 2),
                              B, *cfg.augment_para)
    out[f"train_step_ms_b{B}"] = device_ms(train, [(raw, p, aug)], 10)
    out[f"train_fps_b{B}"] = B / out[f"train_step_ms_b{B}"] * 1e3

    res = {}
    F, J = cfg.feature_size, cfg.jt_num
    for B in (8, 32, 256):
        def dec_args():
            off, img = decode_inputs(B)
            return off, img, KERNEL_SIZE
        # the map and the resized depth read, the joints and (max, sum)
        # written
        res[("decode", B)] = kernel_times(
            decode_cuda.offset2joint_softmax_cuda, offset2joint_softmax,
            dec_args, B * 4 * J * F * F * 4 + B * F * F * 4 + B * J * 3 * 4
            + B * J * 2 * 4, B * J * F * F * OPS["decode"], bw, flops)
    B = 32

    def enc_args():
        jt, img = encode_inputs(B)
        return jt, img, KERNEL_SIZE, F
    res[("encode", B)] = kernel_times(
        encode_cuda.joint2offset_cuda, joint2offset, enc_args,
        B * J * 3 * 4 + B * F * F * 4 + B * 4 * J * F * F * 4,
        B * J * F * F * OPS["encode"], bw, flops)

    def bwd_args():
        off, img = decode_inputs(B)
        out, stats = decode_cuda.offset2joint_softmax_cuda(off, img,
                                                           KERNEL_SIZE)
        g = torch.randn_like(out)
        return off, img, out, stats, g, KERNEL_SIZE

    def bwd_plain(off, img, out, stats, g, k):
        return offset2joint_softmax_backward(off, img, k, g, stats)
    # the map, the resized depth, out, (max, sum) and the cotangent read,
    # the gradient written
    res[("decode_backward", B)] = kernel_times(
        decode_cuda.offset2joint_softmax_backward_cuda, bwd_plain, bwd_args,
        2 * B * 4 * J * F * F * 4 + B * F * F * 4 + 2 * B * J * 3 * 4
        + B * J * 2 * 4, B * J * F * F * OPS["decode_backward"], bw, flops)
    for (name, b), r in res.items():
        out[f"{name}_b{b}"] = r
    kernel_ms = sum(res[(k, 32)]["ms"] for k in ("decode", "encode",
                                                   "decode_backward"))
    out["kernels_share_of_train_step"] = kernel_ms / out["train_step_ms_b32"]
    out["library_ms"] = None
    out["library_note"] = ("no single PyTorch call computes the decode, "
                           "the encode or the decode backward")
    emit(out)
    return ({name: r for (name, b), r in res.items() if b == 32},
            out["train_fps_b32"])


def gemm_shapes(pred_q, img):
    """(M, K, N) of every int8 GEMM of one forward of ``img``, in order."""
    shapes = []

    def record(m, args):
        B, _, H, W = args[0].shape
        (kh, kw), (sh, sw), (ph, pw) = m.kernel_size, m.stride, m.padding
        M = B * ((H + 2 * ph - kh) // sh + 1) * ((W + 2 * pw - kw) // sw + 1)
        shapes.append((M, m.in_channels * kh * kw, m.out_channels))

    hooks = [m.register_forward_pre_hook(record)
             for m in quant_layers(pred_q.model).values()
             if isinstance(m, QuantConv)]
    try:
        pred_q._infer(img)
    finally:
        for h in hooks:
            h.remove()
    return shapes


def phase_time_resnet(pred, pred_q, crops, frames, centers, bw, int8_ops):
    """resnet_18 request and forward times, fp32 and int8; the int8
    kernels' times beside their plain versions, bounds and library
    calls: the GEMM at the shapes of an int8 request at B = 32 and 8,
    the deconv at the request's three shapes at B = 32."""
    out = {"phase": "time_resnet", "net": pred.cfg.net}
    for name, p in (("fp32", pred), ("int8", pred_q)):
        for B in (1, 32, 256):
            f = np.resize(frames, (B,) + frames.shape[1:])
            c = np.resize(centers, (B, 3))
            ms = host_ms(lambda: p.predict(f, c), {1: 20, 32: 10, 256: 5}[B])
            out[f"{name}_predict_ms_b{B}"] = ms
            out[f"{name}_predict_fps_b{B}"] = B / ms * 1e3
        for B in (8, 32, 256):
            img = torch.from_numpy(np.resize(crops, (B,) + crops.shape[1:]))
            out[f"{name}_infer_ms_b{B}"] = device_ms(p._infer, [(img.cuda(),)],
                                                     10)

    gemm = {}
    for B in (32, 8):
        gemm[B] = gemm_request(pred_q, torch.from_numpy(crops[:B]).cuda(),
                               bw, int8_ops)
        out[f"int8_gemm_request_b{B}"] = gemm[B]
    deconvs = {}
    for B, H, c_in, c_out in DECONV_CHECKS[:3]:
        deconvs[f"deconv_{H}x{H}_{c_in}_{c_out}"] = deconv_times(
            B, H, c_in, c_out, bw, int8_ops)
    out["deconv_int8_request_b32"] = dict(
        {key: sum(r[key] for r in deconvs.values())
         for key in ("ms", "plain_ms", "bound_ms", "library_ms", "bytes",
                     "ops")}, deconvs=deconvs)
    # deconv2 alone, the row kept comparable with earlier runs
    dec = out["deconv_int8_b32"] = deconvs["deconv_32x32_256_256"]
    emit(out)
    return {"int8_gemm": gemm[32], "deconv_int8": dec}


def gemm_request(pred_q, img, bw, int8_ops):
    """The int8 GEMM at every distinct shape of one request on ``img``,
    summed over the request's 20 GEMMs.  B is passed as a QuantConv
    passes it, the transposed view of a contiguous (N, K) weight, which
    the wrapper takes without a copy.  The library call is torch._int_mm
    on a contiguous (K, N) B, with K padded by zeros to a multiple of 8
    (the same products)."""
    shapes = gemm_shapes(pred_q, img)
    per_shape = {}
    for M, K, N in sorted(set(shapes)):
        def gemm_args(M=M, K=K, N=N):
            return int8_codes((M, K), M + K), int8_codes((N, K), N).t()
        r = kernel_times(int8_cuda.int8_matmul_cuda, int8.int8_matmul,
                         gemm_args, M * K + K * N + 4 * M * N, 2 * M * K * N,
                         bw, int8_ops)
        Kp = -(-K // 8) * 8

        def lib_args(M=M, K=K, N=N, Kp=Kp):
            a, b = gemm_args()
            return (F.pad(a, (0, Kp - K)).contiguous(),
                    F.pad(b, (0, 0, 0, Kp - K)).contiguous())
        r["library_ms"] = device_ms(torch._int_mm, [lib_args() for _ in range(
            max(2, -(-200_000_000 // r["bytes"])))], 50)
        r["count"] = shapes.count((M, K, N))
        r["tops"] = r["ops"] / r["ms"] / 1e9
        r["plan"] = int8_cuda.gemm_plan(M, K, N)._asdict()
        per_shape[f"{M}x{K}x{N}"] = r
    gemm = {key: sum(r[key] * r["count"] for r in per_shape.values())
            for key in ("ms", "plain_ms", "bound_ms", "library_ms", "bytes",
                        "ops")}
    t_bytes, t_ops = gemm["bytes"] / bw, gemm["ops"] / int8_ops
    gemm.update(launches=len(shapes),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                tops=gemm["ops"] / gemm["ms"] / 1e9, shapes=per_shape)
    return gemm


def deconv_times(B, H, c_in, c_out, bw, int8_ops):
    """The int8 deconv at one decoder shape; its library call is cuDNN's
    float32 conv_transpose2d (TF32 off) on the int8 values, times the
    scale: exact where cuDNN sums directly and every partial sum is an
    integer below 2**24 (C_in = 256: 4 * 256 * 127**2 < 2**24; deconv0's
    C_in = 512 can pass it), so its error is recorded."""
    def dec_args():
        return deconv_args(B, H, c_in, c_out)
    nbytes = B * H * H * c_in + 16 * c_in * c_out + 4 * c_out \
        + 4 * B * c_out * 4 * H * H
    dec = kernel_times(int8_cuda.deconv4x4s2_int8_cuda, int8.deconv4x4s2_int8,
                       dec_args, nbytes, 2 * 16 * B * H * H * c_in * c_out,
                       bw, int8_ops)

    def lib_args():
        xq, wq, scale = dec_args()
        return (xq.permute(0, 3, 1, 2).float().contiguous(), wq.float(),
                scale.view(1, -1, 1, 1))

    def lib(x, w, scale):
        return F.conv_transpose2d(x, w, stride=2, padding=1) * scale
    xq, wq, scale = dec_args()
    dec["library_max_abs_err"] = float(
        (lib(*lib_args()) - int8_cuda.deconv4x4s2_int8_cuda(xq, wq, scale))
        .abs().max())
    dec["library_ms"] = device_ms(lib, [lib_args() for _ in range(2)], 20)
    dec["shape"] = [B, H, H, c_in, c_out]
    dec["plan"] = int8_cuda.deconv_plan(B, H, H, c_in, c_out)._asdict()
    dec["tops"] = dec["ops"] / dec["ms"] / 1e9
    return dec


# kernel-name groups of the int8 forward's profile, first match wins
INT8_GROUPS = [("int8_gemm", ("s8_gemm",)), ("deconv_int8", ("s8_deconv",)),
               ("decode", ("decode_kernel",)), ("im2col", ("im2col",)),
               ("copies (to int8, layouts)", ("copy",)),
               ("cudnn (BatchNorm, heads)", ("cudnn", "bn_fw", "xmma",
                                             "implicit", "sm90", "sm80",
                                             "cutlass", "gemm", "conv")),
               ("max_pool", ("max_pool",))]


def phase_profile(path, fn, args, steps=3, groups=()):
    """Device time of ``fn(*args)`` by kernel (``torch.profiler``),
    summed over ``steps`` calls, and the device's busy share of them;
    with ``groups``, also by group of kernel names (the rest under
    "quantize, dequantize and other elementwise")."""
    from torch.profiler import ProfilerActivity, profile

    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn(*args)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: an aten op's own device time would count
    # its kernels a second time
    rows = [(e.key, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy_ms = sum(ms for _, ms in rows)
    rows.sort(key=lambda r: -r[1])
    by_group = {}
    for name, ms in rows:
        group = next((g for g, keys in groups
                      if any(k in name for k in keys)),
                     "quantize, dequantize and other elementwise")
        by_group[group] = by_group.get(group, 0.0) + ms / steps
    emit({"phase": "profile", "path": path, "steps": steps,
          "wall_ms_per_step": wall_ms / steps,
          "device_ms_per_step": busy_ms / steps,
          "device_busy_share": busy_ms / wall_ms if busy_ms else None,
          **({"groups_ms_per_step": by_group} if groups else {}),
          "kernels_by_device_ms": [
              {"name": name[:90], "ms_per_step": ms / steps,
               "share": ms / busy_ms} for name, ms in rows[:25]]})


@contextlib.contextmanager
def trainer_marks(profile_epoch=None):
    """While open, every ``Trainer.test`` records (epoch, MPE, AUC) and,
    after a device sync, the wall time it starts; every ``Trainer.save``
    the wall time it ends (synced); the staging thread each batch's
    staging time, and the loop each wait for a staged batch (the wall
    time it ends and how long it took).  With ``profile_epoch``, a CUDA
    ``torch.profiler`` runs from the save of the epoch before it to the
    test of that epoch: its train part."""
    from torch.profiler import ProfilerActivity, profile

    from awr_tpu_torch.training import trainer as trainer_module

    log = {"tests": [], "test_start": {}, "save_end": {}, "profile": None,
           "stage": [], "wait": []}
    test, save, stage = Trainer.test, Trainer.save, Trainer._stage
    prefetch = trainer_module.prefetch_to_device
    prof = profile(activities=[ProfilerActivity.CUDA])

    def test_spy(self, epoch=0):
        torch.cuda.synchronize()
        log["test_start"][epoch] = time.perf_counter()
        if epoch == profile_epoch:
            prof.stop()
            log["profile"] = prof
        mpe, auc = test(self, epoch)
        log["tests"].append((epoch, mpe, auc))
        return mpe, auc

    def save_spy(self, epoch):
        save(self, epoch)
        torch.cuda.synchronize()
        log["save_end"][epoch] = time.perf_counter()
        if profile_epoch is not None and epoch == profile_epoch - 1:
            prof.start()

    def stage_spy(self, raw, ds):
        t0 = time.perf_counter()
        out = stage(self, raw, ds)
        log["stage"].append((time.perf_counter(), time.perf_counter() - t0))
        return out

    def prefetch_spy(iterator, fn, depth):
        it = prefetch(iterator, fn, depth)
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            log["wait"].append((time.perf_counter(),
                                time.perf_counter() - t0))
            yield item

    Trainer.test, Trainer.save, Trainer._stage = test_spy, save_spy, stage_spy
    trainer_module.prefetch_to_device = prefetch_spy
    try:
        yield log
    finally:
        Trainer.test, Trainer.save, Trainer._stage = test, save, stage
        trainer_module.prefetch_to_device = prefetch


def busy_ms(prof) -> float:
    """Device time of the profiled kernels and copies."""
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3


def device_gaps(prof, min_ms=1.0):
    """The idle stretches of the device timeline between its first and
    last profiled event: how many last at least ``min_ms``, their sum,
    and the six longest with their offsets from the first event (ms);
    and the first event's offset from the profiler's start (the lead-in,
    ms)."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    gaps, end = [], spans[0][1]
    for a, b in spans[1:]:
        if a - end >= min_ms * 1e3:
            gaps.append(((a - end) / 1e3, (end - spans[0][0]) / 1e3))
        end = max(end, b)
    gaps.sort(reverse=True)
    return {"lead_in_ms": spans[0][0] / 1e3,
            "span_ms": (end - spans[0][0]) / 1e3, "min_ms": min_ms,
            "count": len(gaps), "sum_ms": sum(g for g, _ in gaps),
            "longest_ms_at_ms": gaps[:6]}


def in_window(events, t0, t1):
    """The durations (s) of the (end time, duration) events ending in
    [t0, t1]."""
    return [d for t, d in events if t0 <= t <= t1]


def phase_trainer(bare_fps, bare_step):
    """The training and evaluation CLIs, the checkpoints and the serving
    loader, hourglass_1 at full width, B = 32 (see the module's
    docstring).  ``bare_step()`` runs one bare raw train step."""
    steps = -(-TRAINER_FRAMES // TRAIN_BATCH)
    evals = -(-TRAINER_TEST_FRAMES // TRAIN_BATCH)
    out = {"phase": "trainer", "net": "hourglass_1", "batch": TRAIN_BATCH,
           "frames": TRAINER_FRAMES, "test_frames": TRAINER_TEST_FRAMES}
    # the bare step called back to back from Python, as a loop would
    loop_s = host_ms(lambda: [bare_step() for _ in range(steps)]
                     + [torch.cuda.synchronize()], 3) / 1e3
    out["bare_step_loop_fps"] = steps * TRAIN_BATCH / loop_s
    with tempfile.TemporaryDirectory() as root:
        argv = ["--net", "hourglass_1", "--synthetic", "--data-mode", "raw",
                "--synthetic-size", str(TRAINER_FRAMES),
                "--synthetic-test-size", str(TRAINER_TEST_FRAMES),
                "--batch-size", str(TRAIN_BATCH), "--output-dir", root,
                "--device", "cuda"]
        with trainer_marks():
            reset_counts()
            t0 = time.perf_counter()
            tr = train_cli.main(argv + ["--epochs", "2"])
            torch.cuda.synchronize()
            out["two_epochs_s"] = time.perf_counter() - t0
            out["launches"] = counts()
        # an eval step encodes the target for its loss too
        check_launches("trainer", out["launches"], {
            "encode": 2 * (steps + evals), "decode": 2 * (steps + evals),
            "decode_backward": 2 * steps})
        ckpt = os.path.join(tr.work_dir, "ckpt")
        out["checkpoints"] = sorted(os.listdir(ckpt))
        if out["checkpoints"] != ["1.pth", "2.pth"]:
            raise AssertionError(f"checkpoints: {out['checkpoints']}")

        with trainer_marks() as marks:
            reset_counts()
            tr = train_cli.main(argv + ["--epochs", "3"])
            torch.cuda.synchronize()
            resumed = counts()
        log = open(tr.log_file).read()
        out["resume"] = {
            "logged_restore": "restored checkpoint (epoch 2)" in log,
            "epochs_tested": [e for e, _, _ in marks["tests"]],
            "launches": resumed}
        if not out["resume"]["logged_restore"] \
                or out["resume"]["epochs_tested"] != [3]:
            raise AssertionError(f"resume: {out['resume']}")
        check_launches("trainer resume", resumed, {
            "encode": steps + evals, "decode": steps + evals,
            "decode_backward": steps})
        last_mpe = marks["tests"][-1][1]

        mpe = evaluate_cli.main(argv + ["--load-model",
                                        os.path.join(ckpt, "3.pth")])
        out["evaluate"] = {"trainer_test_mpe_epoch3": last_mpe,
                           "evaluate_cli_mpe": mpe,
                           "abs_err": abs(mpe - last_mpe),
                           "atol": EVAL_MPE_ATOL}
        if not abs(mpe - last_mpe) <= EVAL_MPE_ATOL:
            raise AssertionError(f"evaluate: {out['evaluate']}")

        # the Trainer's eval joints against a Predictor from its
        # checkpoint, on the Trainer's own crops of the test frames
        items = [tr.test_data[i] for i in range(TRAIN_BATCH)]
        raw, p, _ = tr._stage({k: np.stack([it[k] for it in items])
                               for k in items[0]}, tr.test_data)
        m = tr._raw_eval_step(raw, p)
        pred = Predictor.from_checkpoint(tr.cfg, ckpt, device="cuda")
        got = pred.predict_normalized(m["img"].cpu().numpy())
        want = m["jt_uvd_pred"].cpu().numpy()
        out["from_checkpoint_max_abs_err"] = float(np.abs(got - want).max())
        if not np.array_equal(got, want):
            raise AssertionError("Predictor.from_checkpoint joints differ "
                                 "from the Trainer's eval joints")

        # epochs 4-6: 4 renders the new process's frames, 5 is timed, 6
        # profiled
        with trainer_marks(profile_epoch=6) as marks:
            tr = train_cli.main(argv + ["--epochs", "6"])
        t_train = {e: marks["test_start"][e] - marks["save_end"][e - 1]
                   for e in (5, 6)}
        win = (marks["save_end"][4], marks["test_start"][5])
        waits = in_window(marks["wait"], *win)
        stages = in_window(marks["stage"], *win)
        busy = busy_ms(marks["profile"])
        out["warm_epoch"] = {
            "train_s": t_train[5],
            "train_fps": TRAINER_FRAMES / t_train[5],
            "bare_step_train_fps_b32": bare_fps,
            "ratio_to_bare_step": TRAINER_FRAMES / t_train[5] / bare_fps,
            "loop_waits_for_batches_s": sum(waits),
            "loop_waits_s": waits,
            "staging_s_per_batch": float(np.mean(stages)) if stages else None,
            "profiled_epoch_train_s": t_train[6],
            "profiled_epoch_busy_ms": busy,
            "idle_share": 1.0 - busy / (t_train[6] * 1e3),
            "device_gaps": device_gaps(marks["profile"])}
        out["best_records"] = tr.best_records
    emit(out)
    return out["launches"]


def rel_to_max(got, want) -> float:
    """max |got - want| over max |want| (0 where want is all 0)."""
    scale = float(want.abs().max())
    return float((got - want).abs().max()) / scale if scale else 0.0


def phase_train_resnet(frames, joints, centers):
    """Raw resnet_18 train steps at B = 32: exact launch counts, one step
    against the CPU, one with remat against one without, frames/s."""
    cfg = resnet_config(coord_weight=0.1)
    model = new_model(cfg, "cuda")
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    opt = make_optimizer(model.parameters(), cfg.optimizer, cfg.lr)
    train = make_raw_train_step(model, opt, cfg, cfg.paras, cfg.flip)
    raw, p = raw_inputs(cfg, frames, joints, centers, "cuda")
    gen = torch.Generator("cuda").manual_seed(SEED)
    B = len(frames)

    reset_counts()
    metrics = [train(raw, p, draw_augment_params(gen, B, *cfg.augment_para))
               for _ in range(RESNET_STEPS)]
    torch.cuda.synchronize()
    launches = counts()
    losses = [float(m["loss"]) for m in metrics]
    check_launches("train_resnet", launches, {
        "encode": RESNET_STEPS, "decode": RESNET_STEPS,
        "decode_backward": RESNET_STEPS})
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite resnet loss: {losses}")

    aug = draw_augment_params(torch.Generator("cuda").manual_seed(SEED + 4),
                              B, *cfg.augment_para)
    step_ms = device_ms(train, [(raw, p, aug)], 10)

    # one step from the same weights with and without remat
    runs = {}
    for remat in (False, True):
        m = build_model(cfg.net, cfg.jt_num, cfg.downsample, remat=remat)
        m.load_state_dict(sd)
        m.cuda()
        step = make_raw_train_step(
            m, make_optimizer(m.parameters(), cfg.optimizer, cfg.lr), cfg,
            cfg.paras, cfg.flip)
        loss = float(step(raw, p, aug)["loss"])
        runs[remat] = (loss, {n: q.grad.detach().clone()
                              for n, q in m.named_parameters()},
                       {n: b.detach().clone() for n, b in m.named_buffers()})
    (l0, g0, b0), (l1, g1, b1) = runs[False], runs[True]
    grad_err = max(rel_to_max(g1[n], g0[n]) for n in g0)
    stats_err = max(rel_to_max(b1[n], b0[n]) for n in b0
                    if "running" in n)
    counters_equal = all(torch.equal(b0[n], b1[n]) for n in b0
                         if n.endswith("num_batches_tracked"))
    stats_bit_equal = sum(torch.equal(b0[n], b1[n]) for n in b0
                          if "running" in n)
    emit({"phase": "train_resnet", "net": cfg.net, "batch": B,
          "steps": RESNET_STEPS, "coord_weight": cfg.coord_weight,
          "launches": launches, "loss_first": losses[0],
          "loss_last": losses[-1], "train_step_ms_b32": step_ms,
          "train_fps_b32": B / step_ms * 1e3,
          "remat": {"loss": l1, "loss_without": l0,
                    "grad_max_err_rel_to_max": grad_err,
                    "running_stats_max_err_rel_to_max": stats_err,
                    "rtol_of_max": REMAT_RTOL_OF_MAX,
                    "running_stats_bit_equal": stats_bit_equal,
                    "running_stats": sum("running" in n for n in b0),
                    "batch_counters_equal": counters_equal}})
    if not (grad_err <= REMAT_RTOL_OF_MAX and stats_err <= REMAT_RTOL_OF_MAX
            and counters_equal):
        raise AssertionError("the remat step disagrees with the step "
                             "without it")
    phase_cross_device(cfg, frames, joints, centers,
                       phase="train_resnet_cross_device")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.cuda.set_device(0)
    smi = phase_env()
    bw, flops, int8_ops = peaks(torch.cuda.get_device_name(0))
    phase_build()
    errs = phase_kernels()

    cfg = hourglass_config(coord_weight=0.1)
    frames, joints, centers = synthetic_frames(TRAIN_BATCH, cfg.jt_num,
                                               seed=SEED)
    launches = {}
    model, _, train, raw, p, launches["train"] = phase_train(
        cfg, frames, joints, centers)
    phase_cross_device(cfg, frames, joints, centers)
    launches["eval"] = phase_eval(cfg, model, raw, p)
    pred, launches["serve"] = phase_serve(cfg, frames, centers)
    pred_r, pred_q, crops, resnet_launches = phase_serve_resnet(frames,
                                                                centers)
    launches.update(resnet_launches)
    times, bare_fps = phase_time(cfg, pred, frames, centers, bw, flops,
                                 train, raw, p)
    times.update(phase_time_resnet(pred_r, pred_q, crops, frames, centers,
                                   bw, int8_ops))
    phase_profile("train", train, (raw, p, draw_augment_params(
        torch.Generator("cuda").manual_seed(SEED + 3), TRAIN_BATCH,
        *cfg.augment_para)))
    phase_profile("serve_resnet_int8 forward + decode, B = 32",
                  pred_q._infer, (torch.from_numpy(crops).cuda(),),
                  groups=INT8_GROUPS)
    aug = draw_augment_params(torch.Generator("cuda").manual_seed(SEED + 5),
                              TRAIN_BATCH, *cfg.augment_para)
    launches["trainer"] = phase_trainer(bare_fps,
                                        lambda: train(raw, p, aug))
    launches["train_resnet"] = phase_train_resnet(frames, joints, centers)

    emit({"kernels": [
        {"name": k["name"], "route": k["route"], "source": k["source"],
         "replaces": k["replaces"],
         "launches": launches[k["path"]][k["name"]],
         "launches_by_path": {path: n[k["name"]]
                              for path, n in launches.items()},
         "max_abs_err": errs[k["name"]], "ms": times[k["name"]]["ms"],
         "plain_ms": times[k["name"]]["plain_ms"],
         "bound_ms": times[k["name"]]["bound_ms"],
         "bound_by": times[k["name"]]["bound_by"],
         "library_ms": times[k["name"]].get("library_ms")}
        for k in KERNELS]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
