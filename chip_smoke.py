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
float32, TF32 off (then bf16, phase ``bf16``):

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
- serve_hourglass_int8: hourglass_1 ``Predictor.quantize`` on 32 crops,
  then int8 requests (55 int8 GEMMs and one decode each: the stem, every
  residual conv and skip, ``feature_conv``) in float32 and bf16 compute
  with exact launch counts, a contiguous map, the joints against float32
  ones and (float32) against an int8 Predictor on the CPU with the card's
  scales; request and device times at B = 1, 32 and 256 with the peak
  memory; the GEMM at the B = 256 stem shape (M * K past 2**31) against
  its plain version; the 55 GEMMs of a B = 32 request against their
  bound; a profile of the int8 forward;
- qat: for hourglass_1 and resnet_18, ``quantize`` then ``quantize_qat``
  on two labeled 32-frame grid-layout batches with one held out (exact
  launch counts: one encode, decode and decode backward a QAT step, the
  int8 kernels in the holdout's eval steps), int8 after QAT against the
  CPU, the QAT step's device time beside the float32 step's, the
  ruinous-lr fallback (bit-equal PTQ weights and statistics), and the
  QAT forward against the int8 forward with TF32 on globally (and
  against itself with TF32 off);
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
  ``remat`` against it without, and train frames/s;
- datasets: an NYU-layout directory written here (320 train and 64 test
  640x480 frames rendered from 36-joint labels, 8-bit RGB PNGs whose
  rows cycle through the five filter types, ``joint_data.mat``, refined
  centers) and 16-frame ICVL, MSRA and HANDS17 directories; every NYU
  frame decoded by the C++ unfilter and by the plain one, bit-equal to
  each other and to the depth that was encoded; the host item's time;
  the training CLI on the NYU directory (hourglass_1, B = 32, 3 epochs)
  in host mode and in raw mode with exact launch counts, a warm epoch's
  train frames/s and the next epoch's idle share; the evaluation CLI on
  each run's last checkpoint in both modes (host and raw test MPE within
  HOST_RAW_MPE_ATOL); and one evaluation-CLI call on each of the ICVL
  (J = 16), MSRA and HANDS17 (J = 21) directories;
- bf16: ``compute_dtype="bfloat16"`` at the same widths: hourglass_1
  and resnet_18 requests (resnet_18 through the inference form of
  ``models/inference.py``: one stem_pool, 19 bias_relu and one head_out
  launch each), and resnet_18 int8 requests under bf16 (20 int8 GEMMs
  and 3 int8 deconvs with the bf16 epilogue each), with exact launch
  counts, each path's joints against the float32 joints of the
  same seeded weights (BF16_DRIFT_MAX), request and device times at
  B = 1, 32 and 256; the raw train step of each family at B = 32 (exact
  launch counts, device time beside the float32 step's); the training
  CLI in bf16 (``--synthetic --data-mode raw``, 3 epochs: frames/s of
  the second, idle share of the third); then profiles of both families'
  bf16 train steps and of resnet_18's float32 one;
- server: ``Predictor.predict_async`` of hourglass_1 at B = 256 twice in
  a row (B's dispatch must not wait for A's device work, and A's
  ``finalize`` must return while B's work runs); an in-process
  ``awr_tpu_torch.server.AWRServer`` (``/healthz``; ``/predict`` and
  ``/predict_batch`` as JSON and base64 against ``Predictor.predict``),
  the same for an int8 resnet_18 under bf16 (the server CLI's defaults);
  the server CLI in a process of its own (``--pth`` and ``--int8-calib``
  written here): ``/healthz`` reports int8 and its joints equal the
  in-process int8 Predictor's; a closed-loop load (32, then 4, client
  threads in another process posting single 480x640 ``img_b64`` frames
  for 10 s:
  frames/s, p50 and p99, frames a dispatch, the card's idle share over a
  profiled window); priming at 480x640 and a 64-request burst against a
  25 ms deadline and an 8-frame queue (503s with Retry-After, then a
  plain request serves).  The decode launches equal the servers'
  dispatches; the int8 kernels launch 20 and 3 times a dispatch;
- export: see ``phase_export``;
- parallel: (a) the training CLI (the trainer phase's data, 2 epochs)
  in a spawned process that is the one rank of an NCCL process group,
  so the Trainer runs its data-parallel path (DDP; BatchNorm plain at
  world size 1), against the same CLI in this process, in turns (one
  process, DDP, DDP, one process), all with cuDNN's deterministic
  algorithms: losses, test results, records and weights bit-equal,
  exact launches, the warm epoch's train frames/s of each run;
  (b) two spawned gloo ranks sharing the card (NCCL takes one rank a
  GPU): DDP, the global BatchNorm and the global loss normalization in
  one raw SGD step on their rows of a batch of 32 (rank 1's last 4 rows
  padding) against one process's step on the 32 rows (loss rtol 1e-3,
  parameters rtol 1e-3, atol 1e-5; running statistics equal on both
  ranks), exact launches, the step's time; (c) Predictors on
  ``make_mesh(devices=["cuda:0"] * 2)``: float32 hourglass_1 at B = 1,
  12, 32, 256 and int8 resnet_18 (its scales bit-equal) against the
  one-device Predictors, the mesh buckets, one decode (and 20 GEMMs and
  3 deconvs) per replica a request, request times beside the one-device
  Predictor's (both replicas share one card: no scaling is claimed).
- spatial: Predictors on ``spatial_mesh(devices=["cuda:0"] * n)`` for n =
  2 and 8 (each request's image rows in n bands, run band by band with
  halo rows exchanged, the row-window decode on each band, the bands'
  softmax merged): hourglass_1 float32 raw ``predict`` at B = 1 and 32
  against the one-device Predictor (normalized joints within
  SPATIAL_ATOL), hourglass_1 bf16 at B = 1 (the 2x rule of
  tests/test_torch_bf16.py against the one-device bf16 Predictor),
  resnet_18 float32 and int8 (scales bit-equal, joints within
  INT8_CPU_ATOL), exact launches (one row-window decode a band, each
  int8 GEMM and deconv once a band), request times beside the
  one-device Predictor's, a ``BatchingPredictor`` over the spatial
  Predictor, and the row-window decode's device time (one card: no
  scaling is claimed).

Each path runs with the launch counts (``kernels.LAUNCHES``) cleared
just before it and is checked to have gone through its kernels.  Each
phase prints one JSON line; then come the kernel summary line, the
card's name and power limit, and the status line.  Any failure raises and exits non-zero.
Without a GPU it exits 1 and prints no result.  Imports torch, numpy and
the port only.
"""

from __future__ import annotations

import base64
import contextlib
import copy
import http.client
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from awr_tpu_torch import kernels
from awr_tpu_torch.benchmarks.predict_latency import predict_ms
from awr_tpu_torch.config import (DATASET_PARAS, DTYPES, hourglass_config,
                                  resnet_config)
from awr_tpu_torch.data import native_decode
from awr_tpu_torch.data.device import (crop_normalize_batch,
                                       crop_param_tensors,
                                       draw_augment_params)
from awr_tpu_torch.data.hands17 import HANDS17_PARAS
from awr_tpu_torch.data.nyu import (EVAL_SELECT, JOINT_SELECT, NYU_FLIP,
                                    NYU_PARAS, NYUDataset)
from awr_tpu_torch.data.synthetic import (SyntheticHandDataset,
                                          render_hand_depth, synthetic_frames)
from awr_tpu_torch.data.transforms import crop_params_np
from awr_tpu_torch.geometry import xyz2uvd_np
from awr_tpu_torch.models import build_model
from awr_tpu_torch.models.common import torch_default_init_
from awr_tpu_torch.models.quant import (QuantConv, quant_layers, set_int8,
                                        set_quant_mode)
from awr_tpu_torch.ops import (decode_cuda, encode_cuda, folded, folded_cuda,
                               int8, int8_cuda)
from awr_tpu_torch.ops.decode import decode_offsets
from awr_tpu_torch.ops.functional import (joint2offset, merge_softmax_bands,
                                          offset2joint_softmax,
                                          offset2joint_softmax_backward,
                                          offset2joint_softmax_rows,
                                          offset2joint_softmax_stats)
from awr_tpu_torch.server import AWRServer
from awr_tpu_torch.serving import Predictor
from awr_tpu_torch.training import evaluate as evaluate_cli
from awr_tpu_torch.training import train as train_cli
from awr_tpu_torch.training import qat
from awr_tpu_torch.training.optim import make_optimizer
from awr_tpu_torch.training.steps import (make_raw_eval_step,
                                          make_raw_train_step,
                                          make_train_step)
from awr_tpu_torch.training.trainer import Trainer
from awr_tpu_torch.utils import png
from awr_tpu_torch.utils.profiling import chip_peaks

SEED = 0
KERNEL_SIZE = 0.4
# Each hand-written kernel on the paths: its name in kernels.LAUNCHES, its
# source, the TPU kernel (or XLA function) it replaces, and the main path
# whose launches the summary reports (the Trainer's, for the AWR kernels;
# the int8 requests', for the int8 ones).
KERNELS = [
    dict(name="decode", route="cuda", source="awr_tpu_torch/csrc/decode.cu",
         replaces="awr_tpu/ops/pallas_decode.py:69", path="trainer"),
    dict(name="encode", route="cuda", source="awr_tpu_torch/csrc/encode.cu",
         replaces="awr_tpu/ops/pallas_encode.py:40", path="trainer"),
    dict(name="decode_backward", route="cuda",
         source="awr_tpu_torch/csrc/decode.cu",
         replaces="awr_tpu/ops/decode.py:37", path="trainer"),
    dict(name="int8_gemm", route="cuda", source="awr_tpu_torch/csrc/int8.cu",
         replaces="awr_tpu/ops/pallas_int8.py:190", path="serve_resnet_int8"),
    dict(name="deconv_int8", route="cuda",
         source="awr_tpu_torch/csrc/int8.cu",
         replaces="awr_tpu/ops/pallas_int8.py:89", path="serve_resnet_int8"),
    # the same kernel with its bfloat16 epilogue (the Pallas kernel's
    # out_dtype), on the int8 requests under bf16 compute
    dict(name="deconv_int8_bf16", route="cuda",
         source="awr_tpu_torch/csrc/int8.cu",
         replaces="awr_tpu/ops/pallas_int8.py:89",
         path="bf16_serve_resnet_18_int8"),
    # the decode's kernel on a window of map rows: one launch for each
    # band of a spatial request
    dict(name="decode_rows", route="cuda",
         source="awr_tpu_torch/csrc/decode.cu",
         replaces="awr_tpu/ops/pallas_decode.py:69", path="spatial"),
    # the bf16 inference form's passes between its cuDNN convs
    # (models/inference.py), on bf16 resnet_18 requests; on the TPU, XLA
    # fuses this work into the convs of the jitted forward
    dict(name="stem_pool", route="cuda",
         source="awr_tpu_torch/csrc/folded.cu",
         replaces="none (XLA fusion)", path="bf16_serve_resnet_18"),
    dict(name="bias_relu", route="cuda",
         source="awr_tpu_torch/csrc/folded.cu",
         replaces="none (XLA fusion)", path="bf16_serve_resnet_18"),
    dict(name="head_out", route="cuda",
         source="awr_tpu_torch/csrc/folded.cu",
         replaces="none (XLA fusion)", path="bf16_serve_resnet_18"),
]
SOURCES = sorted({k["source"].split("/")[-1][:-3] for k in KERNELS})
# host C++ built beside the kernels: the PNG unfilter of the datasets
HOST_SOURCES = ["png_unfilter"]
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
# the bf16 phase: request batches timed, train steps counted, Trainer
# epochs (the second timed, the third profiled); bf16 joints against
# float32 ones of the same weights, normalized uvd: the int8 drift bar
BF16_BATCHES = (1, 32, 256)
BF16_TRAIN_STEPS = 5
BF16_TRAINER_EPOCHS = 3
BF16_DRIFT_MAX = INT8_DRIFT_MAX
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
# the datasets phase's NYU-layout directory (10 and 2 steps an epoch at
# B = 32) and its ICVL, MSRA and HANDS17 directories
NYU_TRAIN_FRAMES = 320
NYU_TEST_FRAMES = 64
SMALL_FRAMES = 16
DATASET_EPOCHS = 3
# one checkpoint's test MPE read in host mode and in raw mode: the host
# chain against the device crop, which the JAX package holds to its host
# crop at 1e-6 in normalized units (tests/test_data.py:166,197)
HOST_RAW_MPE_ATOL = 0.01
ITEM_TIMING_FRAMES = 64
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
# An int8 Predictor on the card against one on the CPU with the same
# weights and scales (:func:`int8_vs_cpu`), on INT8_CPU_CROPS crops.
# Layer by layer, each quantized layer run on the card's own input: the
# codes, the integer products, the dequantizing product and its rounding
# to the compute dtype are the same operations on both devices, so the
# outputs are bit-equal, in float32 and in bf16 (a planted fault, one
# layer's activation scale doubled on the card, reads 0.0097 to 0.029 of
# max |output| on the H100).  End to end, on the joints: the float layers
# (BatchNorm, adds, heads) round differently on the two devices, a code
# on a rounding boundary flips by one step, and the flips reach the
# joints (INT8_CPU_ATOL's reason).  Through the 55 int8 convs of
# hourglass_1 they read 0.0024 to 0.0105 on the H100 (bf16, float32,
# after QAT), the planted faults 0.0129 to 0.0235, int8's own drift
# from float32 0.028: the bar lies between the sound and the planted
# readings.
INT8_CPU_CROPS = 8
INT8_LAYER_RTOL_OF_MAX = 0.0
HG_INT8_CPU_ATOL = 0.012
# the int8 hourglass_1: quantized convs a request; the GEMM at B = 256's
# largest shape, the stem's 3x3 (pre.1.conv2: 256 * 128**2 rows, M * K
# past 2**31), held against its plain version
HG_INT8_GEMMS = 55
HG_STEM_GEMM_B256 = (256 * 128 * 128, 576, 64)
# QAT: labeled synthetic batches (B = 32) to fine-tune on and to hold out,
# fine-tune steps, the gentle recipe's lr; the ruinous lr of the fallback
# check.  QAT forward against int8 forward: the JAX package's bars
# (tests/test_quant.py:207-238), 0.05 of max |map|, 0.02 on the joints.
QAT_TUNE_BATCHES = 2
QAT_HOLDOUT_BATCHES = 1
QAT_STEPS = 4
QAT_LR = 1e-5
QAT_RUINOUS_LR = 50.0
QAT_MAP_RTOL_OF_MAX = 0.05
QAT_JOINT_ATOL = 0.02
# each QAT conv's output with TF32 on globally against it with TF32 off:
# the same float32 convs (TF32 is forced off inside), so equal up to cuDNN
# choosing another algorithm; TF32 moves a conv by ~1e-3 of its scale
QAT_TF32_RTOL_OF_MAX = 1e-5
# The server phase: the predict_async contract at B = 256 (hourglass_1
# float32: about 212 ms of device work a request), B's dispatch held to
# under half of A's device time; the closed-loop load (client threads in a
# separate process, single 480x640 img_b64 frames; 32 threads, then 4 to
# see what contention costs) and its profiled window; the overload burst against a small deadline and queue; the
# in-process int8 request (the server CLI's defaults: resnet_18, bf16).
# HTTP joints against Predictor.predict on the same frames: the JAX
# package's batching bar (tests/test_batching.py:59).  The server CLI's
# int8 joints against an int8 Predictor built the same way in this
# process: the same code, weights and calibration on the same card.
SERVER_ASYNC_BATCH = 256
SERVER_ASYNC_HOST_SHARE = 0.5
SERVER_LOAD_S = 10.0
SERVER_LOAD_CLIENTS = (32, 4)
SERVER_PROFILE_AT_S, SERVER_PROFILE_S = 3.0, 3.0
SERVER_BURST = 64
SERVER_BURST_DEADLINE_MS = 25.0
SERVER_BURST_MAX_QUEUE = 8
SERVER_RTOL, SERVER_ATOL = 1e-4, 1e-3
SERVER_CLI_ATOL = 1e-3
SERVER_CLI_START_S = 300.0
SERVER_INT8_FRAMES = 8
# The export phase: programs traced by Predictor.export_program at
# B = 32, saved, and run in a fresh process that imports torch, numpy and
# the loader only, against the Predictor call each replaces.  The
# normalized extent: the same kernels and cuDNN convs on the same inputs
# (1e-5 bounds cuDNN taking another algorithm in the other process); the
# raw extent: a float32 inverse of the crop affine in the program against
# the Predictor's float64 one on the host (the JAX package's bar,
# tests/test_serving.py:285); int8: INT8_CPU_ATOL.  Times: the median of
# EXPORT_REPS calls, each ending in a device sync (the program's between
# two ``torch.cuda.synchronize``, its joints copied to the host as the
# Predictor's are).
EXPORT_BATCH = 32
EXPORT_ATOL = {"normalized": 1e-5, "raw": 1e-2, "int8": 1e-3}
EXPORT_REPS = 20
# The parallel phase: (a) the train CLI at world size 1 under NCCL (DDP),
# against the same CLI in this process, in turns; (b) two gloo ranks sharing the
# card, one SGD step at B = 32 with rank 1's last PARALLEL_PAD rows
# padding, held to tests/test_training.py's bars for a mesh against one
# device, then PARALLEL_TIMED_STEPS timed steps; (c) Predictors on
# make_mesh(devices=["cuda:0"] * 2) against one-device Predictors at
# PARALLEL_BATCHES (float32 within EXPORT_ATOL["normalized"], int8 within
# INT8_CPU_ATOL), request times at PARALLEL_TIMED_BATCHES.
PARALLEL_PAD = 4
PARALLEL_LR = 1e-3
PARALLEL_LOSS_RTOL = 1e-3
PARALLEL_PARAM_RTOL, PARALLEL_PARAM_ATOL = 1e-3, 1e-5
PARALLEL_TIMED_STEPS = 5
PARALLEL_BATCHES = (1, 12, 32, 256)
PARALLEL_TIMED_BATCHES = (1, 32, 256)
PARALLEL_REPS = 10
PARALLEL_TIMEOUT_S = 600
# The spatial phase: meshes of n bands on the card, request batches;
# float32 joints against the one-device Predictor's, normalized: cuDNN
# may choose other algorithms for a band's slab than for the whole
# tensor (the data mode's bar, EXPORT_ATOL["normalized"]); bf16: the max
# of tests/test_torch_bf16.py's 2x rule (JOINT_ATOL)
SPATIAL_MESHES = (2, 8)
SPATIAL_BATCHES = (1, 32)
SPATIAL_ATOL = 1e-5
SPATIAL_BF16_ATOL = 0.15
SPATIAL_REPS = {1: 20, 32: 10}
# The inference form's passes at the shapes of a resnet_18 request (img
# 128, 14 joints) at B = 32: bias_relu's (C, H, with a residual) for each
# distinct shape of its 19 launches (two 3x3 convs a block, four blocks'
# worth a stage, with the block's residual on the second; the three
# deconvs), head_out's (4J, F), the stem's image side.  bias_relu and
# head_out are one float32 sum and one rounding, as their plain versions,
# so the bar is equality; stem_pool's 25-tap float32 sums run in another
# order than cuDNN's, so an output may round to the other side of a
# bf16 boundary: one bf16 step, 2**-7 of the value.
FOLDED_EPILOGUES = [(64, 64, False, 2), (64, 64, True, 2),
                    (128, 32, False, 2), (128, 32, True, 2),
                    (256, 16, False, 3), (256, 16, True, 2),
                    (512, 8, False, 2), (512, 8, True, 2),
                    (256, 32, False, 1), (256, 64, False, 1)]
FOLDED_HEAD = (56, 64)
FOLDED_STEM = 128
STEM_RTOL = 2.0 ** -7
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
    """(HBM bytes/s, float32 non-tensor FLOP/s, dense int8 tensor OP/s)
    of the card named ``name``, from the port's one table of peak rates
    (``awr_tpu_torch.utils.profiling.CHIP_PEAKS``)."""
    p = chip_peaks(name)
    return p.hbm_bytes_per_s, p.fp32_flops, p.int8_ops


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
    return {k["name"]: kernels.LAUNCHES[k["name"]] for k in KERNELS}


def reset_counts() -> None:
    kernels.LAUNCHES.clear()


def check_launches(path: str, got: dict, want: dict) -> None:
    """``want`` names the kernels the path launches; every other kernel
    must not have launched."""
    want = {k["name"]: want.get(k["name"], 0) for k in KERNELS}
    if got != want:
        raise AssertionError(f"{path}: kernel launches {got}, expected "
                             f"{want}")


def phase_build():
    t0 = time.perf_counter()
    report = kernels.build(SOURCES + HOST_SOURCES)
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
    errs["decode_rows"] = check_decode_rows(off, img)

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
    errs.update(check_folded())
    for name, dtype in (("deconv_int8", torch.float32),
                        ("deconv_int8_bf16", torch.bfloat16)):
        err = 0.0
        for B, H, W, c_in, c_out in DECONV_CHECKS + DECONV_EDGE_CHECKS:
            xq, wq, scale = deconv_args(B, H, c_in, c_out, W=W)
            got = int8_cuda.deconv4x4s2_int8_cuda(xq, wq, scale, dtype)
            torch.cuda.synchronize()
            want = int8.deconv4x4s2_int8(xq, wq, scale, dtype)
            equal = torch.equal(got, want) and got.dtype == dtype
            err = max(err, float((got.float() - want.float()).abs().max()))
            emit({"phase": "kernels", "kernel": name,
                  "shape": [B, H, W, c_in, c_out],
                  "plan": int8_cuda.deconv_plan(B, H, W, c_in,
                                                c_out)._asdict(),
                  "equal_plain": equal, "max_abs_err": err})
            if not equal:
                raise AssertionError(f"{name} disagrees at "
                                     f"{(B, H, W, c_in, c_out)}")
        errs[name] = err
    return errs


def folded_args(B, C, H, residual, seed=SEED):
    """bias_relu's seeded arguments: a channels-last bf16 (B, C, H, H)
    tensor, a float32 bias and the residual (or None)."""
    g = torch.Generator("cuda").manual_seed(seed + C + H)

    def nhwc():
        return torch.randn((B, C, H, H), device="cuda", generator=g).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
    return nhwc(), torch.randn(C, device="cuda", generator=g), (
        nhwc() if residual else None)


def stem_args(B, H, seed=SEED):
    """stem_pool's seeded arguments: (B, 1, H, H) depth in [-1, 1], a bf16
    5x5 weight into 64 channels and a float32 bias."""
    g = torch.Generator("cuda").manual_seed(seed + H)
    return (torch.rand((B, 1, H, H), device="cuda", generator=g) * 2 - 1,
            (torch.randn(folded_cuda.STEM_SHAPE, device="cuda", generator=g)
             * 0.3).to(torch.bfloat16),
            torch.randn(64, device="cuda", generator=g) * 0.1)


def check_folded(B=32):
    """The inference form's three kernels against their plain versions
    (on the card) at the shapes of a resnet_18 request (FOLDED_EPILOGUES,
    FOLDED_HEAD, FOLDED_STEM); returns each kernel's largest error."""
    errs = {}
    err = 0.0
    for C, H, residual, _ in FOLDED_EPILOGUES:
        y, bias, z = folded_args(B, C, H, residual)
        want = folded.bias_relu_(y.clone(), bias, z)
        folded_cuda.bias_relu_cuda(y, bias, z)
        torch.cuda.synchronize()
        err = max(err, float((y.float() - want.float()).abs().max()))
        if not torch.equal(y, want):
            raise AssertionError(f"bias_relu disagrees at {(B, C, H, H)}, "
                                 f"residual {residual}")
    errs["bias_relu"] = err
    C, F_ = FOLDED_HEAD
    y, bias, _ = folded_args(B, C, F_, False)
    got = folded_cuda.head_out_cuda(y, bias)
    torch.cuda.synchronize()
    want = folded.head_out(y, bias)
    errs["head_out"] = float((got - want).abs().max())
    if not (torch.equal(got, want) and got.is_contiguous()):
        raise AssertionError(f"head_out disagrees at {(B, C, F_, F_)}")
    x, w, bias = stem_args(B, FOLDED_STEM)
    got = folded_cuda.stem_pool_cuda(x, w, bias)
    torch.cuda.synchronize()
    want = folded.stem_pool(x, w, bias)
    gap = (got.float() - want.float()).abs()
    errs["stem_pool"] = float(gap.max())
    rec = {"bias_relu_equal": True, "head_out_equal": True,
           "stem_pool_max_abs_err": errs["stem_pool"],
           "stem_pool_outputs_differing": int((gap > 0).sum()),
           "stem_pool_rtol": STEM_RTOL,
           "epilogue_shapes": [[B, C, H, H, r, n]
                               for C, H, r, n in FOLDED_EPILOGUES],
           "head_shape": [B, C, F_, F_], "stem_shape": list(x.shape)}
    emit({"phase": "kernels", "kernel": "folded", **rec})
    if not (got.shape == want.shape
            and got.is_contiguous(memory_format=torch.channels_last)
            and bool((gap <= want.float().abs() * STEM_RTOL).all())):
        raise AssertionError(f"stem_pool disagrees: {rec}")
    return errs


def folded_times(bw, flops, bf16_flops, B=256):
    """The inference form's kernels at the shapes of a B = 256 resnet_18
    request beside their plain versions and bounds: bias_relu summed
    over the request's 19 launches; head_out; stem_pool, whose 25-tap
    conv is bounded by the bf16 tensor cores' rate (its operands are
    bf16, its sums float32) though it runs on the float32 cores."""
    per_shape = {}
    for C, H, residual, count in FOLDED_EPILOGUES:
        def args(C=C, H=H, residual=residual):
            return folded_args(B, C, H, residual)
        n = B * C * H * H
        # y read and written, the residual read, the bias; two adds and
        # the max a value (one add fewer without a residual)
        r = kernel_times(folded_cuda.bias_relu_cuda, folded.bias_relu_, args,
                         n * (6 if residual else 4) + 4 * C,
                         n * (3 if residual else 2), bw, flops)
        r["count"] = count
        per_shape[f"{C}x{H}x{H}" + ("+residual" if residual else "")] = r
    epi = {key: sum(r[key] * r["count"] for r in per_shape.values())
           for key in ("ms", "plain_ms", "bound_ms", "bytes", "ops")}
    epi.update(launches=sum(r["count"] for r in per_shape.values()),
               bound_by="bytes", shapes=per_shape)
    C, F_ = FOLDED_HEAD

    def head_args():
        return folded_args(B, C, F_, False)[:2]
    n = B * C * F_ * F_
    head = kernel_times(folded_cuda.head_out_cuda, folded.head_out,
                        head_args, n * 6 + 4 * C, n, bw, flops)

    def stem():
        return stem_args(B, FOLDED_STEM)
    H = FOLDED_STEM
    Hp = (H + 1) // 2
    pool = kernel_times(folded_cuda.stem_pool_cuda, folded.stem_pool, stem,
                        B * H * H * 4 + 2 * 64 * 25 + 4 * 64
                        + B * 64 * Hp * Hp * 2,
                        2 * 25 * 64 * B * H * H, bw, bf16_flops)
    out = {"phase": "time_folded", "batch": B, "bias_relu_request": epi,
           "head_out": head, "stem_pool": pool}
    emit(out)
    return {"bias_relu": epi, "head_out": head, "stem_pool": pool}


def decode_windows(F, H, n):
    """(row0, rows, img_row0, img_h) of each non-empty band of an F-row
    map over ``n`` bands, with the rows of the H-row depth that its
    nearest resize reads (``parallel.spatial.infer``'s windows)."""
    bounds = [b * F // n for b in range(n + 1)]
    out = []
    for r0, r1 in zip(bounds, bounds[1:]):
        if r1 > r0:
            i0, i1 = (r0 * H) // F, ((r1 - 1) * H) // F + 1
            out.append((r0, r1 - r0, i0, i1 - i0))
    return out


def check_decode_rows(off, img):
    """The row-window decode of every band of 2, 3 and 8 bands of the
    B = 32 map (the spatial path's windows: the first and the last band
    included), and of a 4-row map at B = 8 over 8 bands (four of them
    empty, skipped), each given only the depth rows it reads: against the
    plain window decode (joints within DECODE_ATOL of it in float64: in
    float32 its softmax's 1/P rounds where a window's P pixels are no
    power of two; the statistics against it in float32, the max
    bit-equal, the sum within STATS_SUM_RTOL), and the bands merged
    against the full-map kernel.  Returns float32's largest joint
    error."""
    small = decode_inputs(8, F=4, H=8)
    res, worst = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        for label, (o, d), meshes in (("b32_f64", (off, img), (2, 3, 8)),
                                      ("b8_f4", small, (8,))):
            o = o.to(dtype)
            F, H = o.shape[2], d.shape[1]
            full = decode_cuda.offset2joint_softmax_cuda(o, d, KERNEL_SIZE)
            for n in meshes:
                parts, err, stats_ok = [], 0.0, True
                for r0, rows, i0, h in decode_windows(F, H, n):
                    ow = o[:, :, r0:r0 + rows].contiguous()
                    dw = d[:, i0:i0 + h].contiguous()
                    got = decode_cuda.offset2joint_softmax_rows_cuda(
                        ow, dw, KERNEL_SIZE, r0, i0, H)
                    torch.cuda.synchronize()
                    want = offset2joint_softmax_rows(ow.float(), dw,
                                                     KERNEL_SIZE, r0, i0, H)
                    exact = offset2joint_softmax_rows(
                        ow.double(), dw.double(), KERNEL_SIZE, r0, i0, H)[0]
                    err = max(err, float((got[0].double() - exact)
                                         .abs().max()))
                    stats_ok &= bool(torch.equal(got[1][..., 0],
                                                 want[1][..., 0]))
                    stats_ok &= bool(((got[1][..., 1] - want[1][..., 1]).abs()
                                      / want[1][..., 1]).max()
                                     <= STATS_SUM_RTOL)
                    parts.append(got)
                merged = merge_softmax_bands(parts)[0]
                rec = {"bands": len(parts), "max_abs_err": err,
                       "stats_ok": stats_ok,
                       "merged_vs_full_kernel": float(
                           (merged - full[0]).abs().max())}
                res[f"{name} {label} n={n}"] = rec
                worst[name] = max(worst.get(name, 0.0), err)
                if not (finite_all(got[0]) and stats_ok
                        and err <= DECODE_ATOL
                        and rec["merged_vs_full_kernel"] <= DECODE_ATOL):
                    raise AssertionError(f"decode_rows disagrees: {name} "
                                         f"{label} n={n}: {rec}")
    emit({"phase": "kernels", "kernel": "decode_rows", "windows": res,
          "atol": DECODE_ATOL, "stats_sum_rtol": STATS_SUM_RTOL})
    return worst["float32"]


def finite_all(t) -> bool:
    return bool(torch.isfinite(t).all())


# (M, K, N) of resnet_18's int8 GEMMs at B = 32, img 128: a deconv
# phase's shape (for the int8 probe's comparison), layer1's 3x3 conv, the
# 5x5 stem (K = 25: byte loads; torch._int_mm refuses it), layer4's and
# layer3's 3x3 convs, and layer4's at bucket 8 (split K)
GEMM_CHECKS = [(32768, 1024, 256), (131072, 576, 64), (524288, 25, 64),
               (2048, 4608, 512), (512, 4608, 512), (8192, 2304, 256)]
# (B, H, W, C_in, C_out) of resnet_18's three decoder deconvs at B = 32,
# and deconv0 at bucket 8
DECONV_CHECKS = [(32, 8, 8, 512, 256), (32, 16, 16, 256, 256),
                 (32, 32, 32, 256, 256), (8, 8, 8, 512, 256)]
# widths whose output rows no TMA store takes: odd W (both dtypes), and
# W % 4 == 2 (bfloat16), stored by the threads from shared memory
DECONV_EDGE_CHECKS = [(3, 5, 7, 16, 24), (2, 6, 10, 32, 200)]


def int8_codes(shape, seed):
    g = torch.Generator("cuda").manual_seed(seed)
    return torch.randint(-127, 128, shape, generator=g, device="cuda",
                         dtype=torch.int8)


def deconv_args(B, H, c_in, c_out, seed=SEED, W=None):
    """Seeded int8 NHWC codes (W = H unless given), an int8 (C_in, C_out,
    4, 4) weight and scales in [0.5, 2]."""
    scale = torch.empty(c_out, device="cuda").uniform_(
        0.5, 2.0, generator=torch.Generator("cuda").manual_seed(seed))
    return (int8_codes((B, H, W or H, c_in), seed + 1),
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
        ms = predict_ms(pred, f, c, {1: 20, 32: 10, 256: 5}[B])["median"]
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
            ms = predict_ms(p, f, c, {1: 20, 32: 10, 256: 5}[B])["median"]
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
    for B, H, _, c_in, c_out in DECONV_CHECKS[:3]:
        deconvs[f"deconv_{H}x{H}_{c_in}_{c_out}"] = deconv_times(
            B, H, c_in, c_out, bw, int8_ops)
    out["deconv_int8_request_b32"] = dict(
        {key: sum(r[key] for r in deconvs.values())
         for key in ("ms", "plain_ms", "bound_ms", "library_ms", "bytes",
                     "ops")}, deconvs=deconvs)
    # deconv2 alone, the row kept comparable with earlier runs
    dec = out["deconv_int8_b32"] = deconvs["deconv_32x32_256_256"]
    # the bf16 epilogue at the same shapes
    bf16 = {f"deconv_{H}x{H}_{c_in}_{c_out}": deconv_times(
        B, H, c_in, c_out, bw, int8_ops, torch.bfloat16)
        for B, H, _, c_in, c_out in DECONV_CHECKS[:3]}
    out["deconv_int8_bf16_request_b32"] = dict(
        {key: sum(r[key] for r in bf16.values())
         for key in ("ms", "plain_ms", "bound_ms", "library_ms", "bytes",
                     "ops")}, deconvs=bf16)
    dec16 = out["deconv_int8_bf16_b32"] = bf16["deconv_32x32_256_256"]
    emit(out)
    return {"int8_gemm": gemm[32], "deconv_int8": dec,
            "deconv_int8_bf16": dec16}


def gemm_request(pred_q, img, bw, int8_ops):
    """The int8 GEMM at every distinct shape of one request on ``img``,
    each held equal to its plain version, then timed and summed over the
    request's GEMMs.  B is passed as a QuantConv
    passes it, the transposed view of a contiguous (N, K) weight, which
    the wrapper takes without a copy.  The library call is torch._int_mm
    on a contiguous (K, N) B, with K padded by zeros to a multiple of 8
    (the same products)."""
    shapes = gemm_shapes(pred_q, img)
    per_shape = {}
    for M, K, N in sorted(set(shapes)):
        def gemm_args(M=M, K=K, N=N):
            return int8_codes((M, K), M + K), int8_codes((N, K), N).t()
        a, b = gemm_args()
        if not torch.equal(int8_cuda.int8_matmul_cuda(a, b),
                           int8.int8_matmul(a, b)):
            raise AssertionError(f"int8 GEMM disagrees with its plain "
                                 f"version at {M}x{K}x{N}")
        del a, b
        r = kernel_times(int8_cuda.int8_matmul_cuda, int8.int8_matmul,
                         gemm_args, M * K + K * N + 4 * M * N, 2 * M * K * N,
                         bw, int8_ops)
        r["equal_plain"] = True
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


def deconv_times(B, H, c_in, c_out, bw, int8_ops, out_dtype=torch.float32):
    """The int8 deconv at one decoder shape, writing ``out_dtype``; its
    library call is cuDNN's float32 conv_transpose2d (TF32 off) on the
    int8 values, times the scale (then rounded to ``out_dtype``): exact
    where cuDNN sums directly and every partial sum is an integer below
    2**24 (C_in = 256: 4 * 256 * 127**2 < 2**24; deconv0's C_in = 512 can
    pass it), so its error is recorded."""
    def dec_args():
        return deconv_args(B, H, c_in, c_out)

    def kernel(xq, wq, scale):
        return int8_cuda.deconv4x4s2_int8_cuda(xq, wq, scale, out_dtype)

    def plain(xq, wq, scale):
        return int8.deconv4x4s2_int8(xq, wq, scale, out_dtype)
    out_bytes = torch.empty((), dtype=out_dtype).element_size()
    nbytes = B * H * H * c_in + 16 * c_in * c_out + 4 * c_out \
        + out_bytes * B * c_out * 4 * H * H
    dec = kernel_times(kernel, plain, dec_args, nbytes,
                       2 * 16 * B * H * H * c_in * c_out, bw, int8_ops)

    def lib_args():
        xq, wq, scale = dec_args()
        return (xq.permute(0, 3, 1, 2).float().contiguous(), wq.float(),
                scale.view(1, -1, 1, 1))

    def lib(x, w, scale):
        return (F.conv_transpose2d(x, w, stride=2, padding=1)
                * scale).to(out_dtype)
    dec["library_max_abs_err"] = float(
        (lib(*lib_args()).float() - kernel(*dec_args()).float()).abs().max())
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
    summed over ``steps`` calls, beside their wall time; with
    ``groups``, also by group of kernel names (the rest under
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


def render_flip1(center, jt, paras, shape):
    """A depth frame of a camera without NYU's y flip: the renderer
    projects with NYU's, so it gets y mirrored."""
    m = np.array([1.0, -1.0, 1.0])
    return render_hand_depth(center * m, jt * m, paras, shape)


def random_hand(g, n_joints, depth, spread, z_spread):
    center = np.array([g.uniform(-40, 40), g.uniform(-30, 30),
                       g.uniform(*depth)])
    jt = center[None] + g.uniform(-spread, spread, (n_joints, 3))
    jt[:, 2] = center[2] + g.uniform(-z_spread, z_spread, n_joints)
    return center, jt


def write_pngs(jobs):
    """Render and write ``(path, render, as_rgb)`` jobs on 8 threads (the
    compressor drops the GIL); returns {path: uint16 depth}.  Each PNG's
    rows cycle through the five filter types."""
    from concurrent.futures import ThreadPoolExecutor

    def write(job):
        path, render, as_rgb = job
        depth = render().astype(np.uint16)
        if as_rgb:  # NYU: blue = depth % 256, green = depth // 256
            img = np.zeros((*depth.shape, 3), np.uint8)
            img[..., 1] = depth // 256
            img[..., 2] = depth % 256
        else:
            img = depth
        png.write_png(path, img, filters=png.FILTERS)
        return path, depth

    with ThreadPoolExecutor(8) as pool:
        return dict(pool.map(write, jobs))


def write_nyu_fixture(root, n_train, n_test, seed=SEED):
    """NYU's layout (reference nyu_loader.py:71-90; the recipe of
    tests/test_nyu_files.py): <root>/{train,test}/depth_1_*.png rendered
    from the 14 joints that the 36-joint labels select,
    ``joint_data.mat`` (scipy), ``center_{train,test}_refined.txt``.
    Returns {path: uint16 depth}."""
    import scipy.io as sio

    g = np.random.RandomState(seed)
    jobs = []
    for phase, n in (("train", n_train), ("test", n_test)):
        d = os.path.join(root, phase)
        os.makedirs(d)
        xyz36, centers = np.zeros((n, 36, 3)), np.zeros((n, 3))
        for i in range(n):
            center, jt = random_hand(g, 36, (700, 900), 60, 40)
            xyz36[i], centers[i] = jt, center
            jobs.append((os.path.join(d, f"depth_1_{i:07d}.png"),
                         lambda c=center, j=jt: render_hand_depth(
                             c, j[JOINT_SELECT][EVAL_SELECT], NYU_PARAS),
                         True))
        sio.savemat(os.path.join(d, "joint_data.mat"), {
            "joint_uvd": xyz2uvd_np(xyz36, NYU_PARAS, NYU_FLIP)[None],
            "joint_xyz": xyz36[None]})
        np.savetxt(os.path.join(root, f"center_{phase}_refined.txt"),
                   centers)
    return write_pngs(jobs)


def write_small_fixtures(root, n, seed=SEED):
    """ICVL (16-bit PNGs, uvd labels, refined centers), MSRA (bbox-packed
    .bin frames, test subject P0) and HANDS17 (16-bit PNGs, xyz
    annotation) layouts of ``n`` test frames each, as the loaders'
    docstrings give them; MSRA and HANDS17 without refined centers.
    Returns {dataset: directory}."""
    import struct

    g = np.random.RandomState(seed + 1)
    dirs = {k: os.path.join(root, k) for k in ("icvl", "msra", "hands17")}
    icvl = DATASET_PARAS["icvl"]
    os.makedirs(os.path.join(dirs["icvl"], "Depth", "seq"))
    jobs, lines, centers = [], [], []
    for i in range(n):
        center, jt = random_hand(g, 16, (350, 450), 40, 25)
        rel = f"seq/test_{i}.png"
        jobs.append((os.path.join(dirs["icvl"], "Depth", rel),
                     lambda c=center, j=jt: render_flip1(c, j, icvl,
                                                         (240, 320)),
                     False))
        lines.append(rel + " " + " ".join(
            f"{v:.3f}" for v in xyz2uvd_np(jt, icvl, 1).reshape(-1)))
        centers.append(center)
    with open(os.path.join(dirs["icvl"], "labels_test.txt"), "w") as fh:
        fh.write("\n".join(lines))
    np.savetxt(os.path.join(dirs["icvl"], "center_test_refined.txt"),
               np.asarray(centers))

    msra = DATASET_PARAS["msra"]
    for subject, count in (("P0", n), ("P1", 2)):
        gdir = os.path.join(dirs["msra"], subject, "1")
        os.makedirs(gdir)
        joints = []
        for i in range(count):
            center, jt = random_hand(g, 21, (350, 450), 35, 25)
            depth = render_flip1(center, jt, msra, (240, 320))
            ys, xs = np.nonzero(depth > 0)
            top, bottom, left, right = (ys.min(), ys.max() + 1, xs.min(),
                                        xs.max() + 1)
            with open(os.path.join(gdir, f"{i:06d}_depth.bin"), "wb") as fh:
                fh.write(struct.pack("<6i", 320, 240, left, top, right,
                                     bottom))
                fh.write(depth[top:bottom, left:right].astype(
                    np.float32).tobytes())
            raw = jt.copy()
            raw[:, 2] *= -1  # the raw files store negative z
            joints.append(raw.reshape(-1))
        with open(os.path.join(gdir, "joint.txt"), "w") as fh:
            fh.write(f"{count}\n")
            np.savetxt(fh, np.asarray(joints))

    os.makedirs(os.path.join(dirs["hands17"], "images"))
    lines = []
    for i in range(n):
        center, jt = random_hand(g, 21, (450, 600), 45, 30)
        name = f"image_D{i:08d}.png"
        jobs.append((os.path.join(dirs["hands17"], "images", name),
                     lambda c=center, j=jt: render_flip1(
                         c, j, HANDS17_PARAS, (480, 640)), False))
        lines.append(name + "\t" + "\t".join(f"{v:.6f}"
                                              for v in jt.reshape(-1)))
    with open(os.path.join(dirs["hands17"], "Training_Annotation.txt"),
              "w") as fh:
        fh.write("\n".join(lines))
    write_pngs(jobs)
    return dirs


def check_decoder(depths):
    """Every frame decoded by the C++ unfilter and by the plain one
    (stacked): bit-equal to each other and to the encoded depth; ms a
    frame of the file read + inflate, the C++ unfilter and fold, and the
    plain unfilter and fold."""
    paths = sorted(depths)
    n = len(paths)
    t0 = time.perf_counter()
    cpp = [native_decode.decode_depth_png(p, "nyu") for p in paths]
    decode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    inflated = [png.inflate_depth_png(p, "nyu") for p in paths]
    inflate_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for rows, width, bpp in inflated:
        native_decode.unfilter_depth(rows, width, bpp)
    unfilter_s = time.perf_counter() - t0
    rows = np.stack([r for r, _, _ in inflated])
    bpp = inflated[0][2]
    del inflated
    t0 = time.perf_counter()
    plain = png.fold_depth(png.unfilter_plain(rows, bpp), bpp)
    plain_s = time.perf_counter() - t0
    out = {"frames": n, "bytes_per_pixel": bpp,
           "filters": sorted(np.unique(rows[:, :, 0]).tolist()),
           "cpp_decode_ms_per_frame": decode_s / n * 1e3,
           "read_inflate_ms_per_frame": inflate_s / n * 1e3,
           "cpp_unfilter_fold_ms_per_frame": unfilter_s / n * 1e3,
           "plain_unfilter_fold_ms_per_frame_stacked": plain_s / n * 1e3,
           "cpp_equals_plain": all(np.array_equal(c, q)
                                   for c, q in zip(cpp, plain)),
           "cpp_equals_encoded": all(
               np.array_equal(c, depths[p].astype(np.float32))
               for c, p in zip(cpp, paths))}
    if not (out["cpp_equals_plain"] and out["cpp_equals_encoded"]
            and out["filters"] == list(png.FILTERS)):
        raise AssertionError(f"decoder: {out}")
    return out


def item_times(nyu):
    """ms a ``NYUDataset`` item on one thread: train (host, augmented),
    test (host), and a raw item (the decode alone)."""
    out = {}
    for name, ds in (("train_host", NYUDataset(nyu, "train")),
                     ("test_host", NYUDataset(nyu, "test")),
                     ("train_raw", NYUDataset(nyu, "train", mode="raw"))):
        ds[0]
        t0 = time.perf_counter()
        for i in range(ITEM_TIMING_FRAMES):
            ds[i % len(ds)]
        out[f"{name}_ms"] = ((time.perf_counter() - t0)
                             / ITEM_TIMING_FRAMES * 1e3)
    return out


def train_on_fixture(nyu, root, mode):
    """The training CLI on the NYU directory in ``mode``: exact launch
    counts, epoch 2's train frames/s, epoch 3's idle share."""
    steps = -(-NYU_TRAIN_FRAMES // TRAIN_BATCH)
    evals = -(-NYU_TEST_FRAMES // TRAIN_BATCH)
    argv = ["--dataset", "nyu", "--data-dir", nyu, "--net", "hourglass_1",
            "--batch-size", str(TRAIN_BATCH), "--data-mode", mode,
            "--output-dir", os.path.join(root, f"train_{mode}"),
            "--epochs", str(DATASET_EPOCHS), "--device", "cuda"]
    with trainer_marks(profile_epoch=DATASET_EPOCHS) as marks:
        reset_counts()
        t0 = time.perf_counter()
        tr = train_cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = counts()
    check_launches(f"datasets train {mode}", got, {
        "encode": DATASET_EPOCHS * (steps + evals),
        "decode": DATASET_EPOCHS * (steps + evals),
        "decode_backward": DATASET_EPOCHS * steps})
    if tr.train_data.mode != mode:
        raise AssertionError(f"trained in {tr.train_data.mode} mode")
    t_train = {e: marks["test_start"][e] - marks["save_end"][e - 1]
               for e in (2, 3)}
    win = (marks["save_end"][1], marks["test_start"][2])
    waits = in_window(marks["wait"], *win)
    stages = in_window(marks["stage"], *win)
    busy = busy_ms(marks["profile"])
    run = {"launches": got, "wall_s": wall,
           "warm_epoch_train_s": t_train[2],
           "train_fps": NYU_TRAIN_FRAMES / t_train[2],
           "loop_waits_for_batches_s": sum(waits),
           "staging_s_per_batch": float(np.mean(stages)) if stages else None,
           "profiled_epoch_train_s": t_train[3],
           "profiled_epoch_busy_ms": busy,
           "idle_share": 1.0 - busy / (t_train[3] * 1e3),
           "device_gaps": device_gaps(marks["profile"]),
           "test_mpe": marks["tests"][-1][1],
           "checkpoint": os.path.join(tr.work_dir, "ckpt",
                                      f"{DATASET_EPOCHS}.pth")}
    return run


def phase_datasets():
    """Real-dataset layouts on disk through the port's loaders and CLIs
    (see the module's docstring).  Returns each path's launch counts."""
    out = {"phase": "datasets", "net": "hourglass_1", "batch": TRAIN_BATCH,
           "train_frames": NYU_TRAIN_FRAMES, "test_frames": NYU_TEST_FRAMES,
           "cpu_count": os.cpu_count()}
    launches = {}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        nyu = os.path.join(root, "nyu")
        depths = write_nyu_fixture(nyu, NYU_TRAIN_FRAMES, NYU_TEST_FRAMES)
        small = write_small_fixtures(root, SMALL_FRAMES)
        out["fixtures_s"] = time.perf_counter() - t0
        out["decoder"] = check_decoder(depths)
        del depths
        out["items"] = item_times(nyu)

        runs = {}
        for mode in ("host", "raw"):
            runs[mode] = train_on_fixture(nyu, root, mode)
            launches[f"datasets_train_{mode}"] = runs[mode]["launches"]
        out["train"] = runs
        out["host_fps_over_raw"] = (runs["host"]["train_fps"]
                                    / runs["raw"]["train_fps"])

        out["evaluate"] = {}
        for trained, run in runs.items():
            mpe = {}
            for mode in ("host", "raw"):
                mpe[mode] = evaluate_cli.main([
                    "--dataset", "nyu", "--data-dir", nyu, "--net",
                    "hourglass_1", "--batch-size", str(TRAIN_BATCH),
                    "--data-mode", mode, "--load-model", run["checkpoint"],
                    "--output-dir", os.path.join(root, f"eval_{trained}_"
                                                 f"{mode}"),
                    "--device", "cuda"])
            res = {"host_mpe": mpe["host"], "raw_mpe": mpe["raw"],
                   "abs_diff_mm": abs(mpe["host"] - mpe["raw"]),
                   "atol_mm": HOST_RAW_MPE_ATOL}
            out["evaluate"][f"trained_{trained}"] = res
            if not res["abs_diff_mm"] <= HOST_RAW_MPE_ATOL:
                raise AssertionError(f"host against raw MPE: {res}")

        out["small_datasets"] = {}
        for name, root_dir in small.items():
            reset_counts()
            mpe = evaluate_cli.main(
                ["--dataset", name, "--data-dir", root_dir, "--net",
                 "hourglass_1", "--batch-size", str(TRAIN_BATCH),
                 "--output-dir", os.path.join(root, f"eval_{name}"),
                 "--device", "cuda"]
                + (["--allow-centroid-centers"] if name != "icvl" else []))
            torch.cuda.synchronize()
            got = counts()
            check_launches(f"datasets evaluate {name}", got,
                           {"encode": 1, "decode": 1})
            launches[f"datasets_eval_{name}"] = got
            out["small_datasets"][name] = {
                "joints": {"icvl": 16}.get(name, 21), "frames": SMALL_FRAMES,
                "test_mpe": mpe, "launches": got}
            if not np.isfinite(mpe):
                raise AssertionError(f"{name}: MPE {mpe}")
    emit(out)
    return launches


def request_times(pred, fp32, frames, centers, crops):
    """``pred``'s request time and peak memory at each of BF16_BATCHES,
    and the device time of its forward and decode at the bucket
    ``predict`` pads the batch to, beside ``fp32``'s."""
    out = {}
    for B in BF16_BATCHES:
        f = np.resize(frames, (B,) + frames.shape[1:])
        c = np.resize(centers, (B, 3))
        torch.cuda.reset_peak_memory_stats()
        ms = predict_ms(pred, f, c, {1: 20, 32: 10, 256: 5}[B])["median"]
        bucket = pred._bucket(B)
        img = torch.from_numpy(np.resize(crops, (bucket,) + crops.shape[1:]))
        out[f"b{B}"] = {"predict_ms": ms, "predict_fps": B / ms * 1e3,
                        "device_batch": bucket,
                        "peak_memory_gb": torch.cuda.max_memory_allocated()
                        / 1e9,
                        "device_ms": device_ms(pred._infer, [(img.cuda(),)],
                                               10),
                        "fp32_device_ms": device_ms(fp32._infer,
                                                    [(img.cuda(),)], 10)}
    return out


def bf16_serving(cfg, sd, frames, centers, quantize=False):
    """A bf16 Predictor (int8 with ``quantize``) of the float32 state
    ``sd`` against a float32 one: requests at SERVE_BATCHES with exact
    launch counts, the joints' drift from float32 on the crops of the
    frames, and request and device times at BF16_BATCHES."""
    name = f"bf16_serve_{cfg.net}" + ("_int8" if quantize else "")
    fp32 = Predictor(cfg, sd, device="cuda")
    pred = Predictor(cfg.replace(compute_dtype="bfloat16"), sd, device="cuda")
    crops = normalized_crops(cfg, frames, centers)
    want = {"decode": 1}
    if quantize:
        pred.quantize(crops)
        want.update(int8_gemm=20, deconv_int8_bf16=3)
    elif cfg.net == "resnet_18":
        # the inference form: 16 block convs and 3 deconvs take bias_relu
        want.update(stem_pool=1, bias_relu=19, head_out=1)
    if pred._folded != (cfg.net == "resnet_18" and not quantize):
        raise AssertionError(f"{name}: inference form {pred._folded}")
    reset_counts()
    outs = {B: pred.predict(frames[:B], centers[:B]) for B in SERVE_BATCHES}
    torch.cuda.synchronize()
    launches = counts()
    check_launches(name, launches,
                   {k: n * len(outs) for k, n in want.items()})
    for B, o in outs.items():
        if o.shape != (B, cfg.jt_num, 3) or not np.isfinite(o).all():
            raise AssertionError(f"{name} batch {B}: bad output")
    got, ref = pred.predict_normalized(crops), fp32.predict_normalized(crops)
    out = {"launches": launches,
           "drift_vs_fp32_max": float(np.abs(got - ref).max()),
           "drift_vs_fp32_mean": float(np.abs(got - ref).mean()),
           "drift_bar": BF16_DRIFT_MAX}
    out.update(request_times(pred, fp32, frames, centers, crops))
    if not out["drift_vs_fp32_max"] < BF16_DRIFT_MAX:
        raise AssertionError(f"{name}: joints drift {out} from float32")
    return name, out


def bf16_train_step(cfg, frames, joints, centers):
    """K raw bf16 train steps at B = 32 with exact launch counts, then the
    step's device time, beside the float32 step's from the same weights.
    Returns the record and each dtype's step with its arguments."""
    raw, p = raw_inputs(cfg, frames, joints, centers, "cuda")
    B = len(frames)
    aug = draw_augment_params(torch.Generator("cuda").manual_seed(SEED + 6),
                              B, *cfg.augment_para)
    out, steps = {}, {}
    for dtype in ("float32", "bfloat16"):
        model = build_model(cfg.net, cfg.jt_num, cfg.downsample,
                            compute_dtype=DTYPES[dtype])
        torch_default_init_(model, torch.Generator().manual_seed(SEED))
        model.cuda()
        step = make_raw_train_step(
            model, make_optimizer(model.parameters(), cfg.optimizer, cfg.lr),
            cfg, cfg.paras, cfg.flip)
        if dtype == "bfloat16":
            gen = torch.Generator("cuda").manual_seed(SEED)
            reset_counts()
            losses = [float(step(raw, p, draw_augment_params(
                gen, B, *cfg.augment_para))["loss"])
                for _ in range(BF16_TRAIN_STEPS)]
            torch.cuda.synchronize()
            out["launches"] = counts()
            check_launches(f"bf16_train_{cfg.net}", out["launches"], {
                k: BF16_TRAIN_STEPS for k in ("encode", "decode",
                                              "decode_backward")})
            if not all(np.isfinite(losses)):
                raise AssertionError(f"bf16 {cfg.net} loss: {losses}")
            out.update(loss_first=losses[0], loss_last=losses[-1])
        steps[dtype] = (step, (raw, p, aug))
        ms = device_ms(step, [(raw, p, aug)], 10)
        out[f"{dtype}_step_ms_b{B}"] = ms
        out[f"{dtype}_train_fps_b{B}"] = B / ms * 1e3
    return out, steps


def bf16_trainer():
    """The train CLI in bf16 (hourglass_1, ``--synthetic --data-mode
    raw``, B = 32) for BF16_TRAINER_EPOCHS epochs: exact launch counts,
    the second epoch's train frames/s, the third's idle share."""
    steps = -(-TRAINER_FRAMES // TRAIN_BATCH)
    evals = -(-TRAINER_TEST_FRAMES // TRAIN_BATCH)
    epochs = BF16_TRAINER_EPOCHS
    with tempfile.TemporaryDirectory() as root:
        argv = ["--net", "hourglass_1", "--synthetic", "--data-mode", "raw",
                "--synthetic-size", str(TRAINER_FRAMES),
                "--synthetic-test-size", str(TRAINER_TEST_FRAMES),
                "--batch-size", str(TRAIN_BATCH), "--output-dir", root,
                "--compute-dtype", "bfloat16", "--epochs", str(epochs),
                "--device", "cuda"]
        with trainer_marks(profile_epoch=epochs) as marks:
            reset_counts()
            tr = train_cli.main(argv)
            torch.cuda.synchronize()
            got = counts()
    check_launches("bf16_trainer", got, {
        "encode": epochs * (steps + evals), "decode": epochs * (steps + evals),
        "decode_backward": epochs * steps})
    if tr.model.compute_dtype != torch.bfloat16:
        raise AssertionError("the bf16 Trainer's model is not bf16")
    t_train = {e: marks["test_start"][e] - marks["save_end"][e - 1]
               for e in (epochs - 1, epochs)}
    busy = busy_ms(marks["profile"])
    return {"launches": got, "train_frames": TRAINER_FRAMES,
            "warm_epoch_train_s": t_train[epochs - 1],
            "train_fps": TRAINER_FRAMES / t_train[epochs - 1],
            "profiled_epoch_train_s": t_train[epochs],
            "profiled_epoch_busy_ms": busy,
            "idle_share": 1.0 - busy / (t_train[epochs] * 1e3),
            "device_gaps": device_gaps(marks["profile"]),
            "test_mpe": marks["tests"][-1][1]}


def phase_bf16(frames, joints, centers):
    """bfloat16 compute at full width: hourglass_1 and resnet_18 serving,
    resnet_18 int8 serving under bf16 (the bf16 deconv epilogue), the raw
    train step of each, and the bf16 Trainer; each path's joints against
    float32 ones of the same seeded weights, randomized BatchNorm.
    Returns each path's launch counts and the train steps, by net and
    dtype, with their arguments."""
    out = {"phase": "bf16", "batches": list(BF16_BATCHES)}
    launches = {}
    for cfg in (hourglass_config(), resnet_config()):
        model = build_model(cfg.net, cfg.jt_num, cfg.downsample)
        torch_default_init_(model, torch.Generator().manual_seed(SEED))
        sd = randomize_batch_norm_(model).state_dict()
        paths = [False] + ([True] if cfg.net.startswith("resnet") else [])
        for quantize in paths:
            name, res = bf16_serving(cfg, sd, frames, centers, quantize)
            launches[name] = res["launches"]
            out[name] = res
    steps = {}
    for cfg in (hourglass_config(coord_weight=0.1),
                resnet_config(coord_weight=0.1)):
        res, steps[cfg.net] = bf16_train_step(cfg, frames, joints, centers)
        launches[f"bf16_train_{cfg.net}"] = res["launches"]
        out[f"train_{cfg.net}"] = res
    out["trainer"] = bf16_trainer()
    launches["bf16_trainer"] = out["trainer"]["launches"]
    emit(out)
    return launches, steps


def hourglass_int8(cfg, sd, crops, frames, centers):
    """An int8 hourglass_1 Predictor in ``cfg``'s compute dtype, quantized
    on ``crops``: requests at SERVE_BATCHES with exact launch counts (55
    int8 GEMMs and one decode each), a contiguous map, the joints' drift
    from a float32 Predictor of the same weights, request and device
    times at BF16_BATCHES and the peak memory of a B = 256 request."""
    pred = Predictor(cfg, sd, device="cuda")
    fp32 = Predictor(cfg.replace(compute_dtype="float32"), sd, device="cuda")
    reset_counts()
    pred.quantize(crops)
    torch.cuda.synchronize()
    check_launches("calibrate hourglass_1", counts(), {})
    reset_counts()
    outs = {B: pred.predict(frames[:B], centers[:B]) for B in SERVE_BATCHES}
    torch.cuda.synchronize()
    launches = counts()
    n = len(outs)
    for B, o in outs.items():
        if o.shape != (B, cfg.jt_num, 3) or not np.isfinite(o).all():
            raise AssertionError(f"int8 hourglass batch {B}: bad output")
    with torch.no_grad():
        maps = pred.model(torch.from_numpy(crops[:8]).cuda()[:, None])
    got, ref = pred.predict_normalized(crops), fp32.predict_normalized(crops)
    out = {"compute_dtype": cfg.compute_dtype, "launches": launches,
           "quant_layers": len(pred.quant),
           "map_contiguous": bool(maps.is_contiguous()),
           "drift_vs_fp32_max": float(np.abs(got - ref).max()),
           "drift_vs_fp32_mean": float(np.abs(got - ref).mean()),
           "drift_bar": INT8_DRIFT_MAX}
    check_launches(f"serve_hourglass_int8 {cfg.compute_dtype}", launches,
                   {"int8_gemm": HG_INT8_GEMMS * n, "decode": n})
    if len(pred.quant) != HG_INT8_GEMMS or not out["map_contiguous"]:
        raise AssertionError(f"int8 hourglass: {out}")
    if not out["drift_vs_fp32_max"] < INT8_DRIFT_MAX:
        raise AssertionError(f"int8 hourglass joints drift: {out}")
    out.update(request_times(pred, fp32, frames, centers, crops))
    return pred, out


def int8_vs_cpu(pred, crops, plant=False):
    """The int8 Predictor ``pred`` on the card against an int8 Predictor
    on the CPU with the same weights and scales, on INT8_CPU_CROPS of
    ``crops``: each quantized layer on the card's own input against the
    CPU layer on that input (max |diff| over max |CPU output|, the worst
    layer's), and the normalized joints end to end.  With ``plant``, the
    same readings with one layer's activation scale doubled on the card,
    for the first, the middle and the last quantized layer in turn: what
    a layer served at a wrong scale reads."""
    img = crops[:INT8_CPU_CROPS]
    cfg = pred.cfg
    cpu = Predictor(cfg, pred.model.state_dict(), device="cpu")
    cpu.quant = {k: v.cpu() for k, v in pred.quant.items()}
    cpu._switch_int8()
    want = cpu.predict_normalized(img)
    card_layers, cpu_layers = quant_layers(pred.model), quant_layers(
        cpu.model)
    x = torch.from_numpy(img).cuda()[:, None]

    def layer_errs(names):
        seen = {}
        hooks = [card_layers[n].register_forward_hook(
            lambda m, a, y, n=n: seen.__setitem__(n, (a[0].cpu(), y.cpu())))
            for n in names]
        try:
            with torch.no_grad():
                pred.model(x)
                return {n: rel_to_max(y.float(), cpu_layers[n](a).float())
                        for n, (a, y) in seen.items()}
        finally:
            for h in hooks:
                h.remove()

    def joint_errs():
        d = np.abs(pred.predict_normalized(img) - want)
        return float(d.max()), float(d.mean())

    errs = layer_errs(list(card_layers))
    worst = max(errs, key=errs.get)
    out = {"crops": len(img), "layers": len(errs),
           "layer_rel_to_max": errs[worst], "worst_layer": worst,
           "layer_bar": INT8_LAYER_RTOL_OF_MAX,
           "atol": (HG_INT8_CPU_ATOL if cfg.net.startswith("hourglass")
                    else INT8_CPU_ATOL)}
    out["joints_max_abs"], out["joints_mean_abs"] = joint_errs()
    if plant:
        names = list(card_layers)
        out["planted"] = {}
        for n in (names[0], names[len(names) // 2], names[-1]):
            scale = card_layers[n].act_scale
            keep = scale.clone()
            scale.mul_(2.0)
            try:
                r = {"layer_rel_to_max": layer_errs([n])[n]}
                r["joints_max_abs"], r["joints_mean_abs"] = joint_errs()
            finally:
                scale.copy_(keep)
            out["planted"][n] = r
    return out


def check_int8_vs_cpu(name, res):
    """Raises unless :func:`int8_vs_cpu`'s readings are within its bars
    and every planted fault reads above the layer bar."""
    if not (res["layer_rel_to_max"] <= res["layer_bar"]
            and res["joints_max_abs"] <= res["atol"]):
        raise AssertionError(f"{name}: the card disagrees with the CPU: "
                             f"{res}")
    blind = {n: r for n, r in res.get("planted", {}).items()
             if not r["layer_rel_to_max"] > res["layer_bar"]}
    if blind:
        raise AssertionError(f"{name}: planted faults read within the "
                             f"layer bar: {blind}")


def phase_serve_hourglass_int8(frames, centers, bw, int8_ops):
    """int8 hourglass_1 serving at full width (55 quantized convs: the
    stem, every residual conv and skip, ``feature_conv``; the heads and
    merges float), float32 and bf16 compute: :func:`hourglass_int8`; each
    Predictor against an int8 one on the CPU with the card's scales, with
    planted faults (:func:`int8_vs_cpu`); the int8 GEMM at B = 256's stem
    shape against its plain version; the 55 GEMMs of a B = 32 request,
    each shape held against its plain version and timed against its
    bound."""
    cfg = hourglass_config()
    model = build_model(cfg.net, cfg.jt_num)
    torch_default_init_(model, torch.Generator().manual_seed(SEED))
    sd = randomize_batch_norm_(model).state_dict()
    crops = normalized_crops(cfg, frames, centers)
    out = {"phase": "serve_hourglass_int8", "net": cfg.net,
           "img_size": cfg.img_size, "requests": list(SERVE_BATCHES)}
    launches = {}
    preds = {}
    for dtype in ("float32", "bfloat16"):
        name = ("serve_hourglass_int8" if dtype == "float32"
                else "bf16_serve_hourglass_int8")
        preds[dtype], out[dtype] = hourglass_int8(
            cfg.replace(compute_dtype=dtype), sd, crops, frames, centers)
        launches[name] = out[dtype]["launches"]
        out[dtype]["vs_cpu"] = int8_vs_cpu(preds[dtype], crops, plant=True)
    pred = preds["float32"]

    M, K, N = HG_STEM_GEMM_B256
    a, b = int8_codes((M, K), M), int8_codes((N, K), N).t()
    got = int8_cuda.int8_matmul_cuda(a, b)
    torch.cuda.synchronize()
    want = int8.int8_matmul(a, b)
    out["stem_gemm_b256"] = {"shape": [M, K, N], "m_times_k": M * K,
                             "plan": int8_cuda.gemm_plan(M, K, N)._asdict(),
                             "equal_plain": bool(torch.equal(got, want))}
    del a, b, got, want
    out["int8_gemm_request_b32"] = gemm_request(
        pred, torch.from_numpy(crops).cuda(), bw, int8_ops)
    emit(out)
    if not out["stem_gemm_b256"]["equal_plain"]:
        raise AssertionError("int8 GEMM disagrees at the B = 256 stem shape")
    for dtype in preds:
        check_int8_vs_cpu(f"int8 hourglass_1 {dtype}", out[dtype]["vs_cpu"])
    phase_profile("serve_hourglass_int8 forward + decode, B = 32",
                  pred._infer, (torch.from_numpy(crops).cuda(),),
                  groups=INT8_GROUPS)
    return launches


def labeled_batches(n, phase, seed):
    """``n`` host-mode (img, jt_uvd) batches of TRAIN_BATCH grid-layout
    synthetic frames (every joint visible)."""
    ds = SyntheticHandDataset(n * TRAIN_BATCH, 14, 128, phase=phase,
                              seed=seed, layout="grid")
    return qat.batches_from_dataset(ds, TRAIN_BATCH, n)


def qat_vs_int8(cfg, model, img):
    """Mode "qat" against mode "int8" of the int8 ``model`` in eval on
    ``img``, both forwards run with TF32 on globally: the last stack's
    map (max |diff| over max |int8 map|) and the decoded joints; and each
    QAT conv's output against the same forward's with TF32 off (the float
    heads after them do take TF32 when it is on).  Leaves the model in
    "int8" and TF32 off."""
    maps, conv_out, out = {}, {}, {}
    hooks = [m.register_forward_hook(
        lambda m, a, y, n=n: conv_out.setdefault(n, []).append(y))
        for n, m in quant_layers(model).items()]
    torch.backends.cudnn.allow_tf32 = True
    try:
        with torch.no_grad():
            maps["int8"] = model(img[:, None])
            conv_out.clear()
            set_quant_mode(model, "qat")
            maps["qat"] = model(img[:, None])
            out["tf32_on_after_qat_forward"] = torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = False
    with torch.no_grad():
        model(img[:, None])
    for h in hooks:
        h.remove()
    set_quant_mode(model, "int8")
    last = {k: v if v.dim() == 4 else v[-1] for k, v in maps.items()}
    q8, fq = last["int8"], last["qat"]
    k = cfg.kernel_size
    out.update(
        map_rel_to_max=rel_to_max(fq, q8),
        joints_max_abs=float((decode_offsets(fq, img, k)
                              - decode_offsets(q8, img, k)).abs().max()),
        map_bar=QAT_MAP_RTOL_OF_MAX, joint_bar=QAT_JOINT_ATOL,
        qat_convs_tf32_on_vs_off_rel_to_max=max(
            rel_to_max(on, off) for on, off in conv_out.values()),
        tf32_bar=QAT_TF32_RTOL_OF_MAX)
    return out


def check_qat_family(name, res):
    """Raises unless :func:`qat_family`'s readings are within their
    bars."""
    q = res["qat_vs_int8"]
    if not (q["map_rel_to_max"] < q["map_bar"]
            and q["joints_max_abs"] < q["joint_bar"]
            and q["qat_convs_tf32_on_vs_off_rel_to_max"] <= q["tf32_bar"]
            and q["tf32_on_after_qat_forward"]):
        raise AssertionError(f"{name}: QAT forward: {q}")
    if not (res["ruinous"]["fell_back"] and res["ruinous"]["bit_equal"]):
        raise AssertionError(f"{name}: ruinous lr kept: {res['ruinous']}")
    check_int8_vs_cpu(f"{name}: int8 after QAT",
                      res["int8_after_qat_vs_cpu"])


def qat_family(cfg, sd, crops, tune, holdout):
    """``Predictor.quantize`` then ``quantize_qat`` of one family on the
    card with exact launch counts; the int8 Predictor after QAT against
    the CPU; the QAT step's device time beside the float32 step's; the
    ruinous-lr fallback, bit-equal; before the fine-tune, the QAT forward
    against the int8 forward with TF32 on globally (:func:`qat_vs_int8`).
    :func:`check_qat_family` holds the readings to their bars."""
    name = f"qat_{cfg.net}"
    pred = Predictor(cfg, sd, device="cuda")
    pred.quantize(crops)
    qat_int8 = qat_vs_int8(cfg, pred.model, torch.from_numpy(crops).cuda())
    gemms = sum(isinstance(m, QuantConv)
                for m in quant_layers(pred.model).values())
    deconvs = len(pred.quant) - gemms
    reset_counts()
    # cuDNN's deterministic algorithms: the fine-tuned weights, and the
    # readings taken on them below, are then the same in every run
    torch.backends.cudnn.deterministic = True
    try:
        losses = pred.quantize_qat(tune, steps=QAT_STEPS, lr=QAT_LR,
                                   holdout_batches=holdout)
    finally:
        torch.backends.cudnn.deterministic = False
    torch.cuda.synchronize()
    launches = counts()
    # QAT steps: one encode, one decode and its backward each (one stack);
    # the holdout: an int8 eval step of each of the two candidates a batch
    evals = 2 * len(holdout)
    check_launches(name, launches, {
        "encode": QAT_STEPS + evals, "decode": QAT_STEPS + evals,
        "decode_backward": QAT_STEPS, "int8_gemm": gemms * evals,
        "deconv_int8": deconvs * evals})
    out = {"qat_vs_int8": qat_int8, "launches": launches,
           "steps": QAT_STEPS, "lr": QAT_LR,
           "loss_first": losses[0], "loss_last": losses[-1],
           "validation": pred.qat_validation}
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{name}: losses {losses}")

    # int8 after QAT, card against CPU with the same weights and scales
    out["int8_after_qat_vs_cpu"] = int8_vs_cpu(pred, crops)

    # device time of one QAT step and one float32 step at B = 32
    batch = {k: torch.from_numpy(v).cuda() for k, v in tune[0].items()}
    for mode in ("qat", "off"):
        model = set_quant_mode(set_int8(copy.deepcopy(pred.model),
                                        pred.quant), mode)
        step = make_train_step(model, make_optimizer(
            model.parameters(), cfg.optimizer, QAT_LR), cfg)
        ms = device_ms(step, [(batch,)], 10)
        out[f"{'qat' if mode == 'qat' else 'float32'}_step_ms_b32"] = ms
        if mode == "qat":
            phase_profile(f"qat step {cfg.net}, B = 32", step, (batch,))

    # the ruinous lr: falls back to the PTQ weights and statistics
    ruin = Predictor(cfg, sd, device="cuda")
    ruin.quantize(crops)
    held = [{"img": b["img"], "jt_uvd": ruin.predict_normalized(b["img"])}
            for b in holdout]
    before = {k: v.clone() for k, v in ruin.model.state_dict().items()}
    ruin.quantize_qat(tune, steps=QAT_STEPS, lr=QAT_RUINOUS_LR,
                      holdout_batches=held)
    after = ruin.model.state_dict()
    out["ruinous"] = dict(ruin.qat_validation, bit_equal=all(
        torch.equal(after[k], v) for k, v in before.items()))
    return name, out


def phase_qat(frames, centers):
    """Quantization-aware fine-tuning of both families at full width
    through ``Predictor.quantize_qat`` (:func:`qat_family`), on labeled
    grid-layout synthetic batches, with a holdout."""
    tune = labeled_batches(QAT_TUNE_BATCHES, "train", SEED)
    holdout = labeled_batches(QAT_HOLDOUT_BATCHES, "test", SEED + 1)
    out = {"phase": "qat", "tune_batches": len(tune),
           "holdout_batches": len(holdout), "batch": TRAIN_BATCH}
    launches = {}
    for cfg in (hourglass_config(coord_weight=0.1), resnet_config()):
        model = build_model(cfg.net, cfg.jt_num, cfg.downsample)
        torch_default_init_(model, torch.Generator().manual_seed(SEED))
        sd = randomize_batch_norm_(model).state_dict()
        crops = normalized_crops(cfg, frames, centers)
        name, res = qat_family(cfg, sd, crops, tune, holdout)
        launches[name] = res["launches"]
        out[cfg.net] = res
    emit(out)
    for cfg in (hourglass_config(), resnet_config()):
        check_qat_family(f"qat_{cfg.net}", out[cfg.net])
    return launches


# The closed-loop clients of the server phase, run in a process of their
# own (stdlib and numpy only): argv port, seconds, threads, frames.npy,
# centers.npy.  Each thread posts one img_b64 frame at a time, on a new
# connection (the server speaks HTTP/1.0); prints {"replies": [[end s,
# latency s, connect s, status]], "t0": start}.
LOAD_CLIENT = r"""
import base64, http.client, json, sys, threading, time
import numpy as np
port, seconds, n = int(sys.argv[1]), float(sys.argv[2]), int(sys.argv[3])
frames, centers = np.load(sys.argv[4]), np.load(sys.argv[5])
bodies = [json.dumps({"img_b64": base64.b64encode(
    np.ascontiguousarray(f, "<f4").tobytes()).decode(),
    "shape": list(f.shape), "center_xyz": c.tolist()}).encode()
    for f, c in zip(frames, centers)]
replies, lock = [], threading.Lock()
t0 = time.perf_counter()
stop = t0 + seconds
def client(k):
    i = k
    while time.perf_counter() < stop:
        t = time.perf_counter()
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        conn.connect()
        t_conn = time.perf_counter() - t
        conn.request("POST", "/predict", bodies[i % len(bodies)],
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        r.read()
        conn.close()
        with lock:
            replies.append((time.perf_counter() - t0,
                            time.perf_counter() - t, t_conn, r.status))
        i += n
threads = [threading.Thread(target=client, args=(k,)) for k in range(n)]
for th in threads:
    th.start()
for th in threads:
    th.join()
print(json.dumps({"replies": replies, "t0": t0}))
"""


def http_json(port, path, obj=None, timeout=120):
    """(status, headers, parsed body) of a GET (``obj`` None) or POST."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        if obj is None:
            conn.request("GET", path)
        else:
            conn.request("POST", path, json.dumps(obj),
                         {"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, dict(r.getheaders()), json.loads(r.read())
    finally:
        conn.close()


def b64(a) -> str:
    return base64.b64encode(np.ascontiguousarray(a, "<f4").tobytes()).decode()


def http_joints(port, path, obj):
    status, _, body = http_json(port, path, obj)
    if status != 200:
        raise AssertionError(f"{path}: {status} {body}")
    return np.asarray(body["joints_uvd"], np.float32)


def async_contract(pred, frames, centers):
    """``predict_async`` at B = SERVER_ASYNC_BATCH: A and then B
    dispatched back to back.  B's dispatch must take under
    SERVER_ASYNC_HOST_SHARE of A's device time, A's ``finalize`` must
    return while B's work still runs, and both must give the joints of a
    blocking ``predict``.  Also times what the port did before: a
    pageable upload of the same frames behind A's work."""
    n = SERVER_ASYNC_BATCH
    reps = -(-n // len(frames))
    imgs = np.tile(frames, (reps, 1, 1))[:n]
    cs = np.tile(centers, (reps, 1))[:n]
    want = pred.predict(imgs, cs)
    for _ in range(2):  # the pinned blocks of two requests in flight
        fa, fb = pred.predict_async(imgs, cs), pred.predict_async(imgs, cs)
        fa(), fb()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    a_end = torch.cuda.Event(enable_timing=True)
    b_end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    fa = pred.predict_async(imgs, cs)
    a_end.record()
    t1 = time.perf_counter()
    fb = pred.predict_async(imgs, cs)
    t2 = time.perf_counter()
    b_end.record()
    out_a = fa()
    t3 = time.perf_counter()
    b_running = not b_end.query()
    out_b = fb()
    t4 = time.perf_counter()
    a_device_ms = start.elapsed_time(a_end)
    # the upload as the port made it before: from pageable memory, behind
    # a request's work on the stream
    padded = np.ascontiguousarray(imgs)
    fa = pred.predict_async(imgs, cs)
    t5 = time.perf_counter()
    torch.from_numpy(padded).to("cuda")
    t6 = time.perf_counter()
    fa()
    res = {"batch": n, "a_device_ms": a_device_ms,
           "a_dispatch_host_ms": (t1 - t0) * 1e3,
           "b_dispatch_host_ms": (t2 - t1) * 1e3,
           "a_finalize_returned_ms": (t3 - t0) * 1e3,
           "b_finalize_returned_ms": (t4 - t0) * 1e3,
           "a_and_b_device_ms": start.elapsed_time(b_end),
           "b_running_when_a_returned": b_running,
           "pageable_upload_behind_a_ms": (t6 - t5) * 1e3,
           "host_share_bar": SERVER_ASYNC_HOST_SHARE,
           "a_equal": bool(np.array_equal(out_a, want)),
           "b_equal": bool(np.array_equal(out_b, want))}
    if not res["b_dispatch_host_ms"] < SERVER_ASYNC_HOST_SHARE * a_device_ms:
        raise AssertionError(f"B's predict_async waited for A: {res}")
    if not b_running:
        raise AssertionError(f"finalize(A) waited for B's work: {res}")
    if not (res["a_equal"] and res["b_equal"]):
        raise AssertionError(f"predict_async joints differ: {res}")
    return res


def server_correctness(pred, frames, centers, want1, want8):
    """/healthz, then /predict and /predict_batch as JSON and base64
    against ``Predictor.predict`` of the same frames; returns the
    server's dispatches and the largest difference."""
    with AWRServer(pred, port=0).start() as srv:
        status, _, h = http_json(srv.port, "/healthz")
        if status != 200 or h["int8"] is not False or h["net"] != "hourglass_1":
            raise AssertionError(f"healthz: {status} {h}")
        got = {
            "predict_json": (http_joints(srv.port, "/predict", {
                "img": frames[0].tolist(),
                "center_xyz": centers[0].tolist()}), want1),
            "predict_b64": (http_joints(srv.port, "/predict", {
                "img_b64": b64(frames[0]), "shape": list(frames[0].shape),
                "center_xyz": centers[0].tolist()}), want1),
            "predict_batch_json": (http_joints(srv.port, "/predict_batch", {
                "imgs": frames[:2].tolist(),
                "centers_xyz": centers[:2].tolist()}), want8[:2]),
            "predict_batch_b64": (http_joints(srv.port, "/predict_batch", {
                "imgs_b64": b64(frames[:8]), "shape": list(frames[:8].shape),
                "centers_xyz": centers[:8].tolist()}), want8),
        }
        err = {k: float(np.abs(g - w).max()) for k, (g, w) in got.items()}
        for k, (g, w) in got.items():
            if g.shape != w.shape or not np.allclose(g, w, rtol=SERVER_RTOL,
                                                     atol=SERVER_ATOL):
                raise AssertionError(f"{k}: HTTP joints differ from "
                                     f"Predictor.predict by {err[k]}")
        return srv.batcher.n_dispatches, err


def host_costs(pred, frames, centers):
    """Host ms, alone on this thread (medians): one single-frame img_b64
    request's JSON and base64 decode, its reply's encoding, and the
    dispatcher's ``predict_async`` of 1 and of 8 frames (bucket 8; its
    ``finalize`` untimed); and the interpreter's switch interval."""
    body = json.dumps({"img_b64": b64(frames[0]),
                       "shape": list(frames.shape[1:]),
                       "center_xyz": centers[0].tolist()}).encode()
    reply = {"joints_uvd": np.zeros((14, 3)).tolist()}

    def parse():
        obj = json.loads(body)
        np.frombuffer(base64.b64decode(obj["img_b64"]),
                      dtype="<f4").reshape(obj["shape"])

    def dispatch_ms(n):
        times = []
        for _ in range(12):
            t = time.perf_counter()
            fin = pred.predict_async(frames[:n], centers[:n])
            times.append((time.perf_counter() - t) * 1e3)
            fin()
        return float(np.median(times[2:]))

    return {"body_bytes": len(body),
            "parse_ms": host_ms(parse, 20),
            "reply_ms": host_ms(lambda: json.dumps(reply).encode(), 20),
            "dispatch_1_ms": dispatch_ms(1), "dispatch_8_ms": dispatch_ms(8),
            "switch_interval_ms": sys.getswitchinterval() * 1e3}


def closed_loop(pred, frames, centers, tmp, clients):
    """``clients`` threads of another process post single img_b64 frames
    for SERVER_LOAD_S; a CUDA profile over SERVER_PROFILE_S of it, with
    this process's CPU time over the same window.  Returns the served
    numbers, the dispatcher's host time a dispatch, and the server's
    dispatches."""
    from torch.profiler import ProfilerActivity, profile

    np.save(os.path.join(tmp, "frames.npy"), frames)
    np.save(os.path.join(tmp, "centers.npy"), centers)
    host_s = []
    dispatch = pred.predict_async

    def timed_dispatch(*a, **kw):
        t = time.perf_counter()
        fin = dispatch(*a, **kw)
        host_s.append(time.perf_counter() - t)
        return fin

    pred.predict_async = timed_dispatch
    try:
        with AWRServer(pred, port=0).start() as srv:
            proc = subprocess.Popen(
                [sys.executable, "-c", LOAD_CLIENT, str(srv.port),
                 str(SERVER_LOAD_S), str(clients),
                 os.path.join(tmp, "frames.npy"),
                 os.path.join(tmp, "centers.npy")],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            try:
                time.sleep(SERVER_PROFILE_AT_S)
                d0, f0 = srv.batcher.n_dispatches, srv.batcher.n_frames
                prof = profile(activities=[ProfilerActivity.CUDA])
                prof.start()
                t0, cpu0 = time.perf_counter(), time.process_time()
                time.sleep(SERVER_PROFILE_S)
                torch.cuda.synchronize()
                window_ms = (time.perf_counter() - t0) * 1e3
                cpu_ms = (time.process_time() - cpu0) * 1e3
                prof.stop()
                d1, f1 = srv.batcher.n_dispatches, srv.batcher.n_frames
                out, err = proc.communicate(timeout=SERVER_LOAD_S + 120)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            if proc.returncode != 0:
                raise AssertionError(f"load clients failed: {err}")
            snap = srv.batcher.service_model.snapshot()
            dispatches = srv.batcher.n_dispatches
    finally:
        del pred.predict_async
    replies = json.loads(out)["replies"]
    codes = sorted({r[3] for r in replies})
    lat = np.array([r[1] for r in replies]) * 1e3
    conn = np.array([r[2] for r in replies]) * 1e3
    span = max(r[0] for r in replies)
    busy = busy_ms(prof)
    device_events = sum(1 for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA)
    res = {"clients": clients, "seconds": SERVER_LOAD_S,
           "replies": len(replies), "status_codes": codes,
           "served_fps": len(replies) / span,
           "p50_ms": float(np.percentile(lat, 50)),
           "p99_ms": float(np.percentile(lat, 99)),
           "connect_p50_ms": float(np.percentile(conn, 50)),
           "connect_p99_ms": float(np.percentile(conn, 99)),
           "connects_over_900ms": int((conn > 900).sum()),
           "window": {"ms": window_ms, "device_busy_ms": busy,
                      "idle_share": 1.0 - busy / window_ms,
                      "process_cpu_share": cpu_ms / window_ms,
                      "dispatches": d1 - d0,
                      "served_fps": (f1 - f0) / (window_ms / 1e3),
                      "frames_per_dispatch": (f1 - f0) / max(d1 - d0, 1),
                      "device_events_per_dispatch":
                          device_events / max(d1 - d0, 1),
                      "gaps": device_gaps(prof)},
           "dispatch_host_ms": {
               "median": float(np.median(host_s) * 1e3),
               "p90": float(np.percentile(host_s, 90) * 1e3),
               "count": len(host_s)},
           "service_model_ms": {f"{b}@{sh[0]}x{sh[1]}": {
               "p50": st["p50_s"] * 1e3, "p90": st["p90_s"] * 1e3,
               "n": st["n"]} for (b, sh), st in snap.items()}}
    if codes != [200]:
        raise AssertionError(f"closed-loop load: status codes {codes}")
    return res, dispatches


def overload_and_priming(pred, frames, centers):
    """Priming of a deadline stack at (480, 640), then SERVER_BURST
    threads posting one frame each at once against
    SERVER_BURST_DEADLINE_MS and SERVER_BURST_MAX_QUEUE: some replies 503
    with Retry-After, shed + rejected > 0, and a plain request after the
    burst serves.  Returns the numbers and the server's dispatches."""
    with AWRServer(pred, port=0, deadline_ms=SERVER_BURST_DEADLINE_MS,
                   max_queue=SERVER_BURST_MAX_QUEUE).start() as srv:
        # before any client knows the port: no traffic interleaves
        snap = srv.batcher.prime_service_model(frames.shape[1:])
        prime = {"p90_ms": {b: v * 1e3 for b, v in sorted(snap.items())},
                 "stats": srv.batcher.prime_stats}
        gate = threading.Barrier(SERVER_BURST)
        replies = [None] * SERVER_BURST

        def client(i):
            obj = {"img_b64": b64(frames[i % len(frames)]),
                   "shape": list(frames.shape[1:]),
                   "center_xyz": centers[i % len(frames)].tolist()}
            gate.wait(60)
            status, headers, body = http_json(srv.port, "/predict", obj)
            replies[i] = (status, headers.get("Retry-After"),
                          body.get("retryable"))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(SERVER_BURST)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        after = http_joints(srv.port, "/predict", {
            "img_b64": b64(frames[0]), "shape": list(frames.shape[1:]),
            "center_xyz": centers[0].tolist()})
        res = {"burst": SERVER_BURST,
               "deadline_ms": SERVER_BURST_DEADLINE_MS,
               "max_queue": SERVER_BURST_MAX_QUEUE,
               "served": sum(r[0] == 200 for r in replies),
               "status_503": sum(r[0] == 503 for r in replies),
               "retry_after_on_503": sorted({r[1] for r in replies
                                             if r[0] == 503}, key=str),
               "shed": srv.batcher.n_shed,
               "rejected": srv.batcher.n_rejected,
               "after_burst_finite": bool(np.isfinite(after).all())}
        dispatches = srv.batcher.n_dispatches
    if (any(r is None or r[0] not in (200, 503) for r in replies)
            or res["status_503"] == 0 or res["shed"] + res["rejected"] == 0
            or res["retry_after_on_503"] != ["1"]
            or not all(r[2] is True for r in replies if r[0] == 503)
            or not res["after_burst_finite"]):
        raise AssertionError(f"overload: {res} {replies}")
    return res, prime, dispatches


def start_server_cli(tmp, frames, centers):
    """The server CLI with its defaults (resnet_18, bf16) on a seeded
    resnet_18 ``.pth`` and 32 normalized crops written here, ``--port 0``,
    in a process of its own; returns the process, a thread that reads its
    output, and the int8 Predictor built the same way in this process."""
    cfg = resnet_config(compute_dtype="bfloat16")
    model = build_model(cfg.net, cfg.jt_num, cfg.downsample)
    torch_default_init_(model, torch.Generator().manual_seed(SEED))
    pth = os.path.join(tmp, "resnet_18.pth")
    torch.save(randomize_batch_norm_(model).state_dict(), pth)
    calib = os.path.join(tmp, "calib.npy")
    np.save(calib, normalized_crops(cfg, frames, centers))
    proc = subprocess.Popen(
        [sys.executable, "-m", "awr_tpu_torch.server", "--pth", pth,
         "--int8-calib", calib, "--port", "0"],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    log = {"lines": [], "port": None, "ready": threading.Event()}

    def read():
        for line in proc.stdout:
            log["lines"].append(line.rstrip())
            if line.startswith("serving ") and log["port"] is None:
                log["port"] = int(line.split(":")[-1].split()[0])
                log["ready"].set()
        log["ready"].set()

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    pred_q = Predictor.from_torch(cfg, pth, device="cuda")
    pred_q.quantize(np.load(calib))
    return proc, reader, log, pred_q


def phase_server(pred, frames, centers):
    """The port's serving stack on the card (the module's docstring):
    the ``predict_async`` contract, the in-process ``AWRServer`` (float32
    hourglass_1, then int8 resnet_18 under bf16), the server CLI serving
    int8 resnet_18, the closed-loop load, priming and overload.  Returns
    the launches of the server path."""
    cfg = pred.cfg
    out = {"phase": "server", "net": cfg.net, "img_size": cfg.img_size,
           "frame_shape": list(frames.shape[1:])}
    out["async_contract"] = async_contract(pred, frames, centers)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_server_") as tmp:
        proc, reader, log, pred_q = start_server_cli(tmp, frames, centers)
        try:
            n8 = SERVER_INT8_FRAMES
            want1 = pred.predict(frames[:1], centers[:1])[0]
            want8 = pred.predict(frames[:n8], centers[:n8])
            want_q = pred_q.predict(frames[:n8], centers[:n8])
            out["host"] = host_costs(pred, frames, centers)

            reset_counts()
            d_http, out["http_max_abs_err"] = server_correctness(
                pred, frames, centers, want1, want8)
            with AWRServer(pred_q, port=0).start() as srv:
                _, _, h = http_json(srv.port, "/healthz")
                got_q = http_joints(srv.port, "/predict_batch", {
                    "imgs_b64": b64(frames[:n8]),
                    "shape": list(frames[:n8].shape),
                    "centers_xyz": centers[:n8].tolist()})
                d_int8 = srv.batcher.n_dispatches
            out["int8_in_process"] = {
                "healthz_int8": h["int8"],
                "max_abs_err": float(np.abs(got_q - want_q).max())}
            if h["int8"] is not True or not np.allclose(
                    got_q, want_q, rtol=SERVER_RTOL, atol=SERVER_ATOL):
                raise AssertionError(f"int8 server: {out['int8_in_process']}")

            # the CLI, started above, before the load: its start-up would
            # compete with the load for the host and the card
            if not log["ready"].wait(SERVER_CLI_START_S) or not log["port"]:
                raise AssertionError("server CLI did not start: "
                                     + "\n".join(log["lines"]))
            _, _, h = http_json(log["port"], "/healthz")
            got_cli = http_joints(log["port"], "/predict_batch", {
                "imgs_b64": b64(frames[:n8]), "shape": list(frames[:n8].shape),
                "centers_xyz": centers[:n8].tolist()})
            err = float(np.abs(got_cli - want_q).max())
            out["cli"] = {"startup_lines": log["lines"], "healthz": h,
                          "max_abs_err_vs_in_process": err,
                          "atol": SERVER_CLI_ATOL}
            if h["int8"] is not True or h["net"] != "resnet_18":
                raise AssertionError(f"server CLI healthz: {h}")
            if not err <= SERVER_CLI_ATOL:
                raise AssertionError(f"server CLI joints differ by {err}")

            out["load"], d_load = {}, 0
            for clients in SERVER_LOAD_CLIENTS:
                res, d = closed_loop(pred, frames, centers, tmp, clients)
                out["load"][str(clients)] = res
                d_load += d
            out["overload"], out["priming"], d_over = overload_and_priming(
                pred, frames, centers)
            launches = counts()
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            reader.join(timeout=30)
    out["dispatches"] = {"http": d_http, "int8": d_int8, "load": d_load,
                         "overload_and_priming": d_over}
    out["launches"] = launches
    emit(out)
    check_launches("server", launches, {
        "decode": d_http + d_int8 + d_load + d_over,
        "int8_gemm": 20 * d_int8, "deconv_int8_bf16": 3 * d_int8})
    return launches


# The export phase's fresh process: argv the directory of programs and
# inputs, and the kernels' names as JSON.  It
# imports torch, numpy and the loader only; for each program in
# jobs.json it runs one call (held to the parent's output), reads the
# counters, then times EXPORT_REPS calls after two warm ones; prints one
# JSON line a program.
EXPORT_CHILD = r"""
import json, os, sys, time
import numpy as np
import torch
from awr_tpu_torch import export, kernels
root, names = sys.argv[1], json.loads(sys.argv[2])
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
def counts():
    return {n: kernels.LAUNCHES[n] for n in names}
with open(os.path.join(root, "jobs.json")) as fh:
    jobs = json.load(fh)
for job in jobs:
    t0 = time.perf_counter()
    prog = export.load(os.path.join(root, job["file"]))
    load_s = time.perf_counter() - t0
    inputs = np.load(os.path.join(root, job["inputs"]))
    if prog.raw_hw is None:
        args = (inputs["img"],)
    else:
        args = (inputs["frames"],
                {k: inputs["crop_" + k] for k in export.CROP_KEYS},
                inputs["center_z"], inputs["cube_z"])
    kernels.LAUNCHES.clear()
    got = prog.call(*args).cpu().numpy()
    first = counts()
    def call():
        torch.cuda.synchronize()
        t = time.perf_counter()
        prog.call(*args).cpu()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3
    for _ in range(2):
        call()
    ms = [call() for _ in range(job["reps"])]
    want = np.load(os.path.join(root, job["want"]))
    print(json.dumps({
        "program": job["name"], "load_s": load_s, "shape": list(got.shape),
        "finite": bool(np.isfinite(got).all()),
        "max_abs_err": float(np.abs(got - want).max()),
        "launches_first_call": first, "launches": counts(),
        "calls": 3 + job["reps"], "call_ms": float(np.median(ms)),
        "models_imported": "awr_tpu_torch.models" in sys.modules,
        "serving_imported": "awr_tpu_torch.serving" in sys.modules}),
        flush=True)
"""


def phase_export(pred, pred_q, frames, centers):
    """``Predictor.export_program`` on the card: hourglass_1 float32 in
    both extents, hourglass_1 bf16 and int8 resnet_18 (after
    ``quantize``) normalized, traced here at B = EXPORT_BATCH (tracing
    launches no kernel), saved, and run in a fresh process that imports
    no model code (EXPORT_CHILD): each program's joints against the
    Predictor's, its exact launches, its call time beside the Predictor
    call it replaces.  Returns the launches of the fresh process."""
    B = EXPORT_BATCH
    f, c = np.resize(frames, (B,) + frames.shape[1:]), np.resize(centers,
                                                                  (B, 3))
    cfg = pred.cfg
    bf16 = Predictor(cfg.replace(compute_dtype="bfloat16"),
                     pred.model.state_dict(), device="cuda")
    crops = normalized_crops(cfg, f, c)
    crops_q = normalized_crops(pred_q.cfg, f, c)
    per_call = {"decode": 1}
    jobs = [("hourglass_1_float32_normalized", pred, None, crops, per_call,
             "normalized"),
            ("hourglass_1_float32_raw", pred, f.shape[1:], None, per_call,
             "raw"),
            ("hourglass_1_bfloat16_normalized", bf16, None, crops, per_call,
             "normalized"),
            ("resnet_18_int8_normalized", pred_q, None, crops_q,
             {"decode": 1, "int8_gemm": 20, "deconv_int8": 3}, "int8")]
    out = {"phase": "export", "batch": B, "programs": {}}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_export_") as tmp:
        listing = []
        for name, p, raw_hw, img, want, bar in jobs:
            reset_counts()
            t0 = time.perf_counter()
            payload = p.export_program(B, os.path.join(tmp, f"{name}.pt2"),
                                       raw_hw=raw_hw)
            export_s = time.perf_counter() - t0
            check_launches(f"export trace {name}", counts(), {})
            if raw_hw is None:
                inputs = {"img": img}
                want_out = p.predict_normalized(img)
                pred_ms = host_ms(lambda: p.predict_normalized(img),
                                  EXPORT_REPS)
            else:
                cubes = np.tile(np.asarray(p.cfg.cube, np.float64), (B, 1))
                cu = xyz2uvd_np(c, p.cfg.paras, p.cfg.flip)
                crop = crop_params_np(cu, cubes, np.asarray(p.cfg.paras),
                                      p.cfg.img_size)
                inputs = {"frames": f, "center_z": cu[:, 2].astype(np.float32),
                          "cube_z": cubes[:, 2].astype(np.float32)}
                inputs.update({"crop_" + k: v for k, v in crop.items()})
                want_out = p.predict(f, c)
                pred_ms = host_ms(lambda: p.predict(f, c), EXPORT_REPS)
            np.savez(os.path.join(tmp, f"{name}_inputs.npz"), **inputs)
            np.save(os.path.join(tmp, f"{name}_want.npy"), want_out)
            listing.append({"name": name, "file": f"{name}.pt2",
                            "inputs": f"{name}_inputs.npz",
                            "want": f"{name}_want.npy", "reps": EXPORT_REPS})
            out["programs"][name] = {
                "bytes": len(payload), "export_s": export_s,
                "predictor_ms": pred_ms, "atol": EXPORT_ATOL[bar],
                "per_call": want}
        with open(os.path.join(tmp, "jobs.json"), "w") as fh:
            json.dump(listing, fh)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", EXPORT_CHILD, tmp,
             json.dumps([k["name"] for k in KERNELS])],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=900)
        out["child_s"] = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"export: the fresh process failed:\n"
                             f"{proc.stderr[-4000:]}")
    launches = {k["name"]: 0 for k in KERNELS}
    for line in proc.stdout.splitlines():
        res = json.loads(line)
        rec = out["programs"][res["program"]]
        rec.update(res)
        want = rec["per_call"]
        check_launches(f"export {res['program']} (first call)",
                       res["launches_first_call"], want)
        check_launches(f"export {res['program']}", res["launches"],
                       {k: n * res["calls"] for k, n in want.items()})
        for k, n in res["launches"].items():
            launches[k] += n
    out["launches"] = launches
    emit(out)
    for name, rec in out["programs"].items():
        if "max_abs_err" not in rec:
            raise AssertionError(f"export {name}: no result from the fresh "
                                 f"process")
        if rec["models_imported"] or rec["serving_imported"]:
            raise AssertionError(f"export {name}: the loader imported the "
                                 f"models or the Predictor")
        if (not rec["finite"] or rec["shape"] != [B, cfg.jt_num, 3]
                or not rec["max_abs_err"] <= rec["atol"]):
            raise AssertionError(f"export {name}: {rec}")
    return launches


def run_children(target, args_list, timeout=PARALLEL_TIMEOUT_S):
    """Start one ``spawn`` process per argument tuple (CUDA needs spawn,
    not fork), wait for all within ``timeout`` seconds, kill what is left,
    and fail unless every one exited 0."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=args) for args in args_list]
    for proc in procs:
        proc.start()
    deadline = time.monotonic() + timeout
    for proc in procs:
        proc.join(max(0.0, deadline - time.monotonic()))
    hung = [proc.pid for proc in procs if proc.is_alive()]
    for proc in procs:
        if proc.is_alive():
            proc.kill()
            proc.join()
    codes = [proc.exitcode for proc in procs]
    if hung or any(codes):
        raise AssertionError(f"{target.__name__}: processes {hung} hung, "
                             f"exit codes {codes}")


def trainer_run(argv):
    """The train CLI for 2 epochs (``argv``: the trainer phase's), with
    the train steps' losses kept on the card until the end, the epochs'
    test results, the final weights, the launches and the second
    epoch's train frames/s."""
    from awr_tpu_torch.training import trainer as trainer_module

    losses, make = [], trainer_module.make_raw_train_step

    def make_spy(*args, **kw):
        step = make(*args, **kw)

        def spy(*step_args):
            metrics = step(*step_args)
            losses.append(metrics["loss"])
            return metrics

        return spy

    trainer_module.make_raw_train_step = make_spy
    try:
        with trainer_marks() as marks:
            reset_counts()
            tr = train_cli.main(argv + ["--epochs", "2"])
            torch.cuda.synchronize()
            launches = counts()
    finally:
        trainer_module.make_raw_train_step = make
    train_s = marks["test_start"][2] - marks["save_end"][1]
    return {"losses": [float(x) for x in losses], "tests": marks["tests"],
            "best_records": tr.best_records, "launches": launches,
            "state": {k: v.cpu() for k, v in tr.model.state_dict().items()},
            "warm_epoch_train_fps": TRAINER_FRAMES / train_s,
            "distributed": tr.distributed, "world": tr.world,
            "device": str(tr.device)}


def ddp_trainer_rank(init, out, argv):
    """(a): the only rank of an NCCL process group runs the train CLI,
    whose Trainer wraps the model in DDP (BatchNorm stays plain at world
    size 1)."""
    import torch.distributed as dist

    torch.cuda.set_device(0)
    torch.backends.cudnn.deterministic = True
    dist.init_process_group("nccl", init_method="file://" + init,
                            world_size=1, rank=0)
    try:
        torch.save(trainer_run(argv), out)
    finally:
        dist.destroy_process_group()


def shared_card_rank(rank, init, inputs, out):
    """(b): rank ``rank`` of two gloo ranks on cuda:0: DDP, the global
    BatchNorm and the global loss normalization, one raw SGD step on its
    rows of the global batch, then timed steps."""
    import torch.distributed as dist
    from torch.nn.parallel import DistributedDataParallel

    from awr_tpu_torch.models.common import global_batch_norm
    from awr_tpu_torch.parallel.multihost import rank_rows

    torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method="file://" + init,
                            world_size=2, rank=rank)
    try:
        data = torch.load(inputs, weights_only=False)
        cfg = data["cfg"]
        model = build_model(cfg.net, cfg.jt_num)
        model.load_state_dict(data["state"])
        model = global_batch_norm(model.cuda())
        ddp = DistributedDataParallel(model, device_ids=[0],
                                      broadcast_buffers=False)
        opt = make_optimizer(model.parameters(), "sgd", PARALLEL_LR)
        step = make_raw_train_step(ddp, opt, cfg, cfg.paras, cfg.flip)
        rows = torch.from_numpy(rank_rows(len(data["raw"]["img"]), 2, rank))
        raw = {k: v[rows].cuda() for k, v in data["raw"].items()}
        p = {k: v[rows].cuda() for k, v in data["p"].items()}
        aug = tuple(a[rows].cuda() for a in data["aug"])
        reset_counts()
        m = step(raw, p, aug)
        torch.cuda.synchronize()
        res = {"launches": counts(), "loss": float(m["loss"]),
               "state": {k: v.cpu() for k, v in model.state_dict().items()},
               "rows": rows.tolist(), "w": raw["w"].tolist()}
        times = []
        for _ in range(PARALLEL_TIMED_STEPS):
            t0 = time.perf_counter()
            step(raw, p, aug)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        res["step_ms"] = times
        torch.save(res, out)
    finally:
        dist.destroy_process_group()


def parallel_ddp_world1(root):
    """(a) against the one-process train CLI on the same data, in turns
    (one process, DDP, DDP, one process): every run bit-equal to the
    first, exact launches, each run's warm-epoch frames/s."""
    steps = -(-TRAINER_FRAMES // TRAIN_BATCH)
    evals = -(-TRAINER_TEST_FRAMES // TRAIN_BATCH)
    argv = ["--net", "hourglass_1", "--synthetic", "--data-mode", "raw",
            "--synthetic-size", str(TRAINER_FRAMES),
            "--synthetic-test-size", str(TRAINER_TEST_FRAMES),
            "--batch-size", str(TRAIN_BATCH), "--device", "cuda"]
    want = {"encode": 2 * (steps + evals), "decode": 2 * (steps + evals),
            "decode_backward": 2 * steps}
    runs = []
    for i, side in enumerate(("plain", "ddp", "ddp", "plain")):
        run_argv = argv + ["--output-dir", os.path.join(root, str(i))]
        if side == "plain":
            deterministic = torch.backends.cudnn.deterministic
            torch.backends.cudnn.deterministic = True
            try:
                run = trainer_run(run_argv)
            finally:
                torch.backends.cudnn.deterministic = deterministic
        else:
            out = os.path.join(root, f"{i}.pt")
            run_children(ddp_trainer_rank, [(os.path.join(root, f"nccl{i}"),
                                             out, run_argv)])
            run = torch.load(out, weights_only=False)
        check_launches(f"parallel (a) {side} run {i}", run["launches"], want)
        if run["distributed"] != (side == "ddp") or run["world"] != 1:
            raise AssertionError(f"parallel (a) run {i}: distributed "
                                 f"{run['distributed']}, world {run['world']}")
        runs.append((side, run))
    first = runs[0][1]
    res = {"order": [side for side, _ in runs],
           "device": runs[1][1]["device"],
           # the path's launches: the two DDP runs'
           "launches": {k: sum(r["launches"][k] for s, r in runs
                               if s == "ddp") for k in want},
           "steps": len(first["losses"]), "loss_last": first["losses"][-1],
           "tests": first["tests"], "cudnn_deterministic": True,
           "warm_epoch_train_fps": {
               side: [r["warm_epoch_train_fps"] for s, r in runs
                      if s == side] for side in ("plain", "ddp")}}
    for key in ("losses", "tests", "best_records"):
        res[f"{key}_equal"] = all(r[key] == first[key] for _, r in runs)
    res["weights_equal"] = all(torch.equal(r["state"][k], v)
                               for _, r in runs
                               for k, v in first["state"].items())
    res["bit_equal"] = all(res[f"{key}_equal"] for key in
                           ("losses", "tests", "best_records", "weights"))
    if not (res["bit_equal"] and res["steps"] == 2 * steps):
        raise AssertionError(f"parallel (a): {res}")
    return res


def parallel_shared_card(root, frames, joints, centers):
    """(b) against one process's raw SGD step on the same 32 rows."""
    cfg = hourglass_config(coord_weight=0.1)
    B = len(frames)
    state = new_model(cfg, "cpu").state_dict()
    raw, p = raw_inputs(cfg, frames, joints, centers, "cpu")
    w = torch.ones(B)
    w[B - PARALLEL_PAD:] = 0.0
    raw["w"] = w
    aug = draw_augment_params(torch.Generator().manual_seed(SEED + 7), B,
                              *cfg.augment_para)
    inputs = os.path.join(root, "inputs.pt")
    torch.save({"cfg": cfg, "state": state, "raw": raw, "p": p, "aug": aug},
               inputs)
    init = os.path.join(root, "gloo")
    outs = [os.path.join(root, f"rank{r}.pt") for r in range(2)]
    run_children(shared_card_rank,
                 [(r, init, inputs, outs[r]) for r in range(2)])
    ranks = [torch.load(o, weights_only=False) for o in outs]

    model = build_model(cfg.net, cfg.jt_num)
    model.load_state_dict(state)
    model.cuda()
    step = make_raw_train_step(
        model, make_optimizer(model.parameters(), "sgd", PARALLEL_LR), cfg,
        cfg.paras, cfg.flip)
    m = step({k: v.cuda() for k, v in raw.items()},
             {k: v.cuda() for k, v in p.items()},
             tuple(a.cuda() for a in aug))
    loss = float(m["loss"])
    want = {k: v.cpu() for k, v in model.state_dict().items()}
    params = {n for n, _ in model.named_parameters()}
    stats = [k for k in want if "running" in k]
    param_ok = all(torch.allclose(ranks[0]["state"][k], want[k],
                                  rtol=PARALLEL_PARAM_RTOL,
                                  atol=PARALLEL_PARAM_ATOL) for k in params)
    res = {"batch": B, "padding_rows": PARALLEL_PAD,
           "rank_rows": [r["rows"][:1] + r["rows"][-1:] for r in ranks],
           "rank1_w_tail": ranks[1]["w"][-PARALLEL_PAD - 1:],
           "launches": [r["launches"] for r in ranks],
           "loss_ranks": [r["loss"] for r in ranks], "loss_one_process": loss,
           "loss_rel_err": abs(ranks[0]["loss"] - loss) / abs(loss),
           "param_max_abs_err": max(float((ranks[0]["state"][k] - want[k])
                                          .abs().max()) for k in params),
           "params_within": param_ok,
           "bn_stats_equal_on_ranks": all(
               torch.equal(ranks[0]["state"][k], ranks[1]["state"][k])
               for k in stats),
           "bn_stats_max_abs_err_vs_one_process": max(
               float((ranks[0]["state"][k] - want[k]).abs().max())
               for k in stats),
           "step_ms": [r["step_ms"] for r in ranks],
           "step_ms_median": float(np.median(ranks[0]["step_ms"])),
           "tolerances": {"loss_rtol": PARALLEL_LOSS_RTOL,
                          "param_rtol": PARALLEL_PARAM_RTOL,
                          "param_atol": PARALLEL_PARAM_ATOL}}
    for r, launches in enumerate(res["launches"]):
        check_launches(f"parallel (b) rank {r}", launches,
                       {"encode": 1, "decode": 1, "decode_backward": 1})
    if not (res["loss_rel_err"] <= PARALLEL_LOSS_RTOL and param_ok
            and res["bn_stats_equal_on_ranks"]
            and res["loss_ranks"][0] == res["loss_ranks"][1]):
        raise AssertionError(f"parallel (b): {res}")
    return res


def mesh_bucket(n: int, size: int) -> int:
    """The JAX Predictor's data-mesh bucket rule, written out."""
    b = 8
    while b < n:
        b *= 2
    b = max(b, size)
    return -(-b // size) * size


def parallel_data_mode(pred, pred_r, crops_q, frames, centers):
    """(c): float32 hourglass_1 and int8 resnet_18 Predictors on two
    replicas of cuda:0 against the one-device Predictors."""
    from awr_tpu_torch.parallel import make_mesh

    mesh = make_mesh(devices=["cuda:0"] * 2)
    fp = Predictor(pred.cfg, pred.model.state_dict(), mesh=mesh)
    res = {"mesh": [str(d) for d in mesh.devices], "float32": {},
           "int8": {}}
    launches = {k["name"]: 0 for k in KERNELS}

    def request(p, img):
        reset_counts()
        out = p.predict_normalized(img)
        got = counts()
        for k, n in got.items():
            launches[k] += n
        return out, got

    for B in PARALLEL_BATCHES:
        f, c = (np.resize(frames, (B,) + frames.shape[1:]),
                np.resize(centers, (B, 3)))
        img = normalized_crops(pred.cfg, f, c)
        want = pred.predict_normalized(img)
        got, n = request(fp, img)
        check_launches(f"parallel (c) float32 B={B}", n, {"decode": 2})
        err = float(np.abs(got - want).max())
        res["float32"][B] = {"bucket": fp._bucket(B),
                             "max_abs_err": err}
        if (fp._bucket(B) != mesh_bucket(B, 2) or got.shape != want.shape
                or not err <= EXPORT_ATOL["normalized"]):
            raise AssertionError(f"parallel (c) float32 B={B}: "
                                 f"{res['float32'][B]}")
    q = Predictor(pred_r.cfg, pred_r.model.state_dict(), mesh=mesh)
    one = Predictor(pred_r.cfg, pred_r.model.state_dict(), device="cuda")
    q.quantize(crops_q)
    one.quantize(crops_q)
    scales_equal = all(torch.equal(q.quant[k], one.quant[k])
                       for k in one.quant)
    got, n = request(q, crops_q)
    check_launches("parallel (c) int8", n, {"decode": 2, "int8_gemm": 40,
                                            "deconv_int8": 6})
    err = float(np.abs(got - one.predict_normalized(crops_q)).max())
    res["int8"] = {"scales_equal": scales_equal, "max_abs_err": err,
                   "atol": INT8_CPU_ATOL}
    if not (scales_equal and err <= INT8_CPU_ATOL):
        raise AssertionError(f"parallel (c) int8: {res['int8']}")
    res["request_ms"] = {}
    for B in PARALLEL_TIMED_BATCHES:
        f, c = (np.resize(frames, (B,) + frames.shape[1:]),
                np.resize(centers, (B, 3)))
        res["request_ms"][B] = {
            "mesh2": host_ms(lambda: fp.predict(f, c), PARALLEL_REPS),
            "one_device": host_ms(lambda: pred.predict(f, c),
                                  PARALLEL_REPS)}
    return res, launches


def phase_parallel(pred, pred_r, crops_q, frames, joints, centers):
    """(a) DDP at world size 1 under NCCL, (b) two gloo ranks sharing
    the card, (c) the Predictor's data mode on two replicas of the card
    (see PARALLEL_PAD's comment).  Returns the launches of the path:
    (a)'s and (b)'s ranks and (c)'s requests."""
    out = {"phase": "parallel", "net": "hourglass_1"}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_parallel_") as root:
        t0 = time.perf_counter()
        out["ddp_world1"] = parallel_ddp_world1(os.path.join(root, "a"))
        out["ddp_world1_s"] = time.perf_counter() - t0
        os.makedirs(os.path.join(root, "b"))
        t0 = time.perf_counter()
        out["shared_card_w2"] = parallel_shared_card(
            os.path.join(root, "b"), frames, joints, centers)
        out["shared_card_w2_s"] = time.perf_counter() - t0
    out["data_mode"], served = parallel_data_mode(pred, pred_r, crops_q,
                                                  frames, centers)
    launches = dict(served)
    for part in [out["ddp_world1"]["launches"]] + \
            out["shared_card_w2"]["launches"]:
        for k, n in part.items():
            launches[k] += n
    out["launches"] = launches
    emit(out)
    return launches


def rms(a, b) -> float:
    return float(np.sqrt(np.mean((np.asarray(a, np.float64) - b) ** 2)))


def spatial_request(launches, name, fn, want):
    """``fn()`` with the counts set to 0 just before and read just after,
    checked against ``want`` and added to ``launches``."""
    reset_counts()
    out = fn()
    torch.cuda.synchronize()
    got = counts()
    check_launches(name, got, want)
    for k, n in got.items():
        launches[k] += n
    return out


def spatial_hourglass(pred, mesh, frames, centers, launches, bf16_one):
    """hourglass_1 on the spatial ``mesh``: float32 raw requests at
    SPATIAL_BATCHES against the one-device ``pred`` (normalized joints on
    the same crops, the raw joints' largest difference), request times,
    and a bf16 request at B = 1 under the 2x rule."""
    cfg, n = pred.cfg, mesh.size
    sd = pred.model.state_dict()
    sp = Predictor(cfg, sd, mesh=mesh)
    res = {}
    for B in SPATIAL_BATCHES:
        f = np.resize(frames, (B,) + frames.shape[1:])
        c = np.resize(centers, (B, 3))
        raw = spatial_request(launches, f"spatial float32 n={n} B={B}",
                              lambda: sp.predict(f, c), {"decode_rows": n})
        img = normalized_crops(cfg, f, c)
        got = spatial_request(launches, f"spatial float32 n={n} B={B}",
                              lambda: sp.predict_normalized(img),
                              {"decode_rows": n})
        want = pred.predict_normalized(img)
        rec = {"bucket": sp._bucket(B),
               "normalized_max_abs_err": float(np.abs(got - want).max()),
               "raw_max_abs_err_px_mm": float(
                   np.abs(raw - pred.predict(f, c)).max()),
               "halo_rows": sum(map(sum, sp._infer.runner.gathered.values())),
               "request_ms": predict_ms(sp, f, c, SPATIAL_REPS[B])["median"],
               "one_device_request_ms": predict_ms(
                   pred, f, c, SPATIAL_REPS[B])["median"]}
        res[f"b{B}"] = rec
        if (rec["bucket"] != pred._bucket(B) or raw.shape != (B, 14, 3)
                or not np.isfinite(raw).all() or rec["halo_rows"] <= 0
                or not rec["normalized_max_abs_err"] <= SPATIAL_ATOL):
            raise AssertionError(f"spatial float32 n={n} B={B}: {rec}")
    spb = Predictor(cfg.replace(compute_dtype="bfloat16"), sd, mesh=mesh)
    img = normalized_crops(cfg, frames[:1], centers[:1])
    got = spatial_request(launches, f"spatial bf16 n={n}",
                          lambda: spb.predict_normalized(img),
                          {"decode_rows": n})
    ref_b, ref_f = (p.predict_normalized(img) for p in (bf16_one, pred))
    rec = {"rms_vs_one_device_bf16": rms(got, ref_b),
           "rms_one_device_bf16_vs_float32": rms(ref_b, ref_f),
           "max_abs_err": float(np.abs(got - ref_b).max()),
           "atol": SPATIAL_BF16_ATOL}
    res["bf16_b1"] = rec
    if not (rec["rms_vs_one_device_bf16"]
            <= 2 * rec["rms_one_device_bf16_vs_float32"]
            and rec["max_abs_err"] <= SPATIAL_BF16_ATOL):
        raise AssertionError(f"spatial bf16 n={n}: {rec}")
    return sp, res


def spatial_resnet(pred_r, pred_q, crops_q, mesh, launches):
    """resnet_18 on the spatial ``mesh``: float32 and, after ``quantize``
    on the same crops as the one-device ``pred_q``, int8 (scales
    bit-equal), both against the one-device Predictors."""
    n = mesh.size
    sp = Predictor(pred_r.cfg, pred_r.model.state_dict(), mesh=mesh)
    got = spatial_request(launches, f"spatial resnet_18 float32 n={n}",
                          lambda: sp.predict_normalized(crops_q),
                          {"decode_rows": n})
    res = {"float32_max_abs_err": float(
        np.abs(got - pred_r.predict_normalized(crops_q)).max())}
    sp.quantize(crops_q)
    res["scales_equal"] = all(torch.equal(sp.quant[k], pred_q.quant[k])
                              for k in pred_q.quant)
    # at img 128 every layer of resnet_18 has at least 8 rows: each int8
    # layer runs on every band
    got = spatial_request(launches, f"spatial resnet_18 int8 n={n}",
                          lambda: sp.predict_normalized(crops_q),
                          {"decode_rows": n, "int8_gemm": 20 * n,
                           "deconv_int8": 3 * n})
    res["int8_max_abs_err"] = float(
        np.abs(got - pred_q.predict_normalized(crops_q)).max())
    if not (res["scales_equal"]
            and res["float32_max_abs_err"] <= SPATIAL_ATOL
            and res["int8_max_abs_err"] <= INT8_CPU_ATOL):
        raise AssertionError(f"spatial resnet_18 n={n}: {res}")
    return res


def spatial_batching(sp, frames, centers, launches):
    """A ``BatchingPredictor`` over the spatial Predictor ``sp``: its
    joints against ``sp.predict``'s; each dispatch launches one
    row-window decode a band."""
    from awr_tpu_torch.batching import BatchingPredictor

    want = sp.predict(frames[:8], centers[:8])
    reset_counts()
    with BatchingPredictor(sp, max_batch=8, max_wait_ms=20.0) as bp:
        futs = [bp.submit(frames[i], centers[i]) for i in range(8)]
        got = np.stack([f.result(timeout=120) for f in futs])
    torch.cuda.synchronize()
    n = counts()
    for k, v in n.items():
        launches[k] += v
    rec = {"max_abs_err_px_mm": float(np.abs(got - want).max()),
           "decode_rows_launches": n["decode_rows"]}
    others = {k: v for k, v in n.items() if k != "decode_rows" and v}
    if (others or n["decode_rows"] == 0 or n["decode_rows"] % sp.mesh.size
            or not np.allclose(got, want, rtol=1e-5, atol=1e-3)):
        raise AssertionError(f"spatial batching: {rec}, {others}")
    return rec


def decode_rows_times(bw, flops, rows):
    """The row-window decode at B = 32 on the last ``rows`` rows of the
    F = 64 map (a spatial band of 64 / rows bands) and the depth rows it
    reads, beside its plain version and its bound."""
    B, F, J, H = 32, 64, 14, 128
    r0, i0 = F - rows, (F - rows) * H // F
    off, img = decode_inputs(B)
    off, img = off[:, :, r0:].contiguous(), img[:, i0:].contiguous()

    def args():
        return off.clone(), img.clone(), KERNEL_SIZE, r0, i0, H
    # the window's map and resized depth read, the joints and (max, sum)
    # written
    return kernel_times(
        decode_cuda.offset2joint_softmax_rows_cuda, offset2joint_softmax_rows,
        args, B * 4 * J * rows * F * 4 + B * rows * F * 4 + B * J * 5 * 4,
        B * J * rows * F * OPS["decode"], bw, flops)


def phase_spatial(pred, pred_r, pred_q, crops_q, frames, centers, bw, flops,
                  smi):
    """Spatial serving on ``spatial_mesh(devices=["cuda:0"] * n)``, n in
    SPATIAL_MESHES (see the module docstring).  Returns the launches of
    the spatial requests and the row-window decode's times."""
    from awr_tpu_torch.parallel import spatial_mesh

    launches = {k["name"]: 0 for k in KERNELS}
    out = {"phase": "spatial", "nvidia_smi": smi, "hourglass_1": {},
           "resnet_18": {}}
    bf16_one = Predictor(pred.cfg.replace(compute_dtype="bfloat16"),
                         pred.model.state_dict(), device="cuda")
    for n in SPATIAL_MESHES:
        mesh = spatial_mesh(devices=["cuda:0"] * n)
        sp, out["hourglass_1"][f"n{n}"] = spatial_hourglass(
            pred, mesh, frames, centers, launches, bf16_one)
        out["resnet_18"][f"n{n}"] = spatial_resnet(pred_r, pred_q, crops_q,
                                                   mesh, launches)
    out["batching"] = spatial_batching(sp, frames, centers, launches)
    times = {rows: decode_rows_times(bw, flops, rows) for rows in (32, 8)}
    out["decode_rows_b32"] = {f"rows{r}": t for r, t in times.items()}
    out["launches"] = launches
    emit(out)
    return launches, dict(times[32], library_ms=None)


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
    times.update(folded_times(
        bw, flops, chip_peaks(torch.cuda.get_device_name(0)).bf16_flops))
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
    launches.update(phase_serve_hourglass_int8(frames, centers, bw,
                                               int8_ops))
    launches.update(phase_qat(frames, centers))
    launches["train_resnet"] = phase_train_resnet(frames, joints, centers)
    launches.update(phase_datasets())
    bf16_launches, steps = phase_bf16(frames, joints, centers)
    launches.update(bf16_launches)
    # where a step's time goes in bf16 (and resnet_18's in float32, which
    # bf16 did not shorten)
    for net, dtype in (("hourglass_1", "bfloat16"), ("resnet_18", "bfloat16"),
                       ("resnet_18", "float32")):
        phase_profile(f"train {net} {dtype}, B = 32", *steps[net][dtype])
    launches["server"] = phase_server(pred, frames, centers)
    launches["export"] = phase_export(pred, pred_q, frames, centers)
    launches["parallel"] = phase_parallel(pred, pred_r, crops, frames,
                                          joints, centers)
    launches["spatial"], times["decode_rows"] = phase_spatial(
        pred, pred_r, pred_q, crops, frames, centers, bw, flops, smi)

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
