"""Train, eval and inference steps (the JAX package's step factories,
reference train.py:107-131 and test.py:67-97): GT offset encode, backbone
forward, adaptive decode, weighted dense + coordinate smooth-L1, and for
training the backward and the optimizer update.

One forward per step: the stacked (S, B, 4J, F, F) output (a single
(B, 4J, F, F) map counts as one stack) feeds every stack's loss.  With
``supervise_all_stacks`` (the default) every stack contributes to the
training loss; without it only the last does, which is the gradient the
reference's per-stack recompute loop backpropagates.
The backbone runs in the compute dtype it was built with
(``build_model(compute_dtype=)``) and returns a float32 map under
bfloat16, so the encode, the decode, the decode's backward and the loss
run in float32.  On CUDA tensors the encode, the decode and the decode's
backward are the hand-written kernels.  No step calls ``.item()`` or otherwise waits on
the device: metrics come back as device tensors.

A step made for a ``DistributedDataParallel`` model is data parallel:
it runs on one rank of the process group, on the rank's rows of the
global batch (``parallel.multihost.rank_rows``), and computes what one
device computes on the global batch.  Each loss is divided by the valid
rows of the global (micro)batch, the losses the step returns are summed
over the ranks, and the training loss is scaled by the world size,
which DDP's gradient average divides out again (BatchNorm is global
with more than one rank: ``models.common.global_batch_norm``).  The
collectives go on the device's stream; the step still does not wait.

Under a profiler the train steps name their host phases as spans
(:func:`awr_tpu_torch.utils.profiling.span`): ``train.preprocess`` (the
raw form's device crop and augmentation), ``train.forward`` (encode,
forward and losses of a microbatch), ``train.backward`` and
``train.optimizer`` (``zero_grad`` and ``step``); inside
``train.forward``, ``train.supervise`` holds every supervised stack's
decode and its two losses, once a microbatch.
"""

from __future__ import annotations

import contextlib
import functools

import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from awr_tpu_torch.data.device import train_preprocess
from awr_tpu_torch.ops.decode import decode_offsets
from awr_tpu_torch.ops.encode import encode_offsets
from awr_tpu_torch.ops.loss import smooth_l1_loss
from awr_tpu_torch.utils.profiling import span


def _stacked(out: torch.Tensor) -> torch.Tensor:
    """A backbone's output as (S, B, 4J, F, F): the hourglass stacks its
    maps, the ResNet-deconv returns one (B, 4J, F, F) map."""
    return out if out.dim() == 5 else out[None]


def _forward(model, img):
    """(B, S, S) depth -> (S, B, 4J, F, F), the input cast to the
    model's parameter dtype (float64 in the parity oracles); the model
    casts it on to its compute dtype."""
    dtype = next(model.parameters()).dtype
    return _stacked(model(img[:, None].to(dtype)))


def _losses(preds, stacks, img, jt_uvd, offset_gt, w, cfg, w_sum=None):
    """Summed (offset, coord) losses over ``stacks`` and the joints
    decoded from the last of them; ``w_sum``: the divisor of weighted
    losses (default: ``w``'s sum)."""
    loss_offset = loss_coord = 0.0
    for s in stacks:
        jt_pred = decode_offsets(preds[s], img, cfg.kernel_size)
        loss_coord = loss_coord + cfg.coord_weight * smooth_l1_loss(
            jt_pred, jt_uvd, w, w_sum)
        loss_offset = loss_offset + cfg.dense_weight * smooth_l1_loss(
            preds[s], offset_gt, w, w_sum)
    return loss_offset, loss_coord, jt_pred


def _global_weight_sums(w, img, parts: int):
    """The valid rows of each of the global batch's ``parts``
    microbatches: this rank's weight sums (its rows all valid without
    ``w``), summed over the ranks.  Returns the weights and the sums."""
    if w is None:
        w = torch.ones(img.shape[0], dtype=torch.float32, device=img.device)
    sums = torch.stack([part.sum() for part in w.chunk(parts)])
    dist.all_reduce(sums)
    return w, list(sums.unbind())


def _summed(values):
    """The ranks' loss terms summed: the global batch's losses."""
    total = torch.stack([torch.as_tensor(v, dtype=torch.float32)
                         for v in values])
    dist.all_reduce(total)
    return list(total.unbind())


def make_train_step(model, optimizer, cfg):
    """Returns ``train_step(batch) -> metrics``.

    ``batch`` holds ``img`` (B, S, S), ``jt_uvd`` (B, J, 3) and optionally
    ``w`` (B,), the validity weights of padding rows.  The step zeroes
    the gradients, accumulates them over ``cfg.grad_accum`` microbatches
    (each microbatch's loss scaled by its share ``w_i / sum(w)`` of the
    valid samples, BatchNorm statistics chained through them in order),
    takes one optimizer step and leaves the gradients in ``.grad``.
    Returns device tensors ``loss``, ``loss_offset``, ``loss_coord`` and
    ``jt_uvd_pred``.  For a DDP model (the module docstring) the batch
    is this rank's rows, the losses those of the global batch and
    ``jt_uvd_pred`` this rank's rows.
    """
    accum = max(1, int(cfg.grad_accum))
    distributed = isinstance(model, DistributedDataParallel)

    def micro(img, jt_uvd, w, w_sum=None):
        offset_gt = encode_offsets(jt_uvd, img, cfg.kernel_size,
                                   cfg.feature_size)
        preds = _forward(model, img)
        nstack = preds.shape[0]
        stacks = (range(nstack) if cfg.supervise_all_stacks
                  else [nstack - 1])
        with span("train.supervise"):
            return _losses(preds, stacks, img, jt_uvd, offset_gt, w, cfg,
                           w_sum)

    def train_step(batch):
        img, jt_uvd, w = batch["img"], batch["jt_uvd"], batch.get("w")
        B = img.shape[0]
        if B % accum:
            raise ValueError(f"batch size {B} not divisible by grad_accum "
                             f"{accum}")
        mb = B // accum
        model.train()
        with span("train.optimizer"):
            optimizer.zero_grad()
        if distributed:
            world = dist.get_world_size()
            w, w_sums = _global_weight_sums(w, img, accum)
        elif w is None:
            w_sums = [mb] * accum
        else:
            w_sums = [w[i * mb:(i + 1) * mb].sum() for i in range(accum)]
        w_tot = sum(w_sums)
        totals = [0.0, 0.0, 0.0]
        jt_preds = []
        for i in range(accum):
            part = slice(i * mb, (i + 1) * mb)
            # DDP reduces the gradients once, in the last backward
            sync = (model.no_sync() if distributed and i < accum - 1
                    else contextlib.nullcontext())
            with sync:
                with span("train.forward"):
                    l_off, l_crd, jt_pred = micro(
                        img[part], jt_uvd[part],
                        None if w is None else w[part],
                        w_sums[i] if distributed else None)
                    loss = l_off + l_crd
                # one microbatch keeps its loss as it is, as the JAX step
                # does (an all-padding batch then gives 0, not 0/0)
                share = 1.0 if accum == 1 else w_sums[i] / w_tot
                with span("train.backward"):
                    (loss * (share * world if distributed
                             else share)).backward()
            for k, v in enumerate((loss, l_off, l_crd)):
                totals[k] = totals[k] + v.detach() * share
            jt_preds.append(jt_pred.detach())
        with span("train.optimizer"):
            optimizer.step()
        if distributed:
            totals = _summed(totals)
        loss, l_off, l_crd = totals
        return dict(loss=loss, loss_offset=l_off, loss_coord=l_crd,
                    jt_uvd_pred=torch.cat(jt_preds))

    return train_step


def make_eval_step(model, cfg):
    """Returns ``eval_step(batch) -> metrics``: the model in eval mode,
    without autograd.  The losses SUM over every stack (reference
    test.py:74-87); ``jt_uvd_pred`` is the last stack's decode.
    For a DDP model the batch is this rank's rows and the losses those
    of the global batch (the module docstring)."""
    distributed = isinstance(model, DistributedDataParallel)

    @torch.no_grad()
    def eval_step(batch):
        img, jt_uvd, w = batch["img"], batch["jt_uvd"], batch.get("w")
        model.eval()
        preds = _forward(model, img)
        offset_gt = encode_offsets(jt_uvd, img, cfg.kernel_size,
                                   cfg.feature_size)
        w_sum = None
        if distributed:
            w, (w_sum,) = _global_weight_sums(w, img, 1)
        l_off, l_crd, jt_pred = _losses(preds, range(preds.shape[0]), img,
                                        jt_uvd, offset_gt, w, cfg, w_sum)
        loss = l_crd + l_off
        if distributed:
            loss, l_off, l_crd = _summed((loss, l_off, l_crd))
        return dict(jt_uvd_pred=jt_pred, loss=loss, loss_offset=l_off,
                    loss_coord=l_crd)

    return eval_step


@functools.lru_cache(maxsize=None)
def _intrinsics(paras: tuple, device: torch.device) -> torch.Tensor:
    """``paras`` as a float32 tensor on ``device``, uploaded once."""
    return torch.tensor(paras, dtype=torch.float32, device=device)


def _raw_batch(raw, crop_params, aug, paras, cfg, flip):
    img = raw["img"]
    pre = train_preprocess(img, raw["jt_xyz"], raw["centers_uvd"],
                           raw["cubes"], _intrinsics(paras, img.device),
                           crop_params, aug, cfg.img_size, flip)
    batch = dict(img=pre["img"], jt_uvd=pre["jt_uvd"])
    if "w" in raw:
        batch["w"] = raw["w"]
    return pre, batch


def make_raw_train_step(model, optimizer, cfg, paras, flip: int):
    """Raw-mode train step: device crop, augmentation and normalization,
    then :func:`make_train_step`.

    Returns ``raw_train_step(raw, crop_params, aug) -> metrics``: ``raw``
    holds float32 tensors on one device, ``img`` (B, H0, W0) mm frames,
    ``jt_xyz`` (B, J, 3) absolute mm joints, ``centers_uvd`` and
    ``cubes`` (B, 3), optionally ``w`` (B,); ``crop_params`` comes from
    :func:`awr_tpu_torch.data.device.crop_param_tensors`; ``aug`` from
    :func:`awr_tpu_torch.data.device.draw_augment_params`.  The metrics
    add ``M``, ``cube``, ``center_xyz`` and the normalized ``jt_xyz``.
    """
    base = make_train_step(model, optimizer, cfg)
    paras = tuple(float(x) for x in paras)

    def raw_train_step(raw, crop_params, aug):
        with span("train.preprocess"):
            pre, batch = _raw_batch(raw, crop_params, aug, paras, cfg, flip)
        metrics = base(batch)
        metrics.update(M=pre["M"], cube=pre["cube"],
                       center_xyz=pre["center_xyz"], jt_xyz=pre["jt_xyz"])
        return metrics

    return raw_train_step


def make_raw_eval_step(model, cfg, paras, flip: int):
    """Raw-mode eval step: :func:`make_raw_train_step`'s preprocessing
    with every sample's augmentation forced to op 3 (none), then
    :func:`make_eval_step`.  Returns ``raw_eval_step(raw, crop_params)
    -> metrics``, which add ``M``, ``cube``, ``center_xyz``, ``jt_xyz``,
    ``img`` and ``jt_uvd``."""
    base = make_eval_step(model, cfg)
    paras = tuple(float(x) for x in paras)

    def raw_eval_step(raw, crop_params):
        img = raw["img"]
        B, dev = img.shape[0], img.device
        aug = (torch.full((B,), 3, dtype=torch.int64, device=dev),
               torch.zeros((B, 3), device=dev), torch.ones((B,), device=dev),
               torch.zeros((B,), device=dev))
        pre, batch = _raw_batch(raw, crop_params, aug, paras, cfg, flip)
        metrics = base(batch)
        metrics.update(M=pre["M"], cube=pre["cube"],
                       center_xyz=pre["center_xyz"], jt_xyz=pre["jt_xyz"],
                       img=pre["img"], jt_uvd=pre["jt_uvd"])
        return metrics

    return raw_eval_step


def infer(model, img: torch.Tensor, kernel_size: float) -> torch.Tensor:
    """(B, S, S) normalized depth -> (B, J, 3) normalized uvd joints
    decoded from the last stack: the inference step's body, which
    ``Predictor.export_program`` traces."""
    preds = _stacked(model(img[:, None]))
    return decode_offsets(preds[-1], img, kernel_size)


def make_infer_step(model, cfg):
    """``infer_step((B, S, S) normalized depth) -> (B, J, 3)`` normalized
    uvd joints, on the model's device, without autograd."""
    kernel = cfg.kernel_size

    @torch.inference_mode()
    def infer_step(img: torch.Tensor) -> torch.Tensor:
        return infer(model, img, kernel)

    return infer_step
