"""The Trainer: a host loop around the train and eval steps (the
JAX package's ``training/trainer.py``).

Reference parity: the Trainer semantics of train.py (epoch loop,
per-batch encode/forward/decode/loss/step, per-epoch train-MPE + test +
checkpoint, log file, lr scheduling) and test.py (eval loop, PCK plot,
prediction txt dump).  Differences from the reference, the JAX
package's too:

- One forward per train step; all hourglass stacks supervised by default
  (see ``training/steps.py``).
- ``best_records`` is updated on improvement (the reference initializes
  it at train.py:75-77 but never writes it); ``best_records["epoch"]`` is
  the resume cursor, ``best_records["best_epoch"]`` the best epoch.
- Two data modes, as in the JAX package.  Host mode: the dataset's items
  are the reference's host chain (crop, augmentation, normalization on
  the host, ``data/base.py``); the Trainer uploads the normalized crops
  and runs the plain train and eval steps, and the evaluator's feedback
  (``jt_xyz``, ``center_xyz``, ``M``, ``cube``) comes from the host
  batch.  Host-mode training loads with one worker, so the dataset's one
  ``RandomState`` is drawn in the reference's order.  Raw mode: the crop,
  the augmentation and the normalization run on the device inside the
  steps; the augmentation is drawn from a device generator seeded by
  ``(seed, epoch, step)``, so a resumed run draws what a straight run
  draws.
- float32 without TF32 (the JAX package's ``matmul_precision`` default,
  "highest"), or with ``compute_dtype`` "bfloat16" the backbone in bf16
  (parameters, Adam state and checkpoints float32; the encode, the
  decode and the loss on float32 maps).

One GPU, no mesh: a partial last batch pads to a multiple of
``grad_accum`` with a validity weight ``w`` that masks the padding rows
out of the losses and gradients.  No step waits on the device: losses
and joints stay on it until the print or the end of the epoch.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from awr_tpu_torch.config import Config, resolve_device
from awr_tpu_torch.data import device as data_device
from awr_tpu_torch.data.pipeline import PrefetchLoader, prefetch_to_device
from awr_tpu_torch.data.transforms import crop_params_np
from awr_tpu_torch.evaluation import Evaluator
from awr_tpu_torch.geometry import xyz2uvd_np
from awr_tpu_torch.models import build_model
from awr_tpu_torch.models.weights import load_reference_state_dict
from awr_tpu_torch.training.checkpoints import CheckpointManager
from awr_tpu_torch.training.optim import (PlateauScheduler,
                                          get_learning_rate, make_optimizer,
                                          set_learning_rate, step_lr)
from awr_tpu_torch.training.steps import (make_eval_step, make_raw_eval_step,
                                          make_raw_train_step,
                                          make_train_step)
from awr_tpu_torch.training.watchdog import Watchdog
from awr_tpu_torch.vis import plot_pose


def augment_seed(seed: int, epoch: int, step: int) -> int:
    """The augmentation generator's seed for (seed, epoch, step): the JAX
    package folds ``epoch * 1_000_003 + step`` into its key."""
    return (seed * 1_000_003 ** 2 + epoch * 1_000_003 + step) % 2 ** 63


class Trainer:
    def __init__(self, config: Config, train_data=None, test_data=None,
                 workdir: Optional[str] = None, device=None):
        """``device``: CUDA unless named; without a GPU, name "cpu"."""
        self.cfg = config
        self.device = resolve_device(device)
        self.train_data = train_data
        self.test_data = test_data

        self.work_dir = workdir or os.path.join(
            config.output_dir, config.dataset,
            "checkpoint_" + config.exp_id)
        self.result_dir = os.path.join(self.work_dir, "results")
        os.makedirs(self.result_dir, exist_ok=True)
        self.log_file = os.path.join(
            self.work_dir, f"{config.net}_{config.log_id}.log")
        self._log_fh = open(self.log_file, "a")
        self.print_msg("------------------- start -------------------",
                       stdout=False)
        for k, v in sorted(vars(config).items()):
            self.print_msg(f"{k}:{v}", stdout=False)

        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        # float32 parameters, Adam state and checkpoints; the forward and
        # backward in the compute dtype
        self.model = build_model(config.net, config.jt_num,
                                 config.downsample, remat=config.remat,
                                 compute_dtype=config.torch_compute_dtype)
        self.model.reset_parameters(torch.Generator().manual_seed(
            config.seed))
        self.model.to(self.device)
        self.optimizer = make_optimizer(self.model.parameters(),
                                        config.optimizer, config.lr,
                                        config.weight_decay)
        # a partial batch pads to a multiple of the microbatch count
        self._pad_multiple = max(1, int(config.grad_accum))
        # the stream the steps run on; the stager thread copies on it
        self._stream = (torch.cuda.current_stream(self.device)
                        if self.device.type == "cuda" else None)
        self._gen = torch.Generator(self.device)
        self._train_step = make_train_step(self.model, self.optimizer,
                                           config)
        self._eval_step = make_eval_step(self.model, config)
        ds = train_data if train_data is not None else test_data
        if ds is not None and self._raw(ds):
            self._raw_train_step = make_raw_train_step(
                self.model, self.optimizer, config, ds.paras, ds.flip)
            self._raw_eval_step = make_raw_eval_step(
                self.model, config, ds.paras, ds.flip)

        self.best_records = {"epoch": 0, "best_epoch": 0, "MPE": 1e10,
                             "AUC": 0.0}
        self._watchdog = None  # armed by train() when step_timeout_s set
        self.plateau = (PlateauScheduler(config.lr)
                        if config.scheduler == "auto" else None)
        self.ckpt = CheckpointManager(os.path.join(self.work_dir, "ckpt"),
                                      max_to_keep=config.ckpt_max_to_keep)
        if config.load_model:
            self.restore(config.load_model)
        elif self.ckpt.latest_epoch() is not None:
            self.restore()

    # ------------------------------------------------------------ utils
    def print_msg(self, msg: str, stdout: bool = True):
        if stdout:
            print(msg)
        print(msg, file=self._log_fh)
        self._log_fh.flush()

    def _pad(self, batch):
        """Pad batch to a multiple of grad_accum; returns (batch, n).

        Adds a (B,) validity weight vector 'w' so padded duplicate rows
        are masked out of losses and gradients (the reference trains on
        the exact partial final batch)."""
        n = len(batch["img"])
        rem = (-n) % self._pad_multiple
        if rem:
            batch = {k: np.concatenate([v, np.repeat(v[-1:], rem, 0)])
                     for k, v in batch.items()}
        w = np.zeros(n + rem, np.float32)
        w[:n] = 1.0
        batch = dict(batch, w=w)
        return batch, n

    def _upload(self, a) -> torch.Tensor:
        """A host array on the device: through pinned memory and a
        ``non_blocking`` copy on the steps' stream on a GPU
        (:func:`~awr_tpu_torch.data.device.upload`)."""
        if self._stream is None:
            return torch.from_numpy(np.ascontiguousarray(a))
        with torch.cuda.stream(self._stream):
            return data_device.upload(a, self.device)

    @staticmethod
    def _raw(ds) -> bool:
        return getattr(ds, "mode", "host") == "raw"

    def _stage(self, raw, ds):
        """A batch of dataset ``ds`` -> (device inputs, X, valid count);
        runs on the staging thread.  Host mode: the normalized ``img``,
        ``jt_uvd`` and ``w`` on the device, X the padded host batch.  Raw
        mode: the raw steps' inputs, X the crop parameters."""
        batch, n = self._pad(raw)
        if not self._raw(ds):
            dev = {k: self._upload(np.asarray(batch[k], np.float32))
                   for k in ("img", "jt_uvd", "w")}
            return dev, batch, n
        centers_uvd = xyz2uvd_np(batch["center_xyz"], ds.paras,
                                 ds.flip).astype(np.float64)
        p = crop_params_np(centers_uvd, batch["cube"], np.asarray(ds.paras),
                           self.cfg.img_size)
        f32 = lambda a: self._upload(np.asarray(a, np.float32))  # noqa: E731
        dev = dict(img=f32(batch["img"]), jt_xyz=f32(batch["jt_xyz"]),
                   centers_uvd=f32(centers_uvd), cubes=f32(batch["cube"]),
                   w=f32(batch["w"]))
        return dev, {k: self._upload(v) for k, v in p.items()}, n

    @staticmethod
    def _host(t) -> np.ndarray:
        """A device tensor (raw mode) or host array (host mode) as numpy."""
        if isinstance(t, torch.Tensor):
            return t.detach().cpu().numpy()
        return np.asarray(t)

    # ------------------------------------------------------------ train
    def _beat(self):
        """Progress heartbeat for the stall watchdog (no-op when off)."""
        if self._watchdog is not None:
            self._watchdog.beat()

    def train(self):
        """Epoch loop with optional stall detection.

        With ``Config.step_timeout_s`` set, a wedged device call
        terminates the process with ``watchdog.EXIT_STALLED`` so
        ``training/supervise.py`` can restart it; this Trainer
        auto-resumes from the newest committed checkpoint on
        construction.
        """
        if self.cfg.step_timeout_s:
            self._watchdog = Watchdog(
                self.cfg.step_timeout_s,
                on_stall=lambda m: self.print_msg(m, stdout=False),
                name=self.cfg.net).start()
        try:
            self._train_impl()
        finally:
            if self._watchdog is not None:
                self._watchdog.stop()
                self._watchdog = None

    def _train_impl(self):
        cfg = self.cfg
        if self.train_data is None:
            raise ValueError("no training dataset")
        eval_tool = Evaluator(cfg.img_size, self.train_data.paras,
                              self.train_data.flip, cfg.jt_num)
        # resume-aware epoch range (reference train.py:105)
        for epoch in range(self.best_records["epoch"] + 1,
                           cfg.max_epoch + 1):
            if cfg.scheduler == "step":
                lr = step_lr(cfg.lr, epoch, cfg.step)
            elif self.plateau is not None:
                lr = self.plateau.lr
            else:
                lr = cfg.lr
            set_learning_rate(self.optimizer, lr)

            losses, l_off, l_crd = [], 0.0, 0.0
            epoch_losses = []
            t0 = time.time()
            raw_mode = self._raw(self.train_data)
            # host-mode items draw their augmentation from the dataset's
            # one RandomState, so they load on one worker, in the
            # reference's order
            loader = PrefetchLoader(
                self.train_data, cfg.batch_size, shuffle=True,
                num_workers=cfg.num_workers if raw_mode else 1,
                rng=np.random.RandomState(cfg.seed + epoch))
            # stage (pad + H2D copy) device_prefetch batches ahead on a
            # background thread, overlapping the loading of batch i+1
            staged_iter = prefetch_to_device(
                iter(loader), lambda raw: self._stage(raw, self.train_data),
                cfg.device_prefetch)
            pending = []  # defer device->host syncs to print/epoch time
            for ii, (dev, x, n) in enumerate(staged_iter):
                if raw_mode:
                    self._gen.manual_seed(augment_seed(cfg.seed, epoch, ii))
                    aug = data_device.draw_augment_params(
                        self._gen, dev["img"].shape[0], *cfg.augment_para)
                    metrics = self._raw_train_step(dev, x, aug)
                    src = metrics
                else:
                    metrics = self._train_step(dev)
                    src = x
                fb = {k: src[k] for k in ("jt_xyz", "center_xyz", "M",
                                          "cube")}
                # keep everything on the device; the stream never stalls
                losses.append(metrics["loss"])
                epoch_losses.append(metrics["loss"])
                l_off, l_crd = metrics["loss_offset"], metrics["loss_coord"]
                pending.append((metrics["jt_uvd_pred"], n, fb))
                self._beat()
                if (ii + 1) % cfg.print_freq == 0:
                    self.print_msg(
                        "[epoch: {:02d}][train loss: {:.5f}]"
                        "[offset_loss: {:.5f}][coord_loss: {:.5f}]".format(
                            epoch,
                            float(np.mean([float(x) for x in losses])),
                            float(l_off), float(l_crd)))
                    losses = []
            for jt_pred, n, fb in pending:
                self._beat()  # the drain host-syncs; wedges surface here
                eval_tool.feed_batch(
                    self._host(jt_pred)[:n],
                    self._host(fb["jt_xyz"])[:n],
                    self._host(fb["center_xyz"])[:n],
                    self._host(fb["M"])[:n],
                    self._host(fb["cube"])[:n])
            train_mpe, _, _, _, _ = eval_tool.get_measures()
            eval_tool = Evaluator(cfg.img_size, self.train_data.paras,
                                  self.train_data.flip, cfg.jt_num)
            self.print_msg(
                "[epoch {:02d}], [train loss {:.5f}], [train mpe {:.5f}],"
                " [lr {:.1e}], [{:.1f}s]".format(
                    epoch,
                    (float(np.mean([float(x) for x in epoch_losses]))
                     if epoch_losses else 0.0),
                    train_mpe, lr, time.time() - t0))

            if self.plateau is not None:
                self.plateau.step(train_mpe)

            mpe, auc = self.test(epoch)
            if mpe < self.best_records["MPE"]:
                self.best_records.update(best_epoch=epoch, MPE=mpe,
                                         AUC=auc)
            self.best_records["epoch"] = epoch  # resume cursor
            self.save(epoch)
            self._beat()

    # ------------------------------------------------------------- eval
    def test(self, epoch: int = 0):
        cfg = self.cfg
        if self.test_data is None:
            raise ValueError("no test dataset")
        eval_tool = Evaluator(cfg.img_size, self.test_data.paras,
                              self.test_data.flip, cfg.jt_num)
        loss_sum, nb = 0.0, 0
        loader = PrefetchLoader(self.test_data, cfg.batch_size,
                                num_workers=cfg.num_workers)
        staged_iter = prefetch_to_device(
            iter(loader), lambda raw: self._stage(raw, self.test_data),
            cfg.device_prefetch)
        # dispatch every eval step without a host sync; materialize the
        # losses and joints afterwards
        raw_mode = self._raw(self.test_data)
        pending = []
        for ii, (dev, x, n) in enumerate(staged_iter):
            if raw_mode:
                metrics = self._raw_eval_step(dev, x)
                src = metrics
            else:
                metrics = self._eval_step(dev)
                src = x
            vis = bool(cfg.vis_freq) and (ii + 1) % cfg.vis_freq == 0
            keep = ("jt_xyz", "center_xyz", "M", "cube") + (
                ("img", "jt_uvd") if vis else ())
            pending.append((metrics["loss"], metrics["jt_uvd_pred"], n,
                            {k: src[k] for k in keep}, ii, vis))
            self._beat()
        for loss, jt_dev, n, fb, ii, vis in pending:
            self._beat()
            loss_sum += float(loss)
            nb += 1
            jt_pred = self._host(jt_dev)[:n]
            eval_tool.feed_batch(jt_pred, self._host(fb["jt_xyz"])[:n],
                                 self._host(fb["center_xyz"])[:n],
                                 self._host(fb["M"])[:n],
                                 self._host(fb["cube"])[:n])
            if vis:
                img_path = os.path.join(
                    self.result_dir,
                    f"test_epoch_{epoch}_iter_{ii + 1}.png")
                plot_pose(
                    self._host(fb["img"])[0],
                    img_path,
                    (jt_pred[0] + 1) * cfg.img_size / 2.0,
                    (self._host(fb["jt_uvd"])[0] + 1)
                    * cfg.img_size / 2.0,
                    dataset=cfg.dataset)

        mpe, mid, auc, pck, thresh = eval_tool.get_measures()
        eval_tool.plot_pck(
            os.path.join(self.work_dir, f"test_pck_epoch_{epoch}.png"),
            pck, thresh)
        if epoch in (0, -1):
            # reference writes the dump with the MPE in the filename
            # (train.py:217-221, test.py:105-108)
            eval_tool.save_predictions(
                os.path.join(self.work_dir, "test_%.3f.txt" % mpe))
        self.print_msg(
            "[epoch {:2d}], [test loss {:.5f}], [test mpe {:.3f}],"
            " [test auc {:.3f}]".format(
                epoch, loss_sum / max(nb, 1), mpe, auc))
        return mpe, auc

    # ------------------------------------------------------ checkpoints
    def save(self, epoch: int):
        plateau = ([self.plateau.lr, self.plateau.best,
                    float(self.plateau.num_bad)]
                   if self.plateau is not None else [0.0, 0.0, 0.0])
        self.ckpt.save(epoch, dict(
            model=self.model.state_dict(),
            optimizer=self.optimizer.state_dict(),
            best_records=dict(self.best_records),
            epoch=epoch,
            lr=get_learning_rate(self.optimizer),
            plateau=plateau,
        ))

    def restore(self, path: Optional[str] = None,
                epoch: Optional[int] = None):
        """Restore a checkpoint directory's epoch (default: this
        Trainer's own, latest epoch), or import the weights of a ``.pth``
        file (a reference state dict, or a dict holding one under
        'model', as this Trainer's checkpoints do) with the optimizer
        left fresh, as the reference restores (train.py loads weights,
        never optimizer state)."""
        if path and path.endswith(".pth"):
            pth = torch.load(path, map_location="cpu", weights_only=True)
            load_reference_state_dict(self.model, pth.get("model", pth))
            self.print_msg(f"imported reference weights from {path}")
            return
        mgr = CheckpointManager(path) if path else self.ckpt
        restored = mgr.restore(epoch)
        self.model.load_state_dict(restored["model"])
        self.optimizer.load_state_dict(restored["optimizer"])
        self.best_records = dict(restored["best_records"])
        # checkpoints written before 'best_epoch' existed
        self.best_records.setdefault("best_epoch",
                                     self.best_records["epoch"])
        if self.plateau is not None and "plateau" in restored:
            lr, best, bad = [float(x) for x in restored["plateau"]]
            if lr > 0:
                self.plateau.lr = lr
                self.plateau.best = best
                self.plateau.num_bad = int(bad)
        self.print_msg(
            f"restored checkpoint (epoch {self.best_records['epoch']})")

    def close(self):
        self.ckpt.close()
        self._log_fh.close()
