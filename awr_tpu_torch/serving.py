"""Batch inference API: raw depth frames -> camera-coordinate joints.

``Predictor`` packages the reference's test loop (crop -> forward ->
decode -> de-normalize, test.py:61-108) as one call: crop parameters on
the host, crop and normalize on the device, the backbone forward, the
AWR decode (the hand-written CUDA kernel on a GPU), and the
de-normalization back to (u px, v px, d mm) in the original camera
frame, the reference's results/*.txt convention.  :meth:`Predictor.quantize`
switches a Predictor of either backbone to int8 inference,
:meth:`Predictor.quantize_qat` after a validated QAT fine-tune.  The backbone runs
in ``config.compute_dtype`` (float32 or bfloat16; the weights stay
float32), the decode on its float32 map.
"""

from __future__ import annotations

import copy
from typing import Optional

import numpy as np
import torch
from torch import nn

from awr_tpu_torch.config import Config, resolve_device
from awr_tpu_torch.data.device import crop_normalize_batch
from awr_tpu_torch.geometry import uvd2xyz_np, xyz2uvd_np
from awr_tpu_torch.models import build_model
from awr_tpu_torch.models.common import set_compute_dtype
from awr_tpu_torch.models.quant import calibrate, set_int8
from awr_tpu_torch.models.weights import load_reference_state_dict
from awr_tpu_torch.training import qat
from awr_tpu_torch.training.steps import make_infer_step


class Predictor:
    def __init__(self, config: Config, model_or_state, paras=None,
                 flip: Optional[int] = None, device=None):
        """``model_or_state``: the backbone as an ``nn.Module`` (moved to
        ``device`` and set to ``config.compute_dtype``), or a state dict in
        the reference's key layout.  ``device``: CUDA unless named;
        without a GPU, name "cpu"."""
        self.cfg = config
        self.device = resolve_device(device)
        self.paras = paras if paras is not None else config.paras
        self.flip = flip if flip is not None else config.flip
        dtype = config.torch_compute_dtype
        if isinstance(model_or_state, nn.Module):
            model = set_compute_dtype(model_or_state, dtype)
        else:
            model = load_reference_state_dict(
                build_model(config.net, config.jt_num, config.downsample,
                            compute_dtype=dtype),
                model_or_state)
        self.model = model.to(self.device).eval()
        self._infer = make_infer_step(self.model, config)
        # calibrated int8 activation scales by layer name, once quantized
        self.quant = None
        # the holdout scores of the last validated quantize_qat
        self.qat_validation = None

    @classmethod
    def from_checkpoint(cls, config: Config, ckpt_dir: str,
                        epoch: Optional[int] = None, **kw):
        """Load the weights of a Trainer checkpoint directory's epoch
        (default the latest) through
        :class:`~awr_tpu_torch.training.checkpoints.CheckpointManager`;
        creates no optimizer, log file or workdir."""
        from awr_tpu_torch.training.checkpoints import CheckpointManager

        mgr = CheckpointManager(ckpt_dir)
        try:
            restored = mgr.restore(epoch)
        finally:
            mgr.close()
        return cls(config, restored["model"], **kw)

    @classmethod
    def from_torch(cls, config: Config, pth_path: str, **kw):
        """Load reference-trained weights from a ``.pth`` (the model's
        state dict, or a dict holding it under 'model')."""
        pth = torch.load(pth_path, map_location="cpu", weights_only=True)
        return cls(config, pth.get("model", pth), **kw)

    def quantize(self, calib_imgs_normalized,
                 percentile: float = 99.99) -> None:
        """Switch this Predictor to int8 inference (``models/quant.py``).

        ``calib_imgs_normalized``: (N, S, S) normalized depth frames (the
        input of :meth:`predict_normalized`) that calibrate each layer's
        activation scale, in batches of 32 (the percentile is taken per
        batch, then maxed over batches, as the JAX package does), through
        the float forward in the compute dtype; the int8 forward then
        serves in it too.  The weights are reused unchanged.
        ``percentile``: the calibration statistic; the default p99.99
        clips activation outliers (the JAX package measured it better
        than the max on trained nets)."""
        imgs = np.asarray(calib_imgs_normalized, np.float32)
        if imgs.ndim != 3 or len(imgs) == 0:
            raise ValueError(f"expected (N, S, S) frames, got {imgs.shape}")
        batches = [torch.from_numpy(imgs[i:i + 32]).to(self.device)
                   for i in range(0, len(imgs), 32)]
        self.quant = calibrate(self.model, batches, percentile=percentile)
        self._switch_int8()

    def _switch_int8(self) -> None:
        """Serve the int8 forward with the scales in ``self.quant``."""
        set_int8(self.model, {k: v.to(self.device)
                              for k, v in self.quant.items()})

    def quantize_qat(self, labeled_batches, steps: Optional[int] = None,
                     lr: Optional[float] = None, percentile: float = 99.99,
                     holdout_batches=None) -> list:
        """Switch to int8 inference after a quantization-aware fine-tune
        (:func:`awr_tpu_torch.training.qat.finetune`) of a copy of the
        weights; returns the per-step losses.

        ``labeled_batches``: dicts of ``img`` (B, S, S) normalized depth
        and ``jt_uvd`` (B, J, 3) normalized targets
        (``training.qat.batches_from_dataset``); they calibrate the
        scales unless an earlier :meth:`quantize` did, whose scales are
        kept.  ``steps``/``lr`` default to the gentle recipe
        (``training.qat.gap_scaled_recipe``, 100 at 1e-5).

        ``holdout_batches`` (the same format, data the fine-tune does not
        see) validates it: the PTQ and the fine-tuned weights are scored
        in int8 with the same scales, and unless the fine-tune's mean
        joint error (not its loss) is as low or lower (a NaN, from a
        fine-tune that diverged, is not), the Predictor serves the PTQ
        weights and BatchNorm statistics as they were.  The scores go to
        ``self.qat_validation`` (``ptq_loss``, ``qat_loss``,
        ``ptq_joint_err``, ``qat_joint_err``, ``fell_back``).

        The fine-tune and the scoring run on copies: an exception leaves
        the model, its mode, ``self.quant`` and ``qat_validation`` as
        they were."""
        d_steps, d_lr = qat.gap_scaled_recipe()
        model, quant, losses = qat.finetune(
            self.cfg, self.model, labeled_batches,
            steps=d_steps if steps is None else steps,
            lr=d_lr if lr is None else lr, percentile=percentile,
            quant=self.quant)
        validation = None
        if holdout_batches:
            ptq = copy.deepcopy(self.model)
            ptq_m, qat_m = qat.int8_holdout_metrics(
                self.cfg, quant, holdout_batches, ptq, model)
            # a fine-tune whose joints are not finite scores NaN: kept
            # only if it scores no worse
            fell_back = not qat_m["joint_err"] <= ptq_m["joint_err"]
            validation = dict(ptq_loss=ptq_m["loss"], qat_loss=qat_m["loss"],
                              ptq_joint_err=ptq_m["joint_err"],
                              qat_joint_err=qat_m["joint_err"],
                              fell_back=fell_back)
            if fell_back:
                model = ptq
        self.model = model.eval()
        self._infer = make_infer_step(self.model, self.cfg)
        self.quant = quant
        self._switch_int8()
        if validation is not None:
            self.qat_validation = validation
        return losses

    def _bucket(self, n: int) -> int:
        """Pad batch size up to a power-of-two bucket (min 8), so the
        device sees a few batch shapes, whatever the clients send."""
        b = 8
        while b < n:
            b *= 2
        return b

    def _pad(self, a: np.ndarray, bucket: int) -> np.ndarray:
        """Pad rows to ``bucket`` by repeating the last row."""
        if bucket == len(a):
            return a
        return np.concatenate([a, np.repeat(a[-1:], bucket - len(a), 0)])

    def predict_normalized(self, img_norm) -> np.ndarray:
        """(B, S, S) normalized depth -> (B, J, 3) normalized uvd.
        Padding rows are discarded."""
        img_norm = np.asarray(img_norm, np.float32)
        n = len(img_norm)
        if n == 0:
            raise ValueError("empty batch: predict_normalized needs at "
                             "least one frame")
        img = torch.from_numpy(self._pad(img_norm, self._bucket(n)))
        out = self._infer(img.to(self.device))
        return out[:n].cpu().numpy()

    def predict(self, imgs, centers_xyz, cubes=None) -> np.ndarray:
        """Raw frames -> camera-coordinate joints.

        Args:
          imgs: (B, H0, W0) raw mm depth frames.
          centers_xyz: (B, 3) hand centers, camera xyz mm.
          cubes: (B, 3) crop cubes mm (defaults to config.cube).
        Returns:
          (B, J, 3) joints as (u px, v px, d mm) in the original camera
          frame.
        """
        return self.predict_async(imgs, centers_xyz, cubes)()

    def predict_async(self, imgs, centers_xyz, cubes=None):
        """Enqueue crop, forward and decode on the device without waiting
        for them; returns ``finalize() -> (B, J, 3)``, which waits and
        de-normalizes.  The raw batch is padded to its bucket before the
        crop.

        On a GPU nothing here waits for the device: the uploads go through
        pinned memory with ``non_blocking`` copies, and the joints come back
        the same way, into a pinned host tensor, before an event recorded
        on the stream.  ``finalize`` waits on that event alone, so a second
        call's work, enqueued after it, never delays the first's result
        (the overlap :mod:`awr_tpu_torch.batching` pipelines on)."""
        # contiguous: ``torch.from_numpy`` refuses a view with negative
        # strides, which the pad no longer copies away on a GPU
        imgs = np.ascontiguousarray(imgs, np.float32)
        centers_xyz = np.asarray(centers_xyz, np.float64)
        B = len(imgs)
        if B == 0:
            raise ValueError("empty batch: predict needs at least one frame")
        if cubes is None:
            cubes = np.tile(np.asarray(self.cfg.cube, np.float64), (B, 1))
        cubes = np.asarray(cubes)
        centers_uvd = xyz2uvd_np(centers_xyz, self.paras, self.flip)
        bucket = self._bucket(B)
        img_n, M_p = crop_normalize_batch(
            self._frames_on_device(imgs, bucket),
            self._pad(centers_uvd, bucket), self._pad(cubes, bucket),
            np.asarray(self.paras), self.cfg.img_size)
        out_dev = self._infer(img_n)[:B]
        M = M_p[:B]
        if self.device.type != "cuda":
            def finalize() -> np.ndarray:
                return self.denormalize(out_dev.numpy(), centers_xyz, M,
                                        cubes)
            return finalize

        out_host = torch.empty(out_dev.shape, dtype=out_dev.dtype,
                               pin_memory=True)
        out_host.copy_(out_dev, non_blocking=True)
        copied = torch.cuda.Event()
        copied.record(torch.cuda.current_stream(self.device))

        def finalize() -> np.ndarray:
            copied.synchronize()
            return self.denormalize(out_host.numpy(), centers_xyz, M, cubes)

        return finalize

    def _frames_on_device(self, imgs: np.ndarray, bucket: int):
        """The raw frames padded to ``bucket`` rows (:meth:`_pad`) on the
        device; on a GPU padded straight into a pinned buffer (by
        PyTorch's copy, which splits a large copy over its threads) and
        copied ``non_blocking``."""
        if self.device.type != "cuda":
            return torch.from_numpy(self._pad(imgs, bucket))
        src = torch.from_numpy(imgs)
        host = torch.empty((bucket,) + imgs.shape[1:], dtype=torch.float32,
                           pin_memory=True)
        host[:len(imgs)].copy_(src)
        host[len(imgs):].copy_(src[-1:].expand_as(host[len(imgs):]))
        return host.to(self.device, non_blocking=True)

    def denormalize(self, pred, centers_xyz, M, cubes) -> np.ndarray:
        """Normalized (B, J, 3) uvd -> camera (u px, v px, d mm)."""
        out = np.array(pred, np.float32, copy=True)
        cubes = np.asarray(cubes, np.float32)
        centers_xyz = np.asarray(centers_xyz, np.float32)
        out[..., :2] = (out[..., :2] + 1) * self.cfg.img_size / 2.0
        out[..., 2] = (out[..., 2] * cubes[:, None, 2] / 2.0
                       + centers_xyz[:, None, 2])
        M_inv = np.linalg.inv(np.asarray(M, np.float64)).astype(np.float32)
        uv1 = np.concatenate(
            [out[..., :2], np.ones_like(out[..., :1])], -1)
        uv = np.einsum("bij,bkj->bki", M_inv, uv1)
        out[..., :2] = uv[..., :2]
        return out

    def predict_xyz(self, imgs, centers_xyz, cubes=None) -> np.ndarray:
        """Raw frames -> camera xyz mm joints."""
        uvd = self.predict(imgs, centers_xyz, cubes)
        return uvd2xyz_np(uvd, self.paras, self.flip)
