"""Batch inference API: raw depth frames -> camera-coordinate joints.

``Predictor`` packages the reference's test loop (crop -> forward ->
decode -> de-normalize, test.py:61-108) as one call: crop parameters on
the host, crop and normalize on the device, the backbone forward, the
AWR decode (the hand-written CUDA kernel on a GPU), and the
de-normalization back to (u px, v px, d mm) in the original camera
frame, the reference's results/*.txt convention.
:meth:`Predictor.export_program` saves either extent as a ``torch.export``
program (:mod:`awr_tpu_torch.export` loads it).  :meth:`Predictor.quantize`
switches a Predictor of either backbone to int8 inference,
:meth:`Predictor.quantize_qat` after a validated QAT fine-tune.  The backbone runs
in ``config.compute_dtype`` (float32 or bfloat16; the weights stay
float32), the decode on its float32 map.

Data mode (the JAX package's ``Predictor(mesh=make_mesh(...))``): with a
:class:`~awr_tpu_torch.parallel.mesh.Mesh` of more than one device the
Predictor holds one replica of the model on each, pads a batch to a
bucket that divides by the mesh size, and runs each replica on its
contiguous block of it, on its own device and stream.

Spatial mode (``Predictor(mesh=spatial_mesh(...))``, the mode chosen by
the mesh's axis name as in the JAX package): a replica on each device
too, but each request's normalized frames are split by image rows into
one band a device, the backbone runs band by band with halo rows
exchanged between neighbours, each band's map rows are decoded by the
row-window decode, and the bands' softmax statistics are merged on the
first device (:mod:`awr_tpu_torch.parallel.spatial`).  A latency mode:
even a batch-1 request spreads over the mesh.  The image rows must
divide by the mesh size.
"""

from __future__ import annotations

import copy
from typing import Optional

import numpy as np
import torch
from torch import nn

from awr_tpu_torch import export
from awr_tpu_torch.config import Config, resolve_device
from awr_tpu_torch.data.device import (crop_normalize, crop_normalize_batch,
                                       upload)
from awr_tpu_torch.geometry import uvd2xyz_np, xyz2uvd_np
from awr_tpu_torch.models import build_model
from awr_tpu_torch.models.common import set_compute_dtype
from awr_tpu_torch.models.quant import calibrate, set_int8
from awr_tpu_torch.models.weights import load_reference_state_dict
from awr_tpu_torch.parallel.mesh import SPATIAL_AXIS, data_sharding
from awr_tpu_torch.parallel.spatial import make_spatial_infer_step, on_device
from awr_tpu_torch.training import qat
from awr_tpu_torch.training.steps import infer, make_infer_step
from awr_tpu_torch.utils.profiling import span


def denormalize_uvd(pred: torch.Tensor, M: torch.Tensor,
                    center_z: torch.Tensor, cube_z: torch.Tensor,
                    img_size: int) -> torch.Tensor:
    """Normalized (B, J, 3) uvd -> camera (u px, v px, d mm) on the
    device, all in float32 with a float32 inverse of the (B, 3, 3) crop
    affine ``M`` (the JAX package's in-graph de-normalization;
    :meth:`Predictor.denormalize` inverts ``M`` in float64 on the host;
    the tests hold the two within 0.01 px, the JAX package's bar)."""
    uv_px = (pred[..., :2] + 1.0) * (img_size / 2.0)
    d_mm = pred[..., 2] * cube_z[:, None] / 2.0 + center_z[:, None]
    uv1 = torch.cat([uv_px, torch.ones_like(uv_px[..., :1])], -1)
    # inv_ex: no host sync (and no singularity check)
    uv = torch.einsum("bij,bkj->bki", torch.linalg.inv_ex(M).inverse, uv1)
    return torch.cat([uv[..., :2], d_mm[..., None]], -1)


class _NormalizedProgram(nn.Module):
    """``raw_hw=None``: (B, S, S) normalized depth -> (B, J, 3)
    normalized uvd, :meth:`Predictor.predict_normalized` without the
    buckets."""

    def __init__(self, model: nn.Module, kernel_size: float):
        super().__init__()
        self.model = model
        self.kernel_size = kernel_size

    def forward(self, img):
        return infer(self.model, img, self.kernel_size)


class _RawProgram(_NormalizedProgram):
    """``raw_hw=(H0, W0)``: raw (B, H0, W0) mm frames, the crop
    parameters, (B,) center and cube depths -> (B, J, 3) camera (u px, v
    px, d mm): :meth:`Predictor.predict` past the host's crop
    parameters."""

    def __init__(self, model: nn.Module, kernel_size: float, img_size: int):
        super().__init__(model, kernel_size)
        self.img_size = img_size

    def forward(self, imgs_raw, crop_params, center_z, cube_z):
        p = {k: v for k, v in crop_params.items() if k != "M"}
        img = crop_normalize(imgs_raw, p, center_z, cube_z, self.img_size)
        return denormalize_uvd(infer(self.model, img, self.kernel_size),
                               crop_params["M"], center_z, cube_z,
                               self.img_size)


def _to_host(out: torch.Tensor):
    """Start copying ``out`` to the host: on a GPU into a pinned host
    tensor, ``non_blocking``, and an event recorded after the copy on the
    device's current stream.  Returns ``(host tensor, event or None)``:
    the host tensor is ready once the event has completed."""
    if out.device.type != "cuda":
        return out, None
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    host.copy_(out, non_blocking=True)
    copied = torch.cuda.Event()
    copied.record(torch.cuda.current_stream(out.device))
    return host, copied


class Predictor:
    def __init__(self, config: Config, model_or_state, paras=None,
                 flip: Optional[int] = None, device=None, mesh=None):
        """``model_or_state``: the backbone as an ``nn.Module`` (moved to
        ``device`` and set to ``config.compute_dtype``), or a state dict in
        the reference's key layout.  ``device``: CUDA unless named;
        without a GPU, name "cpu".

        ``mesh``: a :class:`~awr_tpu_torch.parallel.mesh.Mesh` of more than
        one device serves in data mode, or in spatial mode on a
        ``spatial_mesh`` (the module docstring); the model then lives on
        ``mesh.devices[0]`` (``device`` must be that one or None) and a
        replica on each other mesh device.  A mesh of one device is no
        mesh, as in the JAX package."""
        self.cfg = config
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self._spatial = (self.mesh is not None
                         and self.mesh.axis_name == SPATIAL_AXIS)
        if self.mesh is not None:
            for d in self.mesh.devices:
                resolve_device(d)
            if device is not None and torch.device(
                    device) != self.mesh.devices[0]:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"first device {self.mesh.devices[0]}")
            device = self.mesh.devices[0]
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
        self._replicate()
        # calibrated int8 activation scales by layer name, once quantized
        self.quant = None
        # the holdout scores of the last validated quantize_qat
        self.qat_validation = None
        # real rows and padding rows sent to the device (the server's
        # /healthz reads their share)
        self.n_frames = 0
        self.n_padded_rows = 0

    def _replicate(self) -> None:
        """``self._replicas``: ``(device, model, infer step)`` of
        ``self.model`` and, under a mesh, of a copy of it (weights,
        BatchNorm statistics, quantization mode and int8 scales) on each
        other mesh device; ``self._infer``: the first replica's step, or
        in spatial mode the step that runs the replicas band by band."""
        self._replicas = [(self.device, self.model,
                           make_infer_step(self.model, self.cfg))]
        for d in (self.mesh.devices[1:] if self.mesh is not None else ()):
            replica = copy.deepcopy(self.model).to(d).eval()
            self._replicas.append((d, replica,
                                   make_infer_step(replica, self.cfg)))
        self._infer = (make_spatial_infer_step(
            self.mesh, [m for _, m, _ in self._replicas],
            self.cfg.kernel_size) if self._spatial else self._replicas[0][2])

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
        serves in it too.  The weights are reused unchanged.  Under a mesh
        the calibration runs on the first device and every replica gets
        its scales.
        ``percentile``: the calibration statistic; the default p99.99
        clips activation outliers (the JAX package measured it better
        than the max on trained nets)."""
        # contiguous: ``torch.from_numpy`` refuses a view with negative
        # strides
        imgs = np.ascontiguousarray(calib_imgs_normalized, np.float32)
        if imgs.ndim != 3 or len(imgs) == 0:
            raise ValueError(f"expected (N, S, S) frames, got {imgs.shape}")
        batches = [torch.from_numpy(imgs[i:i + 32]).to(self.device)
                   for i in range(0, len(imgs), 32)]
        self.quant = calibrate(self.model, batches, percentile=percentile)
        self._switch_int8()

    def _switch_int8(self) -> None:
        """Serve the int8 forward with the scales in ``self.quant``, on
        every replica."""
        set_int8(self.model, {k: v.to(self.device)
                              for k, v in self.quant.items()})
        self._replicate()

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
        they were.  Under a mesh they run on the first device, as the JAX
        package's run on one device; every replica then gets the kept
        weights and the scales."""
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
        self.quant = quant
        self._switch_int8()
        if validation is not None:
            self.qat_validation = validation
        return losses

    def export_program(self, batch_size: int, path: Optional[str] = None,
                       raw_hw: Optional[tuple] = None) -> bytes:
        """Save the serving graph as a ``torch.export`` program (the JAX
        package's ``export_stablehlo``), traced on this Predictor's device
        in its compute dtype, int8 after :meth:`quantize` or
        :meth:`quantize_qat`: the weights and the int8 scales are in the
        program, the layers' mode and dtype fixed as they are now.
        Returns the bytes (``torch.export.save`` and the signature
        :func:`awr_tpu_torch.export.load` reads), written to ``path`` too
        if one is given.

        ``raw_hw=None``: the program takes (batch_size, S, S) float32
        normalized depth and returns (batch_size, J, 3) normalized uvd,
        :meth:`predict_normalized` without the bucketing.

        ``raw_hw=(H0, W0)``: ``call(imgs_raw, crop_params, center_z,
        cube_z)`` takes (batch_size, H0, W0) float32 raw mm frames, the
        dict of ``data.transforms.crop_params_np`` (int32 ``us ue vs ve
        sw sh tx ty``, float32 ``zs ze`` and the (B, 3, 3) ``M``) and (B,)
        float32 center and cube depths, and returns (batch_size, J, 3)
        camera (u px, v px, d mm): the device crop, the forward, the
        decode and :func:`denormalize_uvd` (a float32 inverse of ``M``).

        The program names the kernels as the ops of
        :mod:`awr_tpu_torch.ops.library`, so loading it needs them
        registered (``awr_tpu_torch.export.load`` imports them), and it
        runs on the kind of device it was traced on: the deviations from a
        StableHLO payload (:mod:`awr_tpu_torch.export`).  Under a mesh, data
        or spatial, the program is traced on the first replica's device
        and holds one device's graph (a ``torch.export`` program runs on
        one device; no band is split), where the JAX package exports the
        mesh's sharded program."""
        B, size, dev = int(batch_size), self.cfg.img_size, self.device
        if raw_hw is None:
            program = _NormalizedProgram(self.model, self.cfg.kernel_size)
            args = (torch.zeros((B, size, size), device=dev),)
        else:
            raw_hw = tuple(int(x) for x in raw_hw)
            program = _RawProgram(self.model, self.cfg.kernel_size, size)
            crop = {k: torch.zeros(B, dtype=torch.int32, device=dev)
                    for k in export.CROP_KEYS}
            crop.update(zs=torch.zeros(B, device=dev),
                        ze=torch.zeros(B, device=dev),
                        M=torch.eye(3, device=dev).expand(B, 3, 3).clone())
            args = (torch.zeros((B,) + raw_hw, device=dev), crop,
                    torch.zeros(B, device=dev), torch.zeros(B, device=dev))
        with torch.no_grad():
            traced = torch.export.export(program.eval(), args)
        # the zeros it was traced on are not worth saving (39 MB of raw
        # frames at B = 32)
        traced.example_inputs = None
        return export.save(traced, dict(device=str(dev), batch_size=B,
                                        raw_hw=raw_hw), path)

    def _bucket(self, n: int) -> int:
        """Pad batch size up to a power-of-two bucket (min 8), so the
        device sees a few batch shapes, whatever the clients send.  Under
        a data mesh the bucket is also at least the mesh size and rounded
        up to a multiple of it, so that it splits evenly (the JAX rule); a
        spatial mesh splits rows, not the batch, and rounds nothing."""
        b = 8
        while b < n:
            b *= 2
        if self.mesh is not None and not self._spatial:
            size = self.mesh.size
            b = max(b, size)
            b = -(-b // size) * size
        return b

    def _on_mesh(self, bucket: int, run):
        """``run(device, infer, rows) -> joints on device`` for each
        replica and its contiguous block ``rows`` of the ``bucket``, each
        on its own device; each result copied back as :func:`_to_host`
        copies.  Returns ``wait() -> (bucket, J, 3)`` numpy, which waits
        on every device's event."""
        copies = []
        for (dev, _, infer), rows in zip(
                self._replicas, data_sharding(self.mesh).slices(bucket)):
            with on_device(dev):
                copies.append(_to_host(run(dev, infer, rows)))

        def wait() -> np.ndarray:
            with span("serving.wait"):
                for _, event in copies:
                    if event is not None:
                        event.synchronize()
            return np.concatenate([host.numpy() for host, _ in copies])

        return wait

    def _pad(self, a: np.ndarray, bucket: int) -> np.ndarray:
        """Pad rows to ``bucket`` by repeating the last row."""
        if bucket == len(a):
            return a
        return np.concatenate([a, np.repeat(a[-1:], bucket - len(a), 0)])

    def predict_normalized(self, img_norm) -> np.ndarray:
        """(B, S, S) normalized depth -> (B, J, 3) normalized uvd.
        Padding rows are discarded."""
        # contiguous: the pad copies nothing at a full bucket
        img_norm = np.ascontiguousarray(img_norm, np.float32)
        n = len(img_norm)
        if n == 0:
            raise ValueError("empty batch: predict_normalized needs at "
                             "least one frame")
        bucket = self._bucket(n)
        if self.mesh is not None and not self._spatial:
            img = self._pad(img_norm, bucket)
            out = self._on_mesh(bucket, lambda dev, infer, rows: infer(
                upload(img[rows], dev)))()[:n]
        else:
            img = torch.from_numpy(self._pad(img_norm, bucket))
            out = self._infer(img.to(self.device))[:n].cpu().numpy()
        self._count(n, bucket)
        return out

    def _count(self, n: int, bucket: int) -> None:
        """Count a call's ``n`` real rows and its padding up to
        ``bucket``."""
        self.n_frames += n
        self.n_padded_rows += bucket - n

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
        (the overlap :mod:`awr_tpu_torch.batching` pipelines on).  Under a
        data mesh each replica crops and infers its block of the padded
        batch on its device, each device records its own event, and
        ``finalize`` waits on all of them.  Under a spatial mesh the first
        device crops, the bands run on their devices, and the joints,
        merged on the first device, come back as on one device."""
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
        if self.mesh is not None and not self._spatial:
            finalize = self._predict_async_mesh(imgs, centers_xyz,
                                                centers_uvd, cubes, bucket)
        else:
            img_n, M_p = crop_normalize_batch(
                self._frames_on_device(imgs, bucket),
                self._pad(centers_uvd, bucket), self._pad(cubes, bucket),
                np.asarray(self.paras), self.cfg.img_size)
            M = M_p[:B]
            out_host, copied = _to_host(self._infer(img_n)[:B])

            def finalize() -> np.ndarray:
                with span("serving.wait"):
                    if copied is not None:
                        copied.synchronize()
                return self.denormalize(out_host.numpy(), centers_xyz, M,
                                        cubes)
        self._count(B, bucket)
        return finalize

    def _predict_async_mesh(self, imgs, centers_xyz, centers_uvd, cubes,
                            bucket):
        """:meth:`predict_async` under a mesh."""
        B = len(imgs)
        with span("serving.pad"):
            frames = self._pad(imgs, bucket)
        centers_p, cubes_p = (self._pad(centers_uvd, bucket),
                              self._pad(cubes, bucket))
        Ms = []

        def run(dev, infer, rows):
            img_n, M = crop_normalize_batch(
                upload(frames[rows], dev), centers_p[rows], cubes_p[rows],
                np.asarray(self.paras), self.cfg.img_size)
            Ms.append(M)
            return infer(img_n)

        wait = self._on_mesh(bucket, run)

        def finalize() -> np.ndarray:
            return self.denormalize(wait()[:B], centers_xyz,
                                    np.concatenate(Ms)[:B], cubes)

        return finalize

    def _frames_on_device(self, imgs: np.ndarray, bucket: int):
        """The raw frames padded to ``bucket`` rows (:meth:`_pad`) on the
        device; on a GPU padded straight into a pinned buffer (by
        PyTorch's copy, which splits a large copy over its threads) and
        copied ``non_blocking``."""
        with span("serving.pad"):
            if self.device.type != "cuda":
                return torch.from_numpy(self._pad(imgs, bucket))
            src = torch.from_numpy(imgs)
            host = torch.empty((bucket,) + imgs.shape[1:],
                               dtype=torch.float32, pin_memory=True)
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
