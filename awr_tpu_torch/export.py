"""Saving and loading the serving programs of
:meth:`awr_tpu_torch.serving.Predictor.export_program` (the port's form of
the JAX package's ``Predictor.export_stablehlo``).

A program is a ``torch.export`` program: the backbone's forward with its
weights (and, after ``quantize``, its int8 scales), the decode, and for
the raw extent the device crop and the de-normalization, saved by
``torch.export.save`` with a small JSON record of its signature.

    from awr_tpu_torch import export
    prog = export.load("hourglass_1.pt2")          # device="cuda"
    uvd = prog.call(imgs_norm)                     # raw_hw=None
    uvd = prog.call(imgs_raw, crop_params, center_z, cube_z)   # raw_hw

**One deviation from the JAX payload.** A StableHLO payload runs with no
code of the package at all.  A ``torch.export`` program names the port's
kernels as ops (``awr_tpu_torch::decode`` and, for int8,
``awr_tpu_torch::int8_matmul`` and ``::deconv4x4s2_int8``), which must be
registered before it loads.  So :func:`load` imports
:mod:`awr_tpu_torch.ops.library` (and through it the kernels' wrappers,
which build the kernels at their first launch), and nothing of the
models, the Predictor or a weights file.  There is no ``platforms``
argument either: a program runs on the kind of device it was traced on.
"""

from __future__ import annotations

import io
import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

from awr_tpu_torch.ops import library  # noqa: F401  (registers the ops)

# the record of a program's signature inside its archive
META_FILE = "awr_tpu_torch.json"
FORMAT = 1
# the crop parameters of the raw extent in the order the program takes
# them (``data.transforms.crop_params_np``'s keys): int32, but for
# FLOAT_KEYS float32
CROP_KEYS = ("us", "ue", "vs", "ve", "zs", "ze", "sw", "sh", "tx", "ty", "M")
FLOAT_KEYS = ("zs", "ze", "M")


def save(program: torch.export.ExportedProgram, meta: dict,
         path: Optional[str] = None) -> bytes:
    """``torch.export.save`` of ``program`` with ``meta`` (its device,
    batch size and extent) beside it; the bytes, also written to
    ``path`` if one is given."""
    buf = io.BytesIO()
    torch.export.save(program, buf, extra_files={
        META_FILE: json.dumps(dict(meta, format=FORMAT))})
    payload = buf.getvalue()
    if path:
        with open(path, "wb") as fh:
            fh.write(payload)
    return payload


class ExportedPredictor:
    """A loaded program.  :meth:`call` has the JAX payload's ``.call``
    signature: ``call(imgs_norm)`` for ``raw_hw`` None, else ``call(
    imgs_raw, crop_params, center_z, cube_z)``.  Inputs are numpy arrays
    or tensors (moved to the program's device and cast to its dtypes);
    the result is a (B, J, 3) float32 tensor on that device."""

    def __init__(self, program: torch.export.ExportedProgram, meta: dict):
        self.meta = meta
        self.device = torch.device(meta["device"])
        self.batch_size = int(meta["batch_size"])
        self.raw_hw: Optional[Tuple[int, int]] = (
            None if meta["raw_hw"] is None else tuple(meta["raw_hw"]))
        self._module = program.module()

    def _tensor(self, a, dtype) -> torch.Tensor:
        if not isinstance(a, torch.Tensor):
            # contiguous: ``torch.from_numpy`` refuses negative strides
            a = torch.from_numpy(np.ascontiguousarray(a))
        return a.to(self.device, dtype)

    def call(self, *args) -> torch.Tensor:
        f32 = torch.float32
        with torch.inference_mode():
            if self.raw_hw is None:
                (img,) = args
                return self._module(self._tensor(img, f32))
            imgs_raw, crop_params, center_z, cube_z = args
            p = {k: self._tensor(crop_params[k],
                                 f32 if k in FLOAT_KEYS else torch.int32)
                 for k in CROP_KEYS}
            return self._module(self._tensor(imgs_raw, f32), p,
                                self._tensor(center_z, f32),
                                self._tensor(cube_z, f32))

    __call__ = call


def load(path_or_bytes, device=None) -> ExportedPredictor:
    """Load a program that ``Predictor.export_program`` saved (a path or
    its bytes).  ``device``: CUDA unless named; it must be of the kind the
    program was traced on (without a GPU, a CPU program and ``"cpu"``)."""
    src = (io.BytesIO(path_or_bytes)
           if isinstance(path_or_bytes, (bytes, bytearray))
           else os.fspath(path_or_bytes))
    want = torch.device("cuda" if device is None else device)
    if want.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to load a program "
            "traced on the CPU")
    extra = {META_FILE: ""}
    program = torch.export.load(src, extra_files=extra)
    meta = json.loads(extra[META_FILE])
    if meta.get("format") != FORMAT:
        raise ValueError(f"not a program of Predictor.export_program "
                         f"(format {meta.get('format')!r})")
    if torch.device(meta["device"]).type != want.type:
        raise ValueError(f"the program was traced on {meta['device']} and "
                         f"runs there, not on {want}")
    return ExportedPredictor(program, meta)
