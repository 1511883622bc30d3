"""Tracing, step timing, FLOPs and the card's peak rates (the JAX
package's ``utils/profiling.py``).

- :func:`trace` wraps a block in a ``torch.profiler`` trace, written as
  a Chrome trace that Perfetto and ``chrome://tracing`` load;
- :class:`StepTimer` measures wall time per step, waiting for the
  step's device work, and keeps a rolling summary;
- :func:`flops_of` counts the FLOPs of a call with PyTorch's
  ``FlopCounterMode`` (convolutions, transposed convolutions and matrix
  products, from their shapes), where the JAX package asks XLA's cost
  model of the compiled program;
- :data:`CHIP_PEAKS`, :func:`chip_peak` and :func:`implied_mfu`: the
  one table of the card's peak rates that every harness reads
  (``chip_smoke.py`` too), and the utilization a throughput implies.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Dict, NamedTuple

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils.flop_counter import FlopCounterMode


@contextlib.contextmanager
def trace(log_dir: str):
    """``with trace('/tmp/tb'): step()`` -> ``<log_dir>/trace.json``: the
    host's operator calls and, on a GPU, the device's kernels."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _cuda_devices(tree, found: set) -> set:
    if isinstance(tree, torch.Tensor):
        if tree.device.type == "cuda":
            found.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, found)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, found)
    return found


class StepTimer:
    """Rolling step timer; call ``tick(result)`` once per step."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times = []
        self._last = None

    def start(self):
        self._last = time.perf_counter()

    def tick(self, result: Any = None) -> float:
        """Waits for the devices of the tensors in ``result`` (tensors,
        or dicts, lists and tuples of them) and records the seconds
        since the last tick (or :meth:`start`)."""
        for device in _cuda_devices(result, set()):
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        dt = now - (self._last if self._last is not None else now)
        self._last = now
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        return dt

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {}
        arr = np.asarray(self.times)
        return dict(mean_s=float(arr.mean()),
                    p50_s=float(np.median(arr)),
                    p95_s=float(np.percentile(arr, 95)),
                    steps_per_s=float(1.0 / max(arr.mean(), 1e-12)))


def flops_of(fn: Callable, *example_args) -> float:
    """FLOPs of ``fn(*example_args)`` as ``FlopCounterMode`` counts them:
    2 per multiply-add of each convolution, transposed convolution and
    matrix product; elementwise work (BatchNorm, activations, pooling)
    counts 0.  The arguments may live on the ``meta`` device, which
    counts without computing."""
    with FlopCounterMode(display=False) as counter:
        fn(*example_args)
    return float(counter.get_total_flops())


class ChipPeaks(NamedTuple):
    """Peak rates of one card, from NVIDIA's data sheets."""

    hbm_bytes_per_s: float
    fp32_flops: float  # float32, not on the tensor cores
    bf16_flops: float  # dense bf16 tensor-core FLOP/s
    int8_ops: float  # dense int8 tensor-core OP/s


# By substring of the device name, tried in this order.  The dense
# tensor-core rates are half the with-sparsity figures the data sheets
# lead with.  Used as ceilings (an implied utilization of 1 or more is
# refused) and for ``chip_smoke.py``'s bounds, never as targets.
CHIP_PEAKS = {
    "PCIe": ChipPeaks(2.0e12, 51e12, 756e12, 1513e12),
    "NVL": ChipPeaks(3.9e12, 60e12, 835e12, 1671e12),
    "H100": ChipPeaks(3.35e12, 67e12, 989e12, 1979e12),  # SXM
}


def chip_peaks(device=None) -> ChipPeaks:
    """The peak rates of ``device``: a CUDA device (default the current
    one) or a device name as ``torch.cuda.get_device_name`` gives it.
    Raises for a card the table does not hold."""
    name = device
    if isinstance(device, str):
        try:
            device = torch.device(device)
        except RuntimeError:  # not a device: a name
            pass
    if not isinstance(device, str):
        name = torch.cuda.get_device_name(device)
    for key, peaks in CHIP_PEAKS.items():
        if key in name:
            return peaks
    raise ValueError(f"no peak rates known for {name!r}")


def chip_peak(device=None) -> float:
    """Dense bf16 tensor-core peak FLOP/s of ``device``
    (:func:`chip_peaks`)."""
    return chip_peaks(device).bf16_flops


def implied_mfu(fps: float, flops_per_frame: float, device=None) -> float:
    """Model FLOPs utilization that a throughput implies against the
    card's bf16 peak.  1.0 or more is impossible, and is refused
    (``ValueError``) rather than reported."""
    mfu = fps * flops_per_frame / chip_peak(device)
    if mfu >= 1.0:
        raise ValueError(f"implied MFU {mfu:.3f} >= 1: {fps} frames/s at "
                         f"{flops_per_frame:.4g} FLOP a frame is more than "
                         f"the card's peak")
    return mfu
