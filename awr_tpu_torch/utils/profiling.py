"""Tracing, FLOPs and the card's peak rates (the JAX package's
``utils/profiling.py``).

- :func:`trace` wraps a block in a ``torch.profiler`` trace, written as
  a Chrome trace that Perfetto and ``chrome://tracing`` load;
- :func:`span` names a phase of the program's host work in whatever
  profiler is recording (``trace``'s, or a benchmark's), on the clock
  of the device's kernels, so that the trace says which host work the
  device waited for;
- :func:`flops_of` counts the FLOPs of a call with PyTorch's
  ``FlopCounterMode`` (convolutions, transposed convolutions and matrix
  products, from their shapes), where the JAX package asks XLA's cost
  model of the compiled program;
- :data:`CHIP_PEAKS` and :func:`chip_peaks`: the one table of the
  card's peak rates (``chip_smoke.py`` reads it).
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, NamedTuple

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _autograd_profiler
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


# what :func:`span` returns while no profiler records: one shared,
# stateless context
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """``with span("serving.pad"): ...`` records the block as the range
    ``awr_tpu_torch.serving.pad`` while a ``torch.profiler`` records
    (the dot keeps the program's ranges apart from its custom ops,
    ``awr_tpu_torch::decode``), and does nothing otherwise.

    Off, it reads one flag and returns a shared no-op: it formats no
    string and builds no object (a range built with no profiler running
    still costs microseconds).  On, the range is an operator-scope
    ``RecordFunction`` (``_RecordFunctionFast``), not the user-scope one
    of ``record_function``: for a user-scope range around device work
    the profiler also writes a device-side range spanning its kernels,
    which a reader of the device's intervals would count as busy time
    (and the idle gaps between those kernels would vanish)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _RecordFunctionFast("awr_tpu_torch." + name)


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
# lead with.  Used for ``chip_smoke.py``'s bounds, never as targets.
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
