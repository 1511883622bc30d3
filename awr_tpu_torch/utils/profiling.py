"""Tracing (the JAX package's ``utils/profiling.py``, its ``trace``
only): a ``torch.profiler`` trace of a block, written as a Chrome trace
that Perfetto and ``chrome://tracing`` load."""

from __future__ import annotations

import contextlib
import os

import torch
from torch.profiler import ProfilerActivity, profile


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
