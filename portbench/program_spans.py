"""The program's own spans in a traced window, for the per-layer metrics
that read them.

The program names phases of its host work with
``awr_tpu_torch.utils.profiling.span``: while a profiler records, each is
a range ``awr_tpu_torch.<name>`` (its custom ops are
``awr_tpu_torch::<op>``), stamped on the profiler's clock, which is the
clock of the device intervals in ``harness.TraceData``, so no offset is
needed.  A reader is handed that reduction of the trace, which keeps the
device intervals and the custom-op calls but not the ranges;
:func:`spans` therefore finds the profiler where ``harness.run_cell``
holds it, in the frame that holds the reduction the reader was given,
and takes the program's ranges that start inside the window.  A program
that records no spans gives none, and the metrics that read them are
left out of the line; a reader that finds no profiler raises, since the
harness no longer holds one where this looks (the next ``benchmark``
change to the harness should hand readers the ranges in ``TraceData``
and retire this walk).
"""

from __future__ import annotations

import sys

import torch

from portbench import harness

PREFIX = "awr_tpu_torch."


def _trace_of(tdata):
    """The ``harness.Trace`` that ``tdata`` was reduced from: a local of
    the nearest calling frame that also holds ``tdata``."""
    frame = sys._getframe(1)
    while frame is not None:
        found = list(frame.f_locals.values())
        if any(v is tdata for v in found):
            for v in found:
                if isinstance(v, harness.Trace):
                    return v
        frame = frame.f_back
    raise LookupError("no harness.Trace beside the TraceData in any calling "
                      "frame: harness.run_cell no longer holds both")


def spans(ctx, name: str) -> list:
    """``(thread, start ns, end ns)`` of each span
    ``awr_tpu_torch.<name>`` that starts inside the window of
    ``ctx.trace``, on the trace's clock."""
    trace = _trace_of(ctx.trace)
    full, lo, hi = PREFIX + name, ctx.trace.lo, ctx.trace.hi
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.start_thread_id(), e.start_ns(),
             e.start_ns() + e.duration_ns())
            for e in trace.prof.profiler.kineto_results.events()
            if e.name() == full and e.device_type() != cuda
            and lo <= e.start_ns() <= hi]


def mean_ms(ctx, name: str):
    """The mean duration of the window's spans ``name``, ms; None where
    the run has no card (the benchmark measures the program on one) or
    the window has no such span."""
    found = spans(ctx, name)
    if not ctx.run.cuda or not found:
        return None
    return sum(b - a for _, a, b in found) / len(found) / 1e6
