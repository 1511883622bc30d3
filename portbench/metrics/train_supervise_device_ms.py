"""``train.supervise_device_ms.<cell kind>``: the device time a train
step of the work launched inside the program's span ``train.supervise``,
ms: every supervised stack's decode and its two losses, the forward half
of the supervision (the decode backward runs in ``train.backward``).

A device interval (kernel, copy or memset) counts when the CUDA API call
that launched it (``cudaLaunchKernel``, ``cuLaunchKernel``,
``cudaMemsetAsync``, ...: a host event named ``cu*``, joined to the
interval by the trace's correlation id; the program's ops and ranges are
named ``<namespace>::<op>`` or ``awr_tpu_torch.<span>``) starts inside a
span, on the span's thread, that starts inside the window; the sum is
divided by the train steps the window completed.  A traced window holds
about a million events, so the reader touches each as little as it can.
None where the run has no card, the window no step, or the program no
such span.
"""

import bisect

import torch

from portbench import program_spans

SPAN = program_spans.PREFIX + "train.supervise"
API = "cu"


def launched_within(events, lo: int, hi: int):
    """Seconds of the device intervals among ``events`` launched inside a
    span ``SPAN`` that starts in [lo, hi], on its thread; None where
    there is no such span.  The first pass reads each event's name
    alone, the second only the device intervals' correlation ids."""
    cuda = torch.autograd.DeviceType.CUDA
    spans, calls = {}, []
    for e in events:
        name = e.name()
        if name == SPAN:
            s = e.start_ns()
            if lo <= s <= hi:
                spans.setdefault(e.start_thread_id(), []).append(
                    (s, s + e.duration_ns()))
        elif name.startswith(API) and e.device_type() != cuda:
            calls.append(e)
    if not spans:
        return None
    for v in spans.values():
        v.sort()
    starts = {t: [a for a, _ in v] for t, v in spans.items()}
    launched = set()
    for e in calls:
        thread, t = e.start_thread_id(), e.start_ns()
        if thread in spans:
            # the span on this thread that starts last at or before t
            k = bisect.bisect_right(starts[thread], t) - 1
            if k >= 0 and t <= spans[thread][k][1]:
                launched.add(e.correlation_id())
    return sum(e.duration_ns() for e in events
               if e.device_type() == cuda
               and e.correlation_id() in launched) / 1e9


def read(ctx):
    steps = ctx.window.get("steps")
    if not ctx.run.cuda or not steps:
        return None
    events = program_spans._trace_of(ctx.trace).prof.profiler \
        .kineto_results.events()
    seconds = launched_within(events, ctx.trace.lo, ctx.trace.hi)
    return None if seconds is None else 1e3 * seconds / steps
