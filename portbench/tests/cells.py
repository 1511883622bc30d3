"""Run a benchmark cell in this process at a small size: the cell's own
files with the image, frames, pool and batch cut down, so that a test
can drive the whole of a run (set-up, window, release, check) on the
CPU, or on the card at a size a test run holds."""

import tempfile
import time

from portbench import harness

# the train cell's check replays one step here: at these sizes Adam's
# later steps amplify the float32 rounding of near-zero gradients
SMALL = {
    "train": dict(batch=4, pool=16, num_workers=2, checked_steps=1),
    "open_loop": dict(pool=16, rate=40.0, max_batch=8),
    "closed_batch": dict(batch=8, pool=16),
}
CARD = {
    "train": dict(batch=8, pool=64, checked_steps=1),
    "open_loop": dict(pool=64, rate=200.0),
    # the cell's own sizes: its widest gap is a maximum over the pool
    "closed_batch": {},
}


def small(cell: str, sizes=SMALL, full_image: bool = False):
    """(workload, configuration) of ``cell`` with its sizes cut; on
    48x64 frames at img 32 (intrinsics scaled) unless ``full_image``."""
    wl = harness.workload(cell)
    cfg = harness.config(wl["config"])
    if not full_image:
        cfg = dict(cfg, img_size=32, feature_size=16, frame_shape=[48, 64],
                   paras=[58.803, 58.707, 32.0, 24.0])
    wl = dict(wl, params=dict(wl["params"], **sizes[wl["kind"]]))
    return wl, cfg


def run(cell: str, device="cpu", seconds=1.0, trace=False, fault=None,
        control=False, seed=7, sizes=SMALL, full_image=False, bench=None):
    """The result line of one run of ``cell``, as a dict (its metrics
    those of ``bench``, by default ``BENCHMARK.json``)."""
    wl, cfg = small(cell, sizes, full_image)
    with tempfile.TemporaryDirectory() as tmp:
        r = harness.Run(cell, seed, seconds, trace, device, tmp=tmp, wl=wl,
                        cfg=cfg, fault=fault, control=control)
        return harness.run_cell(r, bench or harness.benchmark(),
                                time.perf_counter_ns())
