"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the program (``awr_tpu_torch``)
and ``BENCHMARK.json``, on a machine with the CUDA cards the cell asks
for.  ``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1``
its per-layer metrics from a profiled window.  The last line of standard
output is the result (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and the
compared numbers with their limits under ``checks``, last); the compared
numbers are also the last lines of standard error.

For measuring the benchmark itself, not for its runs:
``--control`` puts the lower-precision control in the program's place,
``--fault <name>`` plants a fault in the timed path (``traffic/*.py``
lists them), and ``--rate`` overrides an open loop's rate.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", default=None)
    ap.add_argument("--rate", type=float, default=None)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(REPO))
    # caches of anything that compiles stay inside the checkout (the
    # port's kernels build into build/awr_tpu_torch/ beside it)
    os.environ["TRITON_CACHE_DIR"] = str(REPO / "build" / "triton")
    os.environ.setdefault("USE_FLAX", "0")
    from portbench import harness

    # set-up is timed from the process's start
    start_ns = time.perf_counter_ns() - int(harness.process_age_s() * 1e9)
    bench = harness.benchmark()
    cells = {c["name"]: c for c in bench["workloads"]}
    if args.workload not in cells:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    problem = harness.device_problem(cells[args.workload]["chips"])
    if problem:
        print(problem, file=sys.stderr)
        return 2
    try:
        import awr_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the program is not in this checkout: {e}", file=sys.stderr)
        return 2
    import torch

    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        run = harness.Run(args.workload, args.seed, args.seconds,
                          bool(args.trace), "cuda", tmp=tmp,
                          control=args.control, fault=args.fault,
                          rate=args.rate)
        torch.set_num_threads(run.params.get("host_threads",
                                             harness.HOST_THREADS))
        try:
            out = harness.run_cell(run, bench, start_ns)
        except harness.ForeignModules as e:
            print(f"loaded modules of JAX or the JAX package: {e}",
                  file=sys.stderr)
            return 3
    # the card's name and power limit beside every number
    checks = out.pop("checks")
    out["card"] = harness.power_limit()
    out["checks"] = checks
    harness.emit(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
