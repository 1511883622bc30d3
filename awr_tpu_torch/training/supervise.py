"""Restart-on-failure supervisor for long training runs (SURVEY.md §5.3).

Pairs with ``awr_tpu_torch.training.watchdog``: the in-process watchdog
turns a wedged device call into exit code ``EXIT_STALLED``; this wrapper
restarts the command, and the ``Trainer`` inside auto-restores the newest
committed checkpoint in its workdir, so the run loses at most one epoch
of work.

The reference has no counterpart — its recovery story is "a checkpoint
exists, rerun by hand" (reference train.py:162-172).

Usage::

    python -m awr_tpu_torch.training.supervise --max-restarts 3 -- \
        python -m awr_tpu_torch.training.train --synthetic --epochs 40 \
            --step-timeout 600

By default only stall exits (86) trigger a restart — a genuine bug
should fail loudly, not retry in a loop.  ``--restart-on any`` also
retries crashes/signal deaths (e.g. OOM kills on a shared host).
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from typing import List, Optional, Sequence

from awr_tpu_torch.training.watchdog import EXIT_STALLED


def supervise(cmd: Sequence[str], max_restarts: int = 3,
              restart_on: str = "stall", backoff_s: float = 5.0,
              run_fn=None, log=print) -> int:
    """Run ``cmd`` until it succeeds or restarts are exhausted.

    Returns the final exit code (0 on success).  ``restart_on`` is
    'stall' (only ``EXIT_STALLED``) or 'any' (any nonzero, including
    signal deaths, which subprocess reports as negative returncodes).
    ``run_fn`` is a test seam (defaults to ``subprocess.call``).
    """
    assert restart_on in ("stall", "any"), restart_on
    run = run_fn or (lambda c: subprocess.call(list(c)))
    attempts: List[int] = []
    while True:
        code = run(cmd)
        attempts.append(code)
        if code == 0:
            if len(attempts) > 1:
                log(f"supervise: succeeded after {len(attempts) - 1} "
                    f"restart(s); exit history {attempts}")
            return 0
        stalled = code == EXIT_STALLED
        retryable = stalled if restart_on == "stall" else True
        if not retryable or len(attempts) > max_restarts:
            log(f"supervise: giving up (exit {code}, "
                f"{'stall' if stalled else 'failure'}, "
                f"{len(attempts) - 1}/{max_restarts} restarts used, "
                f"history {attempts})")
            return code
        log(f"supervise: attempt {len(attempts)} exited {code} "
            f"({'stalled' if stalled else 'failed'}); restarting in "
            f"{backoff_s:.0f}s — the Trainer resumes from the newest "
            f"checkpoint in its workdir")
        if backoff_s:
            time.sleep(backoff_s)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--max-restarts", type=int, default=3)
    ap.add_argument("--restart-on", choices=("stall", "any"),
                    default="stall")
    ap.add_argument("--backoff", type=float, default=5.0,
                    help="seconds to wait before each restart")
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="command to run (prefix with --)")
    args = ap.parse_args(argv)
    cmd = args.cmd
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        ap.error("no command given (pass it after --)")
    return supervise(cmd, max_restarts=args.max_restarts,
                     restart_on=args.restart_on, backoff_s=args.backoff)


if __name__ == "__main__":
    sys.exit(main())
