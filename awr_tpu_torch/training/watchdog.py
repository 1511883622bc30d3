"""Stall detection for long device-bound loops (SURVEY.md §5.3).

The reference has no failure detection at all — its closest mechanism is
the per-epoch "in case there is no improvement" checkpoint (reference
train.py:162-172).  A long-lived process's device call can wedge (the
JAX package met it on a TPU: the training process blocked inside a
device call at ~0% CPU for hours while a *fresh* process could use the
same chip).  A wedged call blocks the main thread inside the runtime, so
no Python-level timeout or signal handler in that thread can fire — the
only reliable in-process remedy is a watchdog *thread* that notices the
step stream has stopped and terminates the process so a supervisor can
restart it from the last committed checkpoint (``Trainer``
auto-restores the newest checkpoint in its workdir).

Usage::

    with Watchdog(timeout_s=300, on_stall=log_fn) as wd:
        for batch in loader:
            step(batch)
            wd.beat()

If ``beat()`` is not called for ``timeout_s`` seconds the watchdog
writes a diagnostic to stderr (and ``on_stall``, if given), then calls
``os._exit(EXIT_STALLED)``.  ``os._exit`` (not ``sys.exit``) is
deliberate: the main thread is presumed stuck in an uninterruptible
native call, so normal interpreter shutdown would never complete.
``EXIT_STALLED`` (86) is distinct from crash codes so the supervisor
(``awr_tpu_torch.training.supervise``) can distinguish "device wedged,
resume from checkpoint" from a genuine bug.
"""

from __future__ import annotations

import os
import sys
import threading
import time
import traceback
from typing import Callable, Optional

# Distinctive exit status meaning "device-step stream stalled; restart
# and resume from the last checkpoint".  Chosen away from shell (1/2),
# signal (128+N) and argparse (2) conventions.
EXIT_STALLED = 86

# How often the watchdog thread re-checks the last-beat timestamp.  A
# fraction of the timeout, floored so tests with sub-second timeouts
# still detect promptly.
_POLL_FRACTION = 0.25
_POLL_MIN_S = 0.05


class Watchdog:
    """Background thread that kills the process if ``beat()`` goes quiet.

    Parameters
    ----------
    timeout_s:
        Maximum seconds between beats before the process is declared
        stalled.  Size it to a comfortable multiple of the slowest
        legitimate gap (e.g. one full eval pass + checkpoint save), not
        of a single train step.
    on_stall:
        Optional callback invoked with the diagnostic message before
        exiting (e.g. ``Trainer.print_msg`` so the stall lands in the
        run log).  Exceptions in the callback are swallowed — the exit
        must happen regardless.
    name:
        Label used in the diagnostic message.
    exit_fn:
        Test seam; defaults to ``os._exit(EXIT_STALLED)``.
    """

    def __init__(self, timeout_s: float,
                 on_stall: Optional[Callable[[str], None]] = None,
                 name: str = "train",
                 exit_fn: Optional[Callable[[int], None]] = None):
        if timeout_s <= 0:
            raise ValueError(f"timeout_s must be positive, got {timeout_s}")
        self.timeout_s = float(timeout_s)
        self.on_stall = on_stall
        self.name = name
        self._exit = exit_fn or (lambda code: os._exit(code))
        self._last_beat = time.monotonic()
        self._stop = threading.Event()
        self._fired = False
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ API
    def beat(self) -> None:
        """Record forward progress (call once per step / sync point)."""
        self._last_beat = time.monotonic()

    def start(self) -> "Watchdog":
        assert self._thread is None, "watchdog already started"
        self.beat()
        self._thread = threading.Thread(
            target=self._run, name=f"watchdog-{self.name}", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Disarm and join the watchdog thread."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def __enter__(self) -> "Watchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------- internals
    def _run(self) -> None:
        poll = max(_POLL_MIN_S, self.timeout_s * _POLL_FRACTION)
        while not self._stop.wait(poll):
            quiet = time.monotonic() - self._last_beat
            if quiet >= self.timeout_s:
                self._fired = True
                msg = (
                    f"WATCHDOG[{self.name}]: no progress beat for "
                    f"{quiet:.1f}s (timeout {self.timeout_s:.1f}s) — the "
                    f"device-step stream appears wedged.  Exiting "
                    f"{EXIT_STALLED} so a supervisor can restart; the "
                    f"Trainer auto-resumes from the newest committed "
                    f"checkpoint in its workdir."
                )
                try:
                    if self.on_stall is not None:
                        self.on_stall(msg)
                except Exception:  # the exit must happen regardless
                    pass
                print(msg, file=sys.stderr)
                # Main-thread stack: shows WHERE the process is stuck
                # (typically inside a native device call).
                try:
                    frames = sys._current_frames()
                    main = threading.main_thread().ident
                    if main in frames:
                        print("".join(traceback.format_stack(frames[main])),
                              file=sys.stderr)
                except Exception:
                    pass
                sys.stderr.flush()
                self._exit(EXIT_STALLED)
                return  # only reached with a test exit_fn
