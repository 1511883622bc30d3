"""Per-epoch checkpoints of the full training state as reference-layout
``.pth`` files.

Reference parity: train.py:165-172 saves ``{'model', 'optimizer',
'best_records'}`` every epoch and resumes all three plus the epoch
counter (train.py:80-86, 105).  Here a checkpoint is that dict plus
``epoch``, ``lr`` and ``plateau``, saved under
``<directory>/<epoch>.pth``.  ``model`` is the state dict in the
reference's key layout, so ``Predictor.from_torch`` and the reference
read it.

A save snapshots the state to host memory at once (later steps cannot
change what is written), then writes it on a background thread to a
temporary name and ``os.replace``s it onto ``<epoch>.pth``: a crash
mid-write leaves only a temporary file, which :meth:`latest_epoch` and
:meth:`restore` ignore.
"""

from __future__ import annotations

import atexit
import os
import re
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import torch

_NAME = re.compile(r"^(\d+)\.pth$")


def _to_cpu(tree):
    """A copy of ``tree`` (dicts, lists, tuples, tensors, scalars) with
    every tensor detached and copied to host memory."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: Optional[int] = None):
        """``max_to_keep``: keep only the newest N epochs (None keeps
        all, the reference's behavior).  The directory is created by the
        first save, not here, so a reader creates nothing."""
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="ckpt")
        self._pending: List[Future] = []
        self._closed = False
        # flush saves still in flight if the process exits without close()
        atexit.register(self._flush_at_exit)

    def _flush_at_exit(self):
        if not self._closed:
            try:
                self.wait()
            except Exception:  # noqa: BLE001 - exiting; nothing to report to
                pass

    def path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"{int(epoch)}.pth")

    def epochs(self) -> List[int]:
        """Committed epochs, ascending."""
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(m.group(1)) for m in
                      map(_NAME.match, os.listdir(self.directory)) if m)

    def _write(self, epoch: int, state: Dict[str, Any]) -> None:
        final = self.path(epoch)
        tmp = f"{final}.tmp{os.getpid()}"
        torch.save(state, tmp)
        os.replace(tmp, final)
        if self.max_to_keep:
            for old in self.epochs()[:-self.max_to_keep]:
                os.remove(self.path(old))

    def save(self, epoch: int, state: Dict[str, Any],
             block: bool = False) -> None:
        """Save ``state`` (a dict of state dicts, tensors and plain values)
        as epoch ``epoch``.  Asynchronous unless ``block``; :meth:`wait`
        waits for every save and raises a failed one's error."""
        os.makedirs(self.directory, exist_ok=True)
        self._pending.append(self._pool.submit(self._write, int(epoch),
                                               _to_cpu(state)))
        if block:
            self.wait()

    def wait(self) -> None:
        """Block until every scheduled save has committed to disk."""
        pending, self._pending = self._pending, []
        for f in pending:
            f.result()

    def latest_epoch(self) -> Optional[int]:
        self.wait()
        epochs = self.epochs()
        return epochs[-1] if epochs else None

    def restore(self, epoch: Optional[int] = None) -> Dict[str, Any]:
        """The checkpoint of ``epoch`` (default the latest), on the CPU."""
        self.wait()
        if epoch is None:
            epoch = self.latest_epoch()
        if epoch is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return torch.load(self.path(epoch), map_location="cpu",
                          weights_only=True)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self.wait()
        finally:
            self._pool.shutdown()
            atexit.unregister(self._flush_at_exit)
