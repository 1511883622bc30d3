"""Host-side prefetching batcher (reference: DataLoader num_workers=8,
config.py:37, train.py:99) and the staging thread that copies batches to
the device ahead of the step (the JAX package's ``data/pipeline.py``).

Python threads (numpy releases the GIL for the heavy ops) load items
ahead of the training loop, and a small bounded queue overlaps host
loading with device steps.  In raw mode the host work is only loading
frames, so a couple of threads keep the card fed.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np

from awr_tpu_torch.utils.profiling import span


class PrefetchLoader:
    """Iterable over stacked dict batches with background workers."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 num_workers: int = 2, prefetch: int = 4,
                 drop_last: bool = False,
                 rng: Optional[np.random.RandomState] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.rng = rng or np.random.RandomState(0)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[dict]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        batches = [order[i : i + self.batch_size]
                   for i in range(0, len(order), self.batch_size)]
        if self.drop_last and batches and \
                len(batches[-1]) < self.batch_size:
            batches.pop()

        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        idx_q: "queue.Queue" = queue.Queue()
        for j, idx in enumerate(batches):
            idx_q.put((j, idx))
        results = {}
        lock = threading.Lock()
        stop = threading.Event()

        def put_result(j):
            # stop-aware put: if the consumer abandons the generator the
            # bounded queue could otherwise block this thread forever,
            # pinning a decoded batch in memory
            while not stop.is_set():
                try:
                    out_q.put(j, timeout=0.1)
                    return
                except queue.Full:
                    continue
            with lock:
                results.pop(j, None)

        def worker():
            while not stop.is_set():
                try:
                    j, idx = idx_q.get_nowait()
                except queue.Empty:
                    return
                try:
                    items = [self.dataset[int(i)] for i in idx]
                    batch = {k: np.stack([it[k] for it in items])
                             for k in items[0]}
                    with lock:
                        results[j] = batch
                except Exception as e:  # surface worker errors to consumer
                    with lock:
                        results[j] = e
                put_result(j)

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            served = 0
            ready = {}
            next_j = 0
            while served < len(batches):
                # deliver in order to keep determinism with shuffle seeds
                while next_j not in ready:
                    j = out_q.get()
                    with lock:
                        ready[j] = results.pop(j)
                item = ready.pop(next_j)
                next_j += 1
                served += 1
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()


def prefetch_to_device(iterator, stage, depth: int = 2):
    """Overlap host->device staging with host-side batch production.

    Yields ``stage(item)`` for each item of ``iterator``, in order, with
    ``stage`` (typically pad, a pinned host copy and a ``non_blocking``
    H2D copy) running on ONE background thread up to ``depth`` items
    ahead, so loading batch i+1 overlaps the upload of batch i and the
    step on batch i - 1.  A ``stage`` that copies to the device issues
    its copies on the stream the consumer's steps run on: stream order
    then makes each step wait for its inputs, and the caching allocator
    sees the tensors used on the stream they were allocated on.

    ``depth == 0`` degrades to inline staging (no thread).  The single
    stager thread preserves order; exceptions (from the iterator or from
    staging) re-raise at the consuming call site.  Abandoning the
    generator unblocks and stops the thread.

    Under a profiler the consumer's wait for a staged item is the span
    ``pipeline.wait``.
    """
    if depth <= 0:
        for item in iterator:
            yield stage(item)
        return

    out_q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    _END = object()

    def run():
        try:
            for item in iterator:
                staged = stage(item)
                while not stop.is_set():
                    try:
                        out_q.put((staged, None), timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
            payload = (_END, None)
        except BaseException as e:  # noqa: BLE001 - forwarded verbatim
            payload = (None, e)
        while not stop.is_set():
            try:
                out_q.put(payload, timeout=0.1)
                return
            except queue.Full:
                continue

    t = threading.Thread(target=run, daemon=True)
    t.start()
    try:
        while True:
            with span("pipeline.wait"):
                staged, err = out_q.get()
            if err is not None:
                raise err
            if staged is _END:
                return
            yield staged
    finally:
        stop.set()
