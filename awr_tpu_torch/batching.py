"""Dynamic request batching for serving: coalesce concurrent single-
frame requests into device batches.

The port's copy of the JAX package's ``awr_tpu/batching.py``: the same
public names, defaults, errors and policy, over the port's
:class:`~awr_tpu_torch.serving.Predictor` (which it uses by duck typing:
``_bucket``, ``cfg.cube`` and ``predict_async``).  It imports numpy and
the standard library only, and reads the time through one function,
:func:`_now`.

``Predictor`` gives one-call batch inference with power-of-two bucket
padding.  This module adds the piece a deployment puts in front of it: a
thread-safe queue that accepts requests from many client threads, groups
everything that arrives within a small window into ONE device dispatch,
and hands each client back its own rows.  Batching is where serving
throughput comes from: a small request pays the launches of a whole
forward, so frames that share a dispatch share that cost (the card's
numbers are in ``PERF.md``).

Design notes:
- One dispatcher thread owns the device; clients never touch the model
  or its stream, so there is no cross-thread dispatch contention and a
  kernel library is built and loaded on one thread.
- Dispatch and finalize are PIPELINED: the dispatcher enqueues the
  whole device chain without blocking (``Predictor.predict_async``:
  pinned uploads, the forward, the decode and the copy back, then an
  event) and a single completer thread waits on results in dispatch
  order, so group N+1's host preparation and upload overlap group N's
  device work and copy back.  ``pipeline_depth`` bounds
  dispatched-but-unfinalized groups, so a slow consumer backpressures
  instead of queueing unbounded device work.
- The dispatcher drains WHATEVER is queued (up to ``max_batch``) the
  moment it goes idle; ``max_wait_ms`` only caps how long the FIRST
  request of a group waits for company while the device is free.
  Under load the device never sits idle waiting for a timer.
- Predictor's bucketing pads each group to a power of two, so the
  number of distinct batch shapes the device sees stays logarithmic in
  ``max_batch`` whatever group sizes the traffic produces.

Overload behavior.  Unbounded drain has a convoy failure mode: when
offered load exceeds capacity, the dispatcher sweeps the whole backlog
into one giant group, that group's service time blows every queued
request's latency, more requests pile up while it runs, and the next
sweep is bigger still, so throughput becomes non-monotone in offered
load.  Three defenses, all off by default and independent:

- ``deadline_ms``: per-request latency budget (submit -> resolve).
  The dispatcher keeps a windowed service-time model keyed by
  (power-of-two bucket, frame shape) (measured by the completer) and
  (a) caps each group so the ~p90 predicted service plus the predicted
  in-flight pipeline work fits the OLDEST member's remaining budget,
  so groups stay small enough to meet the deadline instead of
  convoying, and under overload the cap lands on a bucket boundary so
  no upload is spent on padding rows; the cap is RE-CHECKED at dispatch
  time, after the grace wait, so a group never dispatches against a
  budget that went stale while it coalesced; (b) SHEDS requests whose
  budget cannot cover even the median service dispatched alone (their
  future fails with :class:`DeadlineExceeded`), so the queue cannot
  grow a latency debt that every later request inherits.  The split is
  deliberate: capping on a central estimate under-provisions exactly
  when service variance blows the tail, while shedding on the tail
  turns "might miss in the worst decile" into a drop.  Shape keying
  stops a 640x480 stream from poisoning a co-served 128x128 stream's
  estimates.
- ``max_queue``: admission control, a bound on QUEUED frames (excludes
  the <= ``max_batch`` frames the dispatcher holds and the <=
  ``(pipeline_depth + 2) * max_batch`` in the dispatch pipeline);
  ``submit``/``submit_batch`` raise :class:`QueueFull` synchronously
  when full, which the HTTP layer maps to 503 so clients back off
  instead of queueing unbounded.
- Counters ``n_shed`` / ``n_rejected`` make both visible (healthz).

Known limit: a burst that arrives while the model is still cold caps
nothing, so its first groups may serve past the deadline before the
model corrects (``deadline_margin`` trades served count for tighter
adherence).  :meth:`BatchingPredictor.prime_service_model` closes that
window at startup: it runs every bucket once and seeds the model with
measured steady-state service times, so the very first burst group is
already latency-capped.
"""

from __future__ import annotations

import collections
import os
import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# every clock read of the module: arrival times, budgets, service
# observations, priming costs (tests replace it with a fake clock)
_now = time.perf_counter


class QueueFull(RuntimeError):
    """Raised by submit/submit_batch when ``max_queue`` frames are
    already queued: admission control under overload (HTTP 503)."""


class DeadlineExceeded(RuntimeError):
    """Set on a request's future when it can no longer meet
    ``deadline_ms`` even if dispatched alone: load shedding."""


class _ServiceModel:
    """Windowed statistics of measured dispatch service time, keyed by
    (padded bucket, frame shape).

    The completer feeds it ``observe(frames, seconds, shape)`` per
    finalized group, where seconds is the group's time on the
    bottleneck resource: ``finalize_end - max(dispatch_time, previous
    finalize_end)`` (on a busy pipeline consecutive finalize
    completions are exactly one group's service apart; on an idle one
    the dispatch-to-finalize span is the service).  Keyed by the PADDED
    bucket size because that is what actually executes (Predictor pads
    groups up to the bucket), AND by the raw frame shape (H, W): the
    upload and the host crop scale with bucket x H x W, so a 640x480
    stream sharing the stack with 128x128 clients must not poison the
    smaller stream's estimates.

    Two statistics per key, consumed by DIFFERENT decisions:

    - :meth:`estimate`: the windowed MEDIAN (typical case).  Drives
      the SHED decision and the in-flight sum: shedding on a tail
      statistic drops requests that would most likely have made their
      deadline, and a median, unlike a window mean, recovers within two
      sane observations after one pathological spike.
    - :meth:`quantile`: the windowed empirical ~p90.  Drives the
      group-size CAP: a median-sized group under-provisions exactly
      when per-group service variance blows the tail, and capping is
      cheap (a too-small group costs a little coalescing efficiency,
      not a dropped request).

    Statistics come from a RING WINDOW of recent observations (not a
    Gaussian mean+variance EWMA): a single stall inflates an EWMA
    variance for many observations, and a Gaussian p90 then
    over-estimates for a long decay; an empirical window quantile
    weighs the outlier as one sample of WINDOW and recovers as it
    slides out.
    """

    WINDOW = 32   # ring size per key; responsive yet spike-robust
    Z90 = 1.2816  # normal 90th pct, used only to fold variances of
    #               SUMS of in-flight groups back into a spread term
    Q = 0.90      # cap quantile

    def __init__(self, bucket_fn):
        self._bucket = bucket_fn
        # key (bucket, shape) -> ring of recent service seconds; shape
        # is an (H, W) tuple or None when the caller does not know it
        self._s: Dict[tuple, "collections.deque"] = {}
        self._lock = threading.Lock()

    @staticmethod
    def _shape_key(shape) -> Optional[tuple]:
        return None if shape is None else tuple(int(x) for x in shape)

    @staticmethod
    def _pixels(shape) -> float:
        return 1.0 if shape is None else float(shape[0] * shape[1])

    def observe(self, frames: int, seconds: float, shape=None) -> None:
        key = (self._bucket(int(frames)), self._shape_key(shape))
        with self._lock:
            ring = self._s.get(key)
            if ring is None:
                ring = self._s[key] = collections.deque(
                    maxlen=self.WINDOW)
            ring.append(float(seconds))

    def reset(self, frames: int, shape=None) -> None:
        """Forget the observations for ``frames``'s padded bucket (used
        by priming to discard a first dispatch, which pays one-time costs
        as 'service')."""
        key = (self._bucket(int(frames)), self._shape_key(shape))
        with self._lock:
            self._s.pop(key, None)

    def _stats(self, frames: int, shape) -> Optional[tuple]:
        """(median_s, p90_s, var_s2) for (frames, shape), None when cold.

        Unmeasured keys extrapolate from the nearest measured one,
        preferring SAME-shape keys (scaled linearly in frames), else
        cross-shape scaled by frames x pixel ratio.  Scaling DOWN is
        floored at half the measured value: dispatch overhead does not
        shrink with the batch.  Quantile and spread scale by the same
        factor (a scaled distribution scales every quantile by it).
        The floor applies to the combined frames x pixel factor, as in
        the JAX package."""
        b = self._bucket(int(frames))
        sk = self._shape_key(shape)
        with self._lock:
            if not self._s:
                return None
            ring = self._s.get((b, sk))
            if ring is not None:
                ratio = 1.0
            else:
                same = {k: v for k, v in self._s.items()
                        if k[1] == sk}
                pool = same or self._s

                def ratio_from(key):
                    # service ~ bucket x pixels; when either shape is
                    # unknown (None) the pixel factor is unknowable:
                    # frames only
                    r = b / key[0]
                    if sk is not None and key[1] is not None:
                        r *= self._pixels(sk) / self._pixels(key[1])
                    return r

                kb = min(pool,
                         key=lambda kk: abs(np.log(ratio_from(kk))))
                ring = pool[kb]
                ratio = ratio_from(kb)
            xs = np.asarray(ring, np.float64)
        f = max(ratio, 0.5)
        # MEDIAN, not mean, as the central statistic: one pathological
        # observation shifts a window mean for WINDOW observations, but
        # the median recovers after two sane ones, and the shed decision
        # keyed on it must not storm for a whole window after one spike
        med = float(np.quantile(xs, 0.5))
        p90 = float(np.quantile(xs, self.Q)) if len(xs) > 1 else med
        var = float(xs.var())
        return med * f, max(p90, med) * f, var * f * f

    def estimate(self, frames: int, shape=None) -> Optional[float]:
        """Windowed MEDIAN service-seconds estimate: the SHED decision
        and in-flight sums run on this (class docstring)."""
        st = self._stats(frames, shape)
        return None if st is None else st[0]

    def quantile(self, frames: int, shape=None) -> Optional[float]:
        """Windowed empirical ~p90 service estimate: the group-size CAP
        runs on this (class docstring)."""
        st = self._stats(frames, shape)
        return None if st is None else st[1]

    def variance(self, frames: int, shape=None) -> Optional[float]:
        st = self._stats(frames, shape)
        return None if st is None else st[2]

    def snapshot(self) -> Dict[tuple, dict]:
        """{(bucket, shape): {'p50_s', 'p90_s', 'n'}} for every
        measured key (healthz stringifies the tuple keys)."""
        with self._lock:
            keys = list(self._s)
        out = {}
        for k in keys:
            st = self._stats(k[0], k[1])
            if st is None:
                continue
            with self._lock:
                n = len(self._s.get(k, ()))
            out[k] = dict(p50_s=st[0], p90_s=st[1], n=n)
        return out


class _Request:
    __slots__ = ("imgs", "centers", "cubes", "future", "batched",
                 "prime", "t_arrival", "waited")

    def __init__(self, imgs, centers, cubes, future, batched=False,
                 prime=False):
        self.imgs = imgs
        self.centers = centers
        self.cubes = cubes
        self.future = future
        # batched requests resolve to (B, J, 3); single-frame to (J, 3)
        self.batched = batched
        # priming requests exist to MEASURE service: they are exempt
        # from the deadline shed/budget math (an estimate that holds a
        # first dispatch's one-time costs must not shed the dispatch
        # that would correct it)
        self.prime = prime
        self.t_arrival = _now()
        # whether its queue wait is recorded (a request deferred at
        # dispatch is drained again)
        self.waited = False

    @property
    def frames(self) -> int:
        return self.imgs.shape[0]


class BatchingPredictor:
    """Thread-safe dynamic-batching front end for a
    :class:`~awr_tpu_torch.serving.Predictor`.

    Usage::

        bp = BatchingPredictor(predictor, max_batch=64, max_wait_ms=2.0)
        fut = bp.submit(frame, center_xyz)       # from any thread
        joints = fut.result()                    # (J, 3) camera uvd
        ...
        bp.close()

    ``submit`` never blocks on the device; it returns a
    ``concurrent.futures.Future``.  ``predict`` is the blocking
    convenience wrapper.  All requests in a drained group are served by
    one ``Predictor.predict_async`` call (one device dispatch per frame
    shape).

    Overload knobs (module docstring for the failure mode they defend
    against): ``deadline_ms`` enables latency-bounded group sizing and
    shedding (:class:`DeadlineExceeded`); ``max_queue`` bounds queued
    frames (:class:`QueueFull` at submit).  Both default off.
    """

    QUEUE_WAIT_WINDOW = 1024  # requests in the queue-wait window

    def __init__(self, predictor, max_batch: int = 64,
                 max_wait_ms: float = 2.0, pipeline_depth: int = 2,
                 deadline_ms: Optional[float] = None,
                 max_queue: Optional[int] = None,
                 deadline_margin: float = 1.0):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1")
        if deadline_ms is not None and deadline_ms <= 0:
            raise ValueError("deadline_ms must be positive")
        if max_queue is not None and max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        if deadline_margin < 1.0:
            raise ValueError("deadline_margin must be >= 1.0")
        self._p = predictor
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1000.0
        self.deadline_s = (None if deadline_ms is None
                           else float(deadline_ms) / 1000.0)
        # scales service-time ESTIMATES in the budget/cap/shed math
        # (never the measurements).  The cap already runs on a windowed
        # p90, so 1.0 (default) is the right setting; the knob is for
        # service tails heavier than the window quantile captures.
        self.deadline_margin = float(deadline_margin)
        self.max_queue = None if max_queue is None else int(max_queue)
        self._q: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._closed = False
        # serializes the closed-check-then-enqueue in submit() against
        # the flag-set-then-sentinel in close(): without it a submit
        # could land its request BEHIND the sentinel and hang forever.
        # Also guards the queued-frames admission counter.
        self._submit_lock = threading.Lock()
        self._queued_frames = 0
        # requests popped during drain (or deferred by the dispatch-
        # time budget re-check) that did not fit a group's latency-
        # bounded frame cap; they lead the NEXT group, FIFO
        self._held: "collections.deque[_Request]" = collections.deque()
        # observability: groups dispatched, frames served, requests
        # shed past their deadline, requests rejected at admission
        self.n_dispatches = 0
        self.n_frames = 0
        self.n_shed = 0
        self.n_rejected = 0
        # the last QUEUE_WAIT_WINDOW requests' seconds from arrival to
        # the moment a drain took them (``queue_wait_ms``)
        self._queue_waits: "collections.deque[float]" = collections.deque(
            maxlen=self.QUEUE_WAIT_WINDOW)
        self._waits_lock = threading.Lock()
        # latency-bounded dispatch state: measured per-bucket service
        # times and the predicted seconds of dispatched-but-unfinalized
        # work (what a new group must wait behind)
        self.service_model = _ServiceModel(self._p._bucket)
        self._inflight_lock = threading.Lock()
        # predicted seconds of dispatched-but-unfinalized work: sum of
        # median estimates plus sum of VARIANCES (independent groups add
        # in quadrature; _inflight_pred reports sum + Z90 * std so the
        # budget math sees a ~p90 wait, not an optimistic one)
        self._inflight_mean_s = 0.0
        self._inflight_var_s2 = 0.0
        self._inflight_groups = 0
        # dispatch/finalize pipeline: the dispatcher enqueues device
        # work via Predictor.predict_async and hands (finalize, group)
        # here; the completer thread waits on results and resolves
        # futures.  The bounded queue is the backpressure: the next
        # group's upload overlaps the previous group's device work and
        # copy back instead of waiting for it.  The in-flight bound is
        # ``pipeline_depth + 2`` groups, not pipeline_depth: one group
        # can sit popped-but-unfinalized in the completer and another
        # dispatched-but-blocked in the dispatcher's put, on top of the
        # queue's own capacity.
        self._cq: "queue.Queue[Optional[tuple]]" = queue.Queue(
            maxsize=int(pipeline_depth))
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="awr-batching-dispatch")
        self._completer = threading.Thread(target=self._complete,
                                           daemon=True,
                                           name="awr-batching-complete")
        self._worker.start()
        self._completer.start()

    # ------------------------------------------------------------ client
    def submit(self, img, center_xyz, cube=None) -> Future:
        """Enqueue ONE frame; returns a Future of (J, 3) camera-coord
        joints (same convention as Predictor.predict rows)."""
        img = np.asarray(img, np.float32)
        if img.ndim != 2:
            raise ValueError(f"submit takes one (H, W) frame, got "
                             f"{img.shape}")
        fut: Future = Future()
        req = _Request(img[None],
                       np.asarray(center_xyz, np.float64)[None],
                       None if cube is None
                       else np.asarray(cube, np.float64)[None],
                       fut)
        self._admit(req)
        return fut

    def submit_batch(self, imgs, centers_xyz, cubes=None) -> Future:
        """Enqueue a MULTI-frame request; returns a Future of (B, J, 3)
        camera-coord joints.

        Keeps the module invariant that ONE dispatcher thread owns the
        device: callers with pre-formed batches (e.g. the HTTP
        /predict_batch route) must come through here rather than
        calling Predictor directly from their own thread, which would
        enqueue on the device concurrently with the dispatcher and race
        it into first use of a kernel library."""
        imgs = np.asarray(imgs, np.float32)
        if imgs.ndim != 3:
            raise ValueError(f"submit_batch takes (B, H, W) frames, "
                             f"got {imgs.shape}")
        centers = np.asarray(centers_xyz, np.float64)
        if centers.shape != (len(imgs), 3):
            raise ValueError("'centers_xyz' must be (B, 3)")
        if cubes is not None:
            cubes = np.asarray(cubes, np.float64)
            if cubes.shape != (len(imgs), 3):
                raise ValueError("'cubes' must be (B, 3)")
        fut: Future = Future()
        req = _Request(imgs, centers, cubes, fut, batched=True)
        self._admit(req)
        return fut

    def _admit(self, req: _Request) -> None:
        """Enqueue or reject: with ``max_queue`` set, a request that
        would push QUEUED frames past the bound raises
        :class:`QueueFull` synchronously (the HTTP layer maps it to
        503).  A single request larger than max_queue is always
        rejected: size max_queue above the largest legitimate
        submit_batch."""
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("BatchingPredictor is closed")
            if (self.max_queue is not None
                    and self._queued_frames + req.frames > self.max_queue):
                self.n_rejected += 1
                raise QueueFull(
                    f"{self._queued_frames} frames queued, request of "
                    f"{req.frames} exceeds max_queue={self.max_queue}")
            self._queued_frames += req.frames
            self._q.put(req)

    def _unqueue(self, req: _Request) -> None:
        """Account a request popped off the admission queue."""
        with self._submit_lock:
            self._queued_frames -= req.frames

    def predict(self, img, center_xyz, cube=None, timeout=None):
        """Blocking single-frame convenience wrapper around
        :meth:`submit`."""
        return self.submit(img, center_xyz, cube).result(timeout=timeout)

    def predict_batch(self, imgs, centers_xyz, cubes=None, timeout=None):
        """Blocking multi-frame convenience wrapper around
        :meth:`submit_batch`."""
        return self.submit_batch(imgs, centers_xyz,
                                 cubes).result(timeout=timeout)

    def prime_service_model(self, frame_shape, buckets=None,
                            repeats: int = 2,
                            center_z_mm: float = 500.0
                            ) -> Dict[int, float]:
        """Run every dispatch bucket once and seed the service-time model
        with measured steady-state service, BEFORE real traffic.

        The deadline machinery is estimate-driven: a COLD model caps
        nothing and sheds nothing, so a burst that arrives before each
        bucket has been measured is swept convoy-style and served past
        the deadline.  Priming removes that window: after it returns,
        the very first group of a burst is already latency-capped and
        stale requests shed from the start.

        Per bucket (ascending, every padded size a group can execute
        at): ONE throwaway dispatch, whose timing is discarded
        (:meth:`_ServiceModel.reset`) because a bucket's first dispatch
        on the card pays one-time costs (lazy loading of CUDA modules,
        cuDNN's choice of algorithms for the new shapes, the caching
        allocators' first blocks), then ``repeats`` measured dispatches
        feed the model through the normal completer path.  Frames are
        freshly random per dispatch.

        Priming requests share the dispatcher with real traffic (and
        count in ``n_dispatches``/``n_frames``) but bypass
        ``max_queue`` admission; call this before exposing the stack.
        ``self.prime_stats`` records the cost afterwards:
        ``{"total_s", "repeats", "shape", "per_bucket": {b: {"first_s",
        "measure_s"}}}``, where ``first_s`` is the throwaway dispatch
        (``PERF.md`` has the card's numbers).

        Args:
          frame_shape: (H0, W0) of the raw frames clients will send.
            The service model is keyed by (bucket, shape), so prime
            with the deployment's dominant resolution; other
            resolutions extrapolate pixel-scaled until measured.
          buckets: padded sizes to prime; defaults to every bucket a
            dispatch group can land on (``_bucket(1)`` up to
            ``_bucket(max_batch)``).
          repeats: measured dispatches per bucket after the throwaway.
          center_z_mm: synthetic hand-center depth for the crop path.

        Returns:
          ``{bucket: p90_service_seconds}`` for the primed shape.
        """
        if repeats < 1:
            raise ValueError("repeats must be >= 1")
        if buckets is None:
            buckets = []
            b = self._p._bucket(1)
            top = self._p._bucket(self.max_batch)
            while True:
                buckets.append(b)
                if b >= top:
                    break
                b = self._p._bucket(b + 1)
        shape = tuple(int(x) for x in frame_shape)
        rng = np.random.default_rng(
            int.from_bytes(os.urandom(8), "little"))
        t_start = _now()
        per_bucket: Dict[int, dict] = {}
        for b in buckets:
            centers = np.tile(
                np.array([0.0, 0.0, float(center_z_mm)]), (int(b), 1))
            tb = _now()
            first_s = 0.0
            for i in range(repeats + 1):
                imgs = rng.uniform(
                    center_z_mm - 100.0, center_z_mm + 100.0,
                    (int(b),) + shape).astype(np.float32)
                self._prime_submit(imgs, centers).result()
                if i == 0:
                    first_s = _now() - tb
                    self.service_model.reset(int(b), shape)
            per_bucket[int(b)] = dict(
                first_s=round(first_s, 4),
                measure_s=round(_now() - tb - first_s, 4))
        self.prime_stats = dict(
            total_s=round(_now() - t_start, 3),
            repeats=int(repeats), shape=list(shape),
            per_bucket=per_bucket)
        snap = self.service_model.snapshot()
        return {k[0]: v["p90_s"] for k, v in snap.items()
                if k[1] == shape}

    def _prime_submit(self, imgs, centers) -> Future:
        """Enqueue a priming batch, bypassing ``max_queue`` admission
        (priming must not be rejected by the knob it calibrates)."""
        fut: Future = Future()
        req = _Request(np.asarray(imgs, np.float32),
                       np.asarray(centers, np.float64), None, fut,
                       batched=True, prime=True)
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("BatchingPredictor is closed")
            self._queued_frames += req.frames
            self._q.put(req)
        return fut

    def close(self, wait: bool = True):
        """Stop accepting requests; drain the queue, then stop the
        dispatcher.  Pending futures still complete; a request that
        races past the closed check as the sentinel lands is failed
        rather than left hanging."""
        with self._submit_lock:
            if self._closed:
                return
            self._closed = True
            self._q.put(None)  # sentinel; no submit can enqueue after
        if wait:
            self._worker.join()     # dispatches the backlog, then
            self._completer.join()  # finalizes every in-flight group

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -------------------------------------------------------- dispatcher
    def _inflight_pred(self) -> float:
        """~p90 of the predicted wait behind dispatched-but-unfinalized
        work: sum of median estimates + Z90 * sqrt(sum of variances)
        (independent in-order groups: centers add, variances add)."""
        with self._inflight_lock:
            return (self._inflight_mean_s
                    + _ServiceModel.Z90
                    * float(np.sqrt(max(self._inflight_var_s2, 0.0))))

    def _budget_s(self, req: _Request) -> float:
        """Remaining latency budget if dispatched NOW: deadline minus
        age minus the predicted (~p90) service of work already in the
        dispatch pipeline ahead of it (the device serves groups in
        order)."""
        age = _now() - req.t_arrival
        return self.deadline_s - age - self._inflight_pred()

    def _shed(self, req: _Request) -> None:
        self.n_shed += 1
        if not req.future.done():
            req.future.set_exception(DeadlineExceeded(
                f"request aged past deadline_ms="
                f"{self.deadline_s * 1e3:.0f} before it could be "
                f"served (overload)"))

    def _busy(self) -> bool:
        with self._inflight_lock:
            return self._inflight_groups > 0

    def _est(self, frames: int, shape=None) -> Optional[float]:
        """Margin-scaled median service estimate: the SHED decision
        runs on this (measurements are never scaled).  'Might miss in
        the worst decile' must not become a drop."""
        e = self.service_model.estimate(frames, shape)
        return None if e is None else e * self.deadline_margin

    def _est_p90(self, frames: int, shape=None) -> Optional[float]:
        """Margin-scaled ~p90 service estimate: the group-size CAP runs
        on this.  A median-sized group under-provisions exactly when
        service variance blows the tail, and a too-small cap costs
        coalescing efficiency, not a dropped request."""
        e = self.service_model.quantile(frames, shape)
        return None if e is None else e * self.deadline_margin

    @staticmethod
    def _shape_of(req: _Request):
        return req.imgs.shape[1:]

    def _next_request(self):
        """Head of the next group: a held-back request if one exists,
        else block on the queue.  With a deadline, sheds heads that can
        no longer be served in time even alone, UNLESS the dispatch
        pipeline is idle.  The idle override is a liveness guarantee:
        shedding produces no service-time observations, so if the model
        ever learns a pathological value (e.g. a first dispatch's
        one-time costs measured as 'service'), shed-everything would be
        a permanent absorbing state with an idle device.  Dispatching
        the head when nothing is in flight costs nothing (the device is
        free), may still make its deadline, and re-measures the service
        time so the model recovers."""
        while True:
            if self._held:
                req = self._held.popleft()
            else:
                req = self._q.get()
                if req is None:
                    return None
                self._unqueue(req)
            if self.deadline_s is None or req.prime:
                return req
            est = self._est(req.frames, self._shape_of(req))
            if (est is None or self._budget_s(req) >= est
                    or not self._busy()):
                return req
            self._shed(req)

    def _cap_for(self, budget: float, shape) -> Optional[int]:
        """Largest frame count whose PADDED bucket's predicted service
        for ``shape`` frames fits ``budget`` seconds; None while the
        model is cold.  Walking bucket sizes lands the cap on a bucket
        boundary, so under overload groups are exactly a warm bucket
        and no upload is spent on padding rows."""
        cap = 0
        b = self._p._bucket(1)  # smallest bucket the Predictor pads to
        top = self._p._bucket(self.max_batch)
        while True:
            est = self._est_p90(b, shape)
            if est is None:
                return None  # cold: no model yet
            if est > budget:
                break
            cap = b
            if b >= top:
                break
            # step to the next REAL bucket boundary (the Predictor's
            # own rule, not a doubling assumed here)
            b = self._p._bucket(b + 1)
        return cap

    def _cap_frames(self, head: _Request) -> int:
        """Latency-bounded group size: the largest frame count whose
        padded bucket's predicted service fits the head's (= oldest
        member's) remaining budget.  Before any measurement (or without
        a deadline) falls back to max_batch.

        The cap is FLOORED at the smallest padded bucket: the
        Predictor pads every group up to ``_bucket(1)`` rows, so a
        1-frame group costs what a bucket-full group costs, and capping
        below the bucket gains no latency while it collapses the frames
        served per dispatch."""
        if self.deadline_s is None:
            return self.max_batch
        cap = self._cap_for(self._budget_s(head), self._shape_of(head))
        if cap is None:
            return self.max_batch  # cold: no model yet
        # the head itself always dispatches (it passed the shed check;
        # a zero cap here just means the model moved under it)
        return min(max(cap, head.frames, self._p._bucket(1)),
                   self.max_batch)

    def _drain(self) -> Tuple[List[_Request], bool]:
        """Collect the next group: block for the first request, then
        wait at most ``max_wait_s`` for more, then sweep whatever is
        queued, up to ``max_batch`` frames, and with ``deadline_ms``
        set, up to the latency-bounded cap (:meth:`_cap_frames`).
        Returns (group, sentinel_seen)."""
        first = self._next_request()
        if first is None:
            return [], True
        self._took(first)
        group = [first]
        frames = first.frames
        cap = self._cap_frames(first)
        deadline_wait = self.max_wait_s
        stop = False
        # the cap bounds total FRAMES per group (a single request
        # larger than the cap still dispatches alone; Predictor's
        # bucketing handles any size)
        while frames < cap:
            if self._held:
                # deferred by an earlier dispatch-time re-check; it was
                # already unqueued and keeps FIFO priority
                nxt = self._held.popleft()
            else:
                try:
                    nxt = self._q.get(timeout=deadline_wait)
                except queue.Empty:
                    break
                if nxt is None:
                    stop = True
                    break
                self._unqueue(nxt)
            # stale: cannot make its deadline even dispatched alone.
            # The _busy() guard mirrors _next_request's liveness
            # override: with an idle pipeline a poisoned estimate must
            # not shed; let the request join this group (or lead the
            # next) so real service times keep flowing into the model.
            if (self.deadline_s is not None and self._busy()
                    and not nxt.prime):
                est = self._est(nxt.frames, self._shape_of(nxt))
                if est is not None and self._budget_s(nxt) < est:
                    self._shed(nxt)
                    # shedding must not re-open the grace window: a
                    # trickle of stale requests would otherwise delay
                    # the head by max_wait_s per shed, dispatching it
                    # long after its own budget check
                    deadline_wait = 0.0
                    continue
            if frames + nxt.frames > cap:
                # does not fit this group's latency budget: it leads
                # the next group instead (keeps FIFO order)
                self._held.appendleft(nxt)
                break
            group.append(nxt)
            self._took(nxt)
            frames += nxt.frames
            # after the grace window only sweep what is already queued
            deadline_wait = 0.0
        return group, stop

    def _took(self, req: _Request) -> None:
        """Record ``req``'s queue wait, the first time a drain takes it
        into a group."""
        if not req.waited:
            req.waited = True
            with self._waits_lock:
                self._queue_waits.append(_now() - req.t_arrival)

    def queue_wait_ms(self) -> dict:
        """``{"p50", "p95", "n"}``: the queue wait (ms, from arrival to
        the moment a drain took the request into a group) over the last
        ``QUEUE_WAIT_WINDOW`` requests; the quantiles are None before
        the first (the server's ``/healthz`` reports it)."""
        with self._waits_lock:
            waits = np.asarray(self._queue_waits, np.float64) * 1e3
        if not len(waits):
            return {"p50": None, "p95": None, "n": 0}
        p50, p95 = np.quantile(waits, [0.5, 0.95])
        return {"p50": float(p50), "p95": float(p95), "n": len(waits)}

    def _run(self):
        while True:
            group, stop = self._drain()
            if group:
                self._dispatch(group)
            if stop:
                # close() promises every accepted future completes:
                # flush requests still deferred in the held queue (the
                # dispatch-time re-check may re-defer a tail, but every
                # dispatch consumes at least its head, so this makes
                # progress)
                while self._held:
                    grp = list(self._held)
                    self._held.clear()
                    self._dispatch(grp)
                break
        self._cq.put(None)  # all groups dispatched; stop the completer

    def _dispatch(self, all_requests: Sequence[_Request]):
        # clients may send different camera resolutions; frames only
        # stack per shape, so dispatch one device call per shape group
        by_shape = {}
        for r in all_requests:
            by_shape.setdefault(r.imgs.shape[1:], []).append(r)
        for group in by_shape.values():
            self._dispatch_same_shape(group)

    def _recheck_budget(self, group: List[_Request]) -> List[_Request]:
        """Dispatch-time budget re-check: the cap was computed at
        group-HEAD time, but up to ``max_wait_s`` of grace wait (plus
        shed sweeps) passed since, while in-flight predictions and the
        head's age moved.  Recompute the oldest member's remaining
        budget against the (bucket, shape) estimate NOW and re-cap;
        members past the fresh cap are deferred back to the held queue
        (front, FIFO preserved) where the normal shed/liveness path
        re-judges them.  The head always dispatches (liveness; it passed
        the shed check).  Idle pipeline: dispatch as-is, since waiting
        work and a free device leave the cap math nothing to protect."""
        if (self.deadline_s is None or len(group) <= 1
                or any(r.prime for r in group) or not self._busy()):
            return group
        head = group[0]
        cap = self._cap_for(self._budget_s(head), self._shape_of(head))
        if cap is None:
            return group  # cold model
        # same smallest-bucket floor as _cap_frames: below it a
        # smaller group costs identical padded service
        cap = max(cap, self._p._bucket(1))
        frames, keep = 0, []
        for i, r in enumerate(group):
            if keep and frames + r.frames > cap:
                # defer the tail, in order, to the FRONT of held
                self._held.extendleft(reversed(group[i:]))
                break
            keep.append(r)
            frames += r.frames
        return keep

    def _dispatch_same_shape(self, group: Sequence[_Request],
                             recheck: bool = True):
        if recheck:
            group = self._recheck_budget(list(group))
            if not group:
                return
        shape = self._shape_of(group[0])
        try:
            imgs = np.concatenate([r.imgs for r in group])
            centers = np.concatenate([r.centers for r in group])
            if any(r.cubes is not None for r in group):
                default = np.asarray(self._p.cfg.cube, np.float64)
                cubes = np.concatenate([
                    r.cubes if r.cubes is not None
                    else np.repeat(default[None], len(r.imgs), axis=0)
                    for r in group])
            else:
                cubes = None
            # per-request failures (malformed centers/cubes) surface
            # HERE, in the host-prep half of predict_async, so the
            # solo-retry isolation below still catches them; only the
            # device sync is deferred to the completer
            finalize = self._p.predict_async(imgs, centers, cubes)
            self.n_dispatches += 1
            self.n_frames += len(imgs)
            # in-flight accounting carries (median, variance): the wait
            # behind N groups is the sum of medians + Z90 * sqrt(sum of
            # variances)
            pred_mean = self.service_model.estimate(len(imgs), shape)
            pred_var = self.service_model.variance(len(imgs), shape)
            pred = (None if pred_mean is None
                    else (pred_mean * self.deadline_margin,
                          (pred_var or 0.0) * self.deadline_margin ** 2))
            with self._inflight_lock:
                self._inflight_groups += 1
                if pred is not None:
                    self._inflight_mean_s += pred[0]
                    self._inflight_var_s2 += pred[1]
            t_dispatch = _now()
            # blocks at pipeline depth:
            self._cq.put((finalize, list(group), pred, t_dispatch,
                          shape))
        except BaseException as e:  # noqa: BLE001 - must fail futures
            if len(group) > 1:
                # one malformed request must not fail its co-batched
                # neighbours: retry each request alone so only the
                # offender's future carries the exception
                for r in group:
                    self._dispatch_same_shape([r], recheck=False)
                return
            r = group[0]
            if not r.future.done():
                r.future.set_exception(e)

    # --------------------------------------------------------- completer
    def _complete(self):
        """Resolve dispatched groups in dispatch order, and feed the
        service-time model.

        A failure that first surfaces at finalize time (i.e. AFTER the
        device accepted the dispatch) is an infrastructure fault (device
        out of memory, a failed kernel launch) and not a malformed
        request, so it fails every future in the group rather than
        re-running the group solo through a device that is already
        unhealthy."""
        prev_end = 0.0
        while True:
            item = self._cq.get()
            if item is None:
                return
            finalize, group, pred, t_dispatch, shape = item
            frames = sum(r.frames for r in group)
            try:
                out = finalize()
                end = _now()
                # busy pipeline: consecutive finalize completions are
                # one group's service apart; idle: dispatch->finalize
                self.service_model.observe(
                    frames, end - max(t_dispatch, prev_end), shape)
                prev_end = end
                off = 0
                for r in group:
                    n = r.frames
                    # a client may have cancelled its future; that must
                    # not poison the co-batched neighbours' results
                    if not r.future.done():
                        r.future.set_result(out[off:off + n] if r.batched
                                            else out[off])
                    off += n
            except BaseException as e:  # noqa: BLE001 - must fail futures
                for r in group:
                    if not r.future.done():
                        r.future.set_exception(e)
            finally:
                with self._inflight_lock:
                    self._inflight_groups -= 1
                    if pred is not None:
                        self._inflight_mean_s -= pred[0]
                        self._inflight_var_s2 -= pred[1]
