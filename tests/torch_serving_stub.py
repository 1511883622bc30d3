"""A fake clock and a stub Predictor for the port's batching and server
tests: every wait is on a ``threading`` primitive, and service time passes
on the fake clock, so no test sleeps."""

import threading
from types import SimpleNamespace

import numpy as np

IMG = 32
CENTER = np.array([0.0, 0.0, 500.0])
WAIT_S = 30.0


class FakeClock:
    """A clock that moves only when told; callable like
    ``time.perf_counter``, and with that name, so it can stand in for a
    module's ``time`` too."""

    def __init__(self, t: float = 1000.0):
        self.t = t
        self._lock = threading.Lock()

    def __call__(self) -> float:
        with self._lock:
            return self.t

    perf_counter = __call__

    def advance(self, dt: float) -> None:
        with self._lock:
            self.t += dt


class Stub:
    """A Predictor stand-in with ``_bucket``, ``cfg.cube`` and
    ``predict_async``.  Row (0, 0) of each returned joint set is its
    frame's pixel (0, 0), so routing is checkable without a model.

    ``service(n, (H, W))`` seconds pass on ``clock`` inside each finalize
    (on top of ``first_s`` the first time a bucket runs); with ``gated``,
    dispatch i's finalize waits for ``gate(i)``; ``hold`` keeps the
    dispatcher inside dispatch ``hold_at``'s ``predict_async`` until it is
    set (``holding`` is set once it waits there), so that requests
    submitted meanwhile queue up.
    Centers that are not (B, 3) raise in the host half, as the
    Predictor's do."""

    cfg = SimpleNamespace(net="hourglass_1", jt_num=14,
                          cube=(300.0, 300.0, 300.0))

    def __init__(self, clock=None, service=None, gated=False, hold=None,
                 hold_at=0, first_s=0.0):
        self.clock = clock or FakeClock()
        self.service = service or (lambda n, hw: 0.0)
        self.gated = gated
        self.hold = hold
        self.hold_at = hold_at
        self.holding = threading.Event()
        self.first_s = first_s
        self.groups = []           # the frame ids of each dispatch
        self.buckets_run = set()
        self._cond = threading.Condition()
        self._gates = {}

    @staticmethod
    def _bucket(n: int) -> int:
        b = 8
        while b < n:
            b *= 2
        return b

    def gate(self, i: int) -> threading.Event:
        with self._cond:
            return self._gates.setdefault(i, threading.Event())

    def open_all(self, upto: int = 256) -> None:
        for i in range(upto):
            self.gate(i).set()

    def predict_async(self, imgs, centers, cubes=None):
        imgs = np.asarray(imgs)
        if np.asarray(centers).shape != (len(imgs), 3):
            raise ValueError("centers must be (B, 3)")
        if self.hold is not None and len(self.groups) == self.hold_at:
            self.holding.set()
            assert self.hold.wait(WAIT_S)
        ids = imgs[:, 0, 0].copy()
        b = self._bucket(len(imgs))
        cost = self.service(len(imgs), imgs.shape[1:])
        if b not in self.buckets_run:
            cost += self.first_s
            self.buckets_run.add(b)
        with self._cond:
            i = len(self.groups)
            self.groups.append(ids.tolist())
            self._cond.notify_all()

        def finalize():
            if self.gated:
                assert self.gate(i).wait(WAIT_S)
            self.clock.advance(cost)
            out = np.zeros((len(ids), 14, 3), np.float32)
            out[:, 0, 0] = ids
            return out

        return finalize

    def wait_dispatches(self, n: int) -> None:
        with self._cond:
            assert self._cond.wait_for(lambda: len(self.groups) >= n,
                                       WAIT_S), self.groups


def frame(i: float, shape=(IMG, IMG)) -> np.ndarray:
    img = np.zeros(shape, np.float32)
    img[0, 0] = float(i)
    return img
