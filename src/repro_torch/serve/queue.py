"""Continuous-batching admission queue over :class:`ServeEngine`.

Concurrent callers submit single requests (or small batches); a single
dispatch loop drains the admission queue and coalesces whatever has
accumulated — up to ``max_batch`` requests, waiting at most ``max_wait``
seconds for stragglers once the first request of a batch arrives — into
ONE rank-k serve dispatch.  One loop thread owns every device dispatch,
so the engine's cache tensors, updated in place, are never raced.

The port of ``repro.serve.queue``, unchanged but for the engine it wraps.
The queue is intentionally small and dependency-free (threading stdlib
only): it is the admission-control idiom — continuous batching — not a
network server.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch.serve.engine import ServeEngine


class Ticket:
    """One submitted request batch: ``result()`` blocks until the
    dispatch loop has served it (or the queue shut down / the dispatch
    raised, in which case the error re-raises here)."""

    def __init__(self, ids: np.ndarray):
        self.ids = ids
        self._done = threading.Event()
        self._value: Optional[np.ndarray] = None
        self._error: Optional[BaseException] = None

    def _resolve(self, value=None, error=None):
        self._value = value
        self._error = error
        self._done.set()

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self._done.wait(timeout):
            raise TimeoutError("request not served within timeout")
        if self._error is not None:
            raise self._error
        return self._value


class ServeQueue:
    """``max_batch``/``max_wait`` continuous batcher.

    ``submit(ids)`` enqueues and returns a :class:`Ticket` immediately;
    the loop thread coalesces queued tickets into serve batches.  A batch
    closes when it holds ``max_batch`` requests or when ``max_wait``
    seconds have passed since its first ticket arrived — so a lone
    request pays at most ``max_wait`` of queueing latency while a burst
    fills whole rank-k dispatches.  Use as a context manager, or call
    :meth:`close` explicitly.
    """

    def __init__(self, engine: ServeEngine, *, max_wait: float = 0.002,
                 max_batch: Optional[int] = None):
        self.engine = engine
        self.max_wait = float(max_wait)
        self.max_batch = int(max_batch or engine.max_batch)
        if self.max_batch > engine.max_batch:
            raise ValueError(
                f"max_batch={self.max_batch} exceeds the engine's padded "
                f"dispatch width {engine.max_batch}")
        self._pending = collections.deque()
        self._cv = threading.Condition()
        self._closed = False
        self.coalesced_batches = 0
        self.coalesced_sizes: list = []
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # -- client side ----------------------------------------------------------

    def submit(self, ids) -> Ticket:
        """Enqueue a request (scalar sample id or id batch); returns a
        :class:`Ticket` whose ``result()`` blocks until served."""
        arr = np.atleast_1d(np.asarray(ids, np.int64))
        t = Ticket(arr)
        with self._cv:
            if self._closed:
                raise RuntimeError("queue is closed")
            self._pending.append(t)
            self._cv.notify()
        return t

    def serve(self, ids, timeout: Optional[float] = None) -> np.ndarray:
        """Synchronous convenience: submit and wait."""
        return self.submit(ids).result(timeout)

    # -- dispatch loop --------------------------------------------------------

    def _take_batch(self):
        """Block for the first ticket, then collect stragglers until the
        batch is full or ``max_wait`` has elapsed."""
        with self._cv:
            while not self._pending and not self._closed:
                self._cv.wait()
            if not self._pending:
                return None                       # closed and drained
            batch = [self._pending.popleft()]
            size = batch[0].ids.shape[0]
            deadline = time.monotonic() + self.max_wait
            while size < self.max_batch:
                now = time.monotonic()
                if self._pending:
                    nxt = self._pending[0]
                    if size + nxt.ids.shape[0] > self.max_batch:
                        break
                    batch.append(self._pending.popleft())
                    size += nxt.ids.shape[0]
                elif self._closed or now >= deadline:
                    break
                else:
                    self._cv.wait(deadline - now)
            return batch

    def _loop(self):
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            ids = np.concatenate([t.ids for t in batch])
            self.coalesced_batches += 1
            self.coalesced_sizes.append(ids.shape[0])
            try:
                out = self.engine.serve(ids)
            except BaseException as e:          # noqa: BLE001 — relayed
                for t in batch:
                    t._resolve(error=e)
                continue
            lo = 0
            for t in batch:
                t._resolve(value=out[lo:lo + t.ids.shape[0]])
                lo += t.ids.shape[0]

    # -- lifecycle ------------------------------------------------------------

    def close(self, timeout: float = 10.0):
        """Stop admitting, drain the queue, join the loop thread."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
