"""Keyed batch coalescer: the machinery under the streaming mux and the
query coalescer (counterpart of ``audio_rag_tpu/utils/coalescer.py``).

Items that arrive while a dispatch is in flight accumulate and ride the
next batch together: the previous dispatch is the accumulation window.
Only items with the same key batch (the key carries whatever selects the
batch's parameters); mixed keys go out in consecutive rounds, one key
group each, so no key starves another.

One worker thread owns every dispatch, so concurrent clients never touch
the device from their own threads. ``linger_s``: after a round's first
item, keep draining until no new item has arrived for this long (clients
woken together by one batch's end resubmit one at a time, and without a
linger the first of them would ship alone). A failing batch fails its own
futures and the worker goes on. After :meth:`stop`, submitting raises;
every accepted item resolves, those still queued at the stop with an
error. :meth:`call` runs a function on the worker between batches.

Subclasses implement :meth:`_run_batch`; per-item results resolve each
item's future.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import Future
from typing import Any, Callable, Sequence

__all__ = ["KeyedCoalescer", "PendingItem"]

_CALL = (object(),)  # the key of a function run by call(): no other


class PendingItem:
    """One queued item: a payload, its batch key, and its future."""

    __slots__ = ("payload", "key", "future")

    def __init__(self, payload: Any, key: tuple):
        self.payload = payload
        self.key = key
        self.future: Future = Future()


class KeyedCoalescer:
    """Base batching worker; see the module docstring."""

    #: thread name for the worker
    worker_name = "coalescer"
    #: seconds to wait for the worker on stop()
    join_timeout_s = 10.0

    def __init__(self, max_batch: int, linger_s: float = 0.0):
        self.max_batch = max_batch
        self.linger_s = linger_s
        self._queue: "queue.Queue[PendingItem | None]" = queue.Queue()
        # serializes _submit() against stop(): a submit that read
        # _stopped == False must not land its item after stop() drained
        # the queue, or its client would wait forever
        self._submit_lock = threading.Lock()
        self._stopped = False
        self.batches_run = 0
        self.items_served = 0
        self._thread = threading.Thread(
            target=self._loop, name=self.worker_name, daemon=True)
        self._thread.start()

    # -- client API ------------------------------------------------------
    def _submit(self, payload: Any, key: tuple) -> Future:
        p = PendingItem(payload, key)
        with self._submit_lock:
            if self._stopped:
                raise RuntimeError(f"{self.worker_name} stopped")
            self._queue.put(p)
        return p.future

    def call(self, fn: Callable[[], Any]) -> Future:
        """Run ``fn()`` on the worker thread between batches; the future
        holds its result or its exception."""
        return self._submit(fn, _CALL)

    def stop(self) -> None:
        with self._submit_lock:
            if self._stopped:
                return
            self._stopped = True
            self._queue.put(None)
        self._thread.join(timeout=self.join_timeout_s)
        # fail what the worker requeued behind the sentinel instead of
        # leaving those futures unresolved
        while True:
            try:
                p = self._queue.get_nowait()
            except queue.Empty:
                break
            if p is not None and not p.future.done():
                p.future.set_exception(
                    RuntimeError(f"{self.worker_name} stopped"))

    # -- subclass contract -------------------------------------------------
    def _run_batch(self, payloads: list, key: tuple) -> Sequence:
        """Dispatch one same-key batch; return one result per payload."""
        raise NotImplementedError

    # -- worker ------------------------------------------------------------
    def _next(self) -> "PendingItem | None":
        """Next queued item during the drain: linger past the last
        arrival when configured, else take only what is already queued."""
        if self.linger_s > 0:
            return self._queue.get(timeout=self.linger_s)
        return self._queue.get_nowait()

    def _loop(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            if item.key is _CALL:
                try:
                    item.future.set_result(item.payload())
                except Exception as exc:  # the caller reads it
                    item.future.set_exception(exc)
                continue
            batch = [item]
            requeue = []
            while len(batch) < self.max_batch:
                try:
                    nxt = self._next()
                except queue.Empty:
                    break
                if nxt is None:
                    self._queue.put(None)
                    break
                if nxt.key == item.key:
                    batch.append(nxt)
                else:
                    requeue.append(nxt)
            for p in requeue:
                self._queue.put(p)

            try:
                results = self._run_batch(
                    [p.payload for p in batch], item.key)
            except Exception as exc:
                for p in batch:
                    if not p.future.done():
                        p.future.set_exception(exc)
                continue
            self.batches_run += 1
            self.items_served += len(batch)
            for p, r in zip(batch, results):
                if not p.future.done():
                    p.future.set_result(r)
