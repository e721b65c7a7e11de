"""Dynamic request batching: coalesce concurrent mel->wav requests.

The reference has no serving layer — its harness synthesizes one utterance
at a time in a local loop (reference bin/test.py:126-129).  On the GPU the
throughput comes from batching (`models/batched.py` runs one batch per
(bucket, group) shape), but a live service receives requests
one at a time on many connections.  This module is the missing piece: a
background worker that collects requests for up to `max_wait_ms` (or until
`max_batch` are pending) and runs them through the batched synthesizer as
one group, trading a bounded latency budget for larger batches.

Pure stdlib (threads + futures) — host-side coalescing only; all device
work stays in the synthesizer.  With the recorder on (`runtime/profiler.py`)
each request's `batcher.submit` and the worker's `batcher.wait` (nothing
pending), `batcher.collect` (first request taken -> group closed by size or
deadline) and `batcher.call` (the synthesize call, its request ids) ->
`batcher.resolve` (futures set) are spans.

The port's copy of `fastvocoder_tpu/serving/batcher.py`.
"""

from __future__ import annotations

import collections
import itertools
import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, List, Sequence

import numpy as np

from fastvocoder_tpu_torch.runtime.profiler import annotate

_CLOSE = object()


class QueueFull(RuntimeError):
    """Raised by submit() when the pending-request cap is reached — the
    service's backpressure signal (the HTTP frontend maps it to 503)."""


class DynamicBatcher:
    """Wraps `synthesize(list[mel]) -> list[wav]` (e.g. BatchedSynthesizer)
    with request coalescing.

    submit(mel) -> Future[wav]; requests arriving within `max_wait_ms` of
    each other (up to `max_batch`) execute as one call.  The synthesizer
    itself buckets by length, so mixed-length groups are fine.
    """

    def __init__(
        self,
        synthesize: Callable[[Sequence[np.ndarray]], List[np.ndarray]],
        max_batch: int = 32,
        max_wait_ms: float = 5.0,
        max_pending: int = 1024,
    ):
        self.synthesize = synthesize
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        self.requests_served = 0
        self.batches_run = 0
        self._latencies: "collections.deque" = collections.deque(maxlen=1024)
        self._batch_sizes: "collections.deque" = collections.deque(maxlen=1024)
        self._q: "queue.Queue" = queue.Queue(maxsize=max_pending)
        self._closed = False
        self._request_ids = itertools.count(1)
        # guards the closed-check-then-enqueue pair (a submit racing close
        # could otherwise land a Future behind the sentinel that nothing
        # ever resolves) and the stats deques (iterating while the worker
        # appends raises "deque mutated during iteration")
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def submit(self, mel: np.ndarray) -> "Future[np.ndarray]":
        fut: "Future[np.ndarray]" = Future()
        rid = next(self._request_ids)
        with annotate("batcher.submit", request=rid), self._lock:
            if self._closed:
                raise RuntimeError("DynamicBatcher is closed")
            try:
                self._q.put_nowait((mel, fut, time.monotonic(), rid))
            except queue.Full:
                raise QueueFull(
                    f"{self._q.maxsize} requests already pending"
                ) from None
        return fut

    def stats(self) -> dict:
        """Rolling (last 1024 requests) service statistics."""
        with self._lock:
            lat = sorted(self._latencies)
            bs = list(self._batch_sizes)

        def pct(p):
            return lat[min(len(lat) - 1, int(p * len(lat)))] if lat else None

        return {
            "requests_served": self.requests_served,
            "batches_run": self.batches_run,
            "pending": self._q.qsize(),
            "latency_ms_p50": pct(0.50),
            "latency_ms_p95": pct(0.95),
            "mean_batch_size": sum(bs) / len(bs) if bs else None,
        }

    def __call__(self, mel: np.ndarray) -> np.ndarray:
        """Blocking convenience: submit + wait."""
        return self.submit(mel).result()

    def close(self):
        """Stop accepting requests; the worker finishes everything already
        submitted, then exits."""
        with self._lock:
            already = self._closed
            self._closed = True
        if not already:
            self._q.put(_CLOSE)  # blocking put: the cap never drops it
        self._thread.join()

    # ---- worker ----

    def _worker(self):
        while True:
            with annotate("batcher.wait"):
                item = self._q.get()
            if item is _CLOSE:
                return
            batch = [item]
            closing = False
            with annotate("batcher.collect"):
                deadline = time.monotonic() + self.max_wait
                while len(batch) < self.max_batch:
                    timeout = deadline - time.monotonic()
                    if timeout <= 0:
                        break
                    try:
                        nxt = self._q.get(timeout=timeout)
                    except queue.Empty:
                        break
                    if nxt is _CLOSE:
                        closing = True
                        break
                    batch.append(nxt)
            self._run(batch)
            if closing:
                # drain whatever raced in behind the close sentinel
                rest = []
                try:
                    while True:
                        it = self._q.get_nowait()
                        if it is not _CLOSE:
                            rest.append(it)
                except queue.Empty:
                    pass
                if rest:
                    self._run(rest)
                return

    def _run(self, batch):
        mels = [m for m, _, _, _ in batch]
        with annotate("batcher.call", requests=[rid for _, _, _, rid in batch]):
            try:
                wavs = self.synthesize(mels)
                done = time.monotonic()
                with annotate("batcher.resolve"), self._lock:
                    for (_, fut, t0, _), wav in zip(batch, wavs):
                        fut.set_result(wav)
                        self._latencies.append((done - t0) * 1e3)
                    self._batch_sizes.append(len(batch))
                    self.requests_served += len(batch)
                    self.batches_run += 1
            except Exception as e:  # deliver to every waiter, keep serving
                for _, fut, _, _ in batch:
                    fut.set_exception(e)
