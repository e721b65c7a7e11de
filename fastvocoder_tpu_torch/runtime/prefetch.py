"""Host -> device input pipeline: background-thread prefetch of batches.

The port's counterpart of `fastvocoder_tpu/runtime/prefetch.py`.  The
reference overlaps host data work with compute through DataLoader worker
processes and pinned memory (reference bin/train.py:398-405); here a
daemon thread runs the (numpy) batch iterator, pins each batch and copies
it to the card on a side CUDA stream, so that batch k+1 is assembled and
in flight while step k runs.

Ordering on the card: the producer records an event on its stream after a
batch's copies; the consumer makes its own stream wait for that event and
`record_stream`s each tensor on it, so the caching allocator does not hand
the memory out again while the step that reads it is queued.  On the CPU
it is the same thread and queue with plain tensors.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Mapping

import numpy as np
import torch

from fastvocoder_tpu_torch import resolve_device


def _as_tensor(v) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v))


def prefetch_to_device(iterator: Iterator[Mapping], device="cuda",
                       size: int = 2) -> Iterator[Dict[str, torch.Tensor]]:
    """Wrap a host batch iterator (dicts of numpy arrays or tensors) with
    `size` batches of prefetch onto `device` (the card unless "cpu" is
    asked for; raises without one).

    A producer's exception reaches the consumer after the batches before
    it, even when the queue was full as it raised.  Early exit is safe:
    when the consumer abandons the generator (a `max_steps` return), the
    producer is told to stop and the queue is drained, so the thread ends
    instead of blocking on a full queue."""
    device = resolve_device(device)
    cuda = device.type == "cuda"
    if cuda and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    q: "queue.Queue" = queue.Queue(maxsize=size)
    end = object()
    err: list = []
    stop = threading.Event()

    def put(item) -> bool:
        while True:
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                if stop.is_set():
                    return False

    def producer():
        try:
            stream = None
            if cuda:
                torch.cuda.set_device(device)
                stream = torch.cuda.Stream(device)
            for batch in iterator:
                if stop.is_set():
                    return
                if cuda:
                    with torch.cuda.stream(stream):
                        out = {k: _as_tensor(v).pin_memory().to(device, non_blocking=True)
                               for k, v in batch.items()}
                        ready = torch.cuda.Event()
                        ready.record(stream)
                else:
                    out, ready = {k: _as_tensor(v) for k, v in batch.items()}, None
                if not put((out, ready)):
                    return
        except Exception as e:  # surfaced in the consumer
            err.append(e)
        finally:
            # the end must reach the consumer even with the queue full (a
            # consumer slower than the producer): retry as a batch's put does;
            # only a consumer that has left stops it
            put(end)

    t = threading.Thread(target=producer, daemon=True, name="prefetch_to_device")
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                if err:
                    raise err[0]
                return
            out, ready = item
            if ready is not None:
                consumer = torch.cuda.current_stream(device)
                consumer.wait_event(ready)
                for v in out.values():
                    v.record_stream(consumer)
            yield out
    finally:
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
