"""The program's spans, and traces of a block.

`annotate(name, **ids)` marks a span of work: a context manager that, when
the recorder is on, keeps the span's name, its start and end on
`time.perf_counter_ns()`, the thread it ran on, the span it opened inside
(the innermost span open on the same thread) and the identifiers given
(request ids, a group's bucket and rows, a step).  The recorder is global,
not per thread: the request batcher's worker thread, whose work
`torch.profiler` does not record (its `record_function` spans reach the
trace only from the thread that started the profiler), is covered like any
other.  Counts (groups, rows, frames, steps) are read from the spans and
their identifiers.

The recorder is on while a `torch.profiler` profile runs (torch's own flag,
which every thread reads), so that any profiled block gets the spans of
every thread, and between `enable()` and `disable()`, for a caller that
wants the spans without a profile.  Off, `annotate` returns one shared
no-op context manager: a check of two flags, no `record_function`.  Spans
are kept in a bounded buffer (the oldest go first; `dropped` counts them),
so a recorder left on holds at most `CAPACITY` spans.  `drain()` takes the
closed spans and clears the buffer.

`trace(logdir)` profiles a block and writes one Chrome trace: the
profiler's host and device events and the program's spans, on the trace's
clock, one track per thread (open it in Perfetto).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch

CAPACITY = 1 << 17
ANCHOR = "fastvocoder.trace"  # the `record_function` that pins the host clock in a trace

# `_torch_profiler._is_profiler_enabled`: torch's own flag of a running profile
_torch_profiler = torch.autograd.profiler
_NOOP = contextlib.nullcontext()


class Span(NamedTuple):
    name: str
    start_ns: int  # time.perf_counter_ns()
    end_ns: int
    thread: int  # threading.get_native_id()
    id: int  # from 1, in the order the spans opened
    parent: int  # the innermost span open on the same thread as it opened, or 0
    ids: Optional[dict]  # the identifiers given to annotate(), or None


class Recording(NamedTuple):
    spans: List[Span]  # in the order they closed
    threads: Dict[int, str]  # native thread id -> the thread's name
    dropped: int  # spans the bounded buffer let go since the last drain


class Recorder:
    def __init__(self, capacity: int = CAPACITY):
        self.on = False
        self._spans: "collections.deque[tuple]" = collections.deque(maxlen=capacity)
        self._threads: Dict[int, str] = {}
        self._dropped = 0
        self._next_id = itertools.count(1)
        self._lock = threading.Lock()
        self._local = threading.local()

    def _thread(self):
        """This thread's stack of open span ids and its native id (read once:
        it is a system call)."""
        local = self._local
        if not hasattr(local, "stack"):
            local.stack, local.tid = [], threading.get_native_id()
            self._threads[local.tid] = threading.current_thread().name
        return local

    def _keep(self, span: tuple) -> None:
        if len(self._spans) == self._spans.maxlen:
            with self._lock:
                self._dropped += 1
        self._spans.append(span)

    def drain(self) -> Recording:
        with self._lock:
            # popleft one at a time: a span that closes meanwhile is kept for the next drain
            spans = [Span._make(self._spans.popleft()) for _ in range(len(self._spans))]
            dropped, self._dropped = self._dropped, 0
            threads = dict(self._threads)
        return Recording(spans, threads, dropped)


class _Open:
    """One span being recorded."""

    __slots__ = ("rec", "name", "ids", "id", "parent", "start", "local")

    def __init__(self, rec: Recorder, name: str, ids: Optional[dict]):
        self.rec, self.name, self.ids = rec, name, ids

    def __enter__(self):
        self.local = local = self.rec._thread()
        self.parent = local.stack[-1] if local.stack else 0
        self.id = next(self.rec._next_id)
        local.stack.append(self.id)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.local.stack.pop()
        # a plain tuple: `drain` makes the `Span`s
        self.rec._keep((self.name, self.start, end, self.local.tid, self.id, self.parent,
                        self.ids))
        return False


_recorder = Recorder()


def annotate(name: str, **ids):
    """A span named `name` around the enclosed block, with identifiers
    `ids`; the shared no-op while the recorder is off."""
    if not (_recorder.on or _torch_profiler._is_profiler_enabled):
        return _NOOP
    return _Open(_recorder, name, ids or None)


def enable() -> None:
    _recorder.on = True


def disable() -> None:
    _recorder.on = False


def drain() -> Recording:
    """The spans closed since the last drain; clears the buffer."""
    return _recorder.drain()


def _chrome_events(rec: Recording, offset_us: float) -> List[dict]:
    """`rec`'s spans as Chrome trace events at `perf_counter_ns() / 1e3 +
    offset_us`, one track per thread of a process of their own."""
    pid = "fastvocoder spans"
    out = [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": "fastvocoder spans (runtime/profiler.py)"}}]
    for tid, name in rec.threads.items():
        out.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                    "args": {"name": f"{name} ({tid})"}})
    for s in rec.spans:
        args = {"id": s.id, "parent": s.parent}
        if s.ids:
            args.update({k: v if isinstance(v, (int, float, str)) else list(v)
                         for k, v in s.ids.items()})
        out.append({"ph": "X", "cat": "program_span", "name": s.name, "pid": pid,
                    "tid": s.thread, "ts": s.start_ns / 1e3 + offset_us,
                    "dur": (s.end_ns - s.start_ns) / 1e3, "args": args})
    return out


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block with `torch.profiler` (CPU, and CUDA where
    a card is present), the recorder on, and write `<logdir>/trace.json`, a
    Chrome trace holding the program's spans beside the profiler's events
    (open it in Perfetto or chrome://tracing).  The running profile turns
    the recorder on; the block's spans are drained.  Yields the profiler.

    One clock: the trace's timestamps are wall-clock microseconds; the
    last of three `ANCHOR` spans opened as the block starts is read against
    `perf_counter_ns()` taken inside it, and every span is moved by that
    offset (the first `record_function` of a profile starts its event up
    to a millisecond before it returns; the third, within microseconds)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(3):
            with torch.profiler.record_function(ANCHOR):
                anchor_ns = time.perf_counter_ns()
        yield prof
    rec = drain()
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    # the host's events only: a span around device work has a copy on the device's track
    at = max(float(e["ts"]) for e in events
             if e.get("name") == ANCHOR and e.get("cat") == "user_annotation")
    events.extend(_chrome_events(Recording([s for s in rec.spans if s.start_ns >= anchor_ns],
                                          rec.threads, rec.dropped),
                                at - anchor_ns / 1e3))
    with open(path + ".tmp", "w") as f:
        json.dump(doc, f)
    os.replace(path + ".tmp", path)
