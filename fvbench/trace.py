"""The `--trace 1` run's device trace, and its reduction to numbers.

The window is profiled with `torch.profiler` (host and device activity) and
marked by the benchmark's span `fvbench.window`.  The benchmark's wrapper
around each generator call keeps the call's interval on the host clock (the
request batcher's worker thread makes the calls, and the profiler records no
spans of that thread); the window's span anchors that clock in the trace's.
No other thread launches device work while a call runs.  The Chrome trace
the profiler exports is reduced to:

  window_s      the `fvbench.window` span's length
  busy_s        the union of the device's kernels, copies and sets in it
  span_device_s the device time of the kernels launched inside a generator
                call: each kernel matched to its launch (a CUDA runtime
                event) by the trace's correlation ids, so a
                kernel that runs after the call has returned still counts
  device_ops    the ten device operations that took most time, by name
  idle_gaps     the ten longest kinds of idle gap, named by the innermost
                host event running at the gap's middle, or, where none ran,
                by the device operation before it
"""

from __future__ import annotations

import bisect
import json
import os
import re
import shutil
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch

WINDOW = "fvbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    span_device_s: float
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)


def start():
    """A started `torch.profiler` over host and device activity."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def open_span(name: str):
    span = torch.profiler.record_function(name)
    span.__enter__()
    return span


def close_span(span) -> None:
    span.__exit__(None, None, None)


def _short(name: str) -> str:
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"\(.*", "", name)
    name = re.sub(r"<.*", "", name)
    return re.sub(r"[^A-Za-z0-9_.:]+", "_", name.replace("void ", "").strip())[:80] or "op"


def export_events(prof) -> List[dict]:
    """The profile's complete events, through its Chrome trace (written to
    a temporary directory under TMPDIR and removed)."""
    tmp = tempfile.mkdtemp(prefix="fvbench_trace_")
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def _union(intervals: List[Tuple[float, float, str]]) -> List[Tuple[float, float, str]]:
    """Merged busy intervals, each with the name of the op that ended last."""
    out: List[List] = []
    for s, e, n in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1], out[-1][2] = e, n
        else:
            out.append([s, e, n])
    return [tuple(x) for x in out]


def reduce(events: List[dict], calls=(), anchor: float = 0.0) -> TraceSummary:
    """`calls`: (start, end) of each generator call on the host clock
    (`time.perf_counter`), `anchor` that clock's reading as the window's
    span opened."""
    windows = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == WINDOW]
    if not windows:
        raise RuntimeError(f"the trace holds no {WINDOW} span")
    w0 = float(windows[0]["ts"])
    w1 = w0 + float(windows[0]["dur"])

    device, by_name = [], defaultdict(float)
    launches_of: Dict[int, dict] = {}
    spans = sorted((w0 + (a - anchor) * 1e6, w0 + (b - anchor) * 1e6) for a, b in calls)
    starts = [a for a, _ in spans]
    for e in events:
        cat = e.get("cat")
        if cat in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {}):
            launches_of[e["args"]["correlation"]] = e
    span_us = 0.0
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        s = float(e["ts"])
        t = s + float(e["dur"])
        if spans and e.get("cat") == "kernel":
            launch = launches_of.get(e.get("args", {}).get("correlation"))
            if launch is not None:
                at = float(launch["ts"])
                i = bisect.bisect_right(starts, at) - 1
                if i >= 0 and at <= spans[i][1]:
                    span_us += float(e["dur"])
        s, t = max(s, w0), min(t, w1)
        if t > s:
            device.append((s, t, _short(e["name"])))
            by_name[_short(e["name"])] += (t - s) / 1e6

    busy = _union(device)
    busy_us = sum(t - s for s, t, _ in busy)

    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
                  if e.get("cat") in HOST_CATS and e["name"] != WINDOW)
    host_starts = [h[0] for h in host]
    gaps = defaultdict(float)
    edges = [(w0, w0, "window_start")] + busy + [(w1, w1, "window_end")]
    for (_, a, before), (b, _, _) in zip(edges, edges[1:]):
        if b <= a:
            continue
        mid = (a + b) / 2
        label, best = None, None
        # the innermost host event covering the middle of the gap
        for h in host[max(0, bisect.bisect_right(host_starts, mid) - 256):
                      bisect.bisect_right(host_starts, mid)]:
            if h[1] >= mid and (best is None or h[1] - h[0] < best):
                label, best = h[2], h[1] - h[0]
        gaps[_short(label) if label else f"no_host_event_after_{before}"] += (b - a) / 1e6

    top = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:10]  # noqa: E731
    return TraceSummary(window_s=(w1 - w0) / 1e6, busy_s=busy_us / 1e6,
                        span_device_s=span_us / 1e6, device_ops=top(by_name),
                        idle_gaps=top(gaps))
