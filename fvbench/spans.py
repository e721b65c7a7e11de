"""The program's own spans in a `--trace 1` run, on the device trace's
clock: what the readers of `program_span` metrics share.

The program's recorder (`fastvocoder_tpu_torch/runtime/profiler.py`) is on
while a `torch.profiler` profile runs, on every thread: the traced slice of
the window gets the spans of the request batcher's worker, the bucketed
synthesizer, the device corpus and the trainer.  The first reader drains
it.  The spans are moved onto the trace's clock by the window's anchor
(`common.Context.window`: the `fvbench.window` span's start against
`time.perf_counter()` read as it opened), as `trace.reduce` moves the
benchmark's generator calls.  A program without the recorder leaves nothing
to read, and every reader returns None; a program with it that recorded no
span in the traced slice is at fault, and the first reader raises.

The host times (`host_ms.train`, `input_ms.train`, `host_ms_per_call.*`)
are read inside the profiled slice, so they include what the profiler
costs the host (its record of every operator and launch): a traced
pre-adversarial step takes 71-118 ms against 47-53 untraced.

Two attributions:

  idle     the window's device-idle time (its complement of the union of
           kernels, copies and sets: `idle_share.*`'s), by the innermost
           span open on the work thread (the thread whose spans cover most
           of the window) at each idle instant, or by none
  kernels  each kernel to the innermost span open on the thread that ran
           the steps when it was launched: the launch (a CUDA runtime or
           driver event) matched to the kernel by correlation id, so that a
           backward's kernels, which autograd's device thread launches
           while the step's thread waits in `train.gen_backward`, fall there

The first reader also prints both on standard error, with the share of the
idle time that a span names and the share of the steps' kernel time that
the input and phase spans name.
"""

from __future__ import annotations

import bisect
import functools
import importlib
import sys
import time
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from fvbench import trace

Interval = Tuple[float, float]


def slice_of(run) -> Optional["ProgramSlice"]:
    """The traced slice's program spans, drained once a run; None where the
    run is not traced or the program has no recorder."""
    if "_program_slice" not in run.__dict__:
        run.__dict__["_program_slice"] = _drain(run)
    return run.__dict__["_program_slice"]


def _drain(run) -> Optional["ProgramSlice"]:
    profiler = importlib.import_module("fastvocoder_tpu_torch.runtime.profiler")
    drain = getattr(profiler, "drain", None)
    ctx = getattr(run, "ctx", None)
    # the anchor and the stopped profile: a `--trace 1` window's, not a stand-in's
    if run.traced is None or drain is None or getattr(ctx, "_stopped", None) is None:
        return None
    rec = drain()
    t0, t1 = int(ctx._anchor * 1e9), int(run.traced["end"] * 1e9)
    spans = [s for s in rec.spans if s.end_ns > t0 and s.start_ns < t1]
    if not spans:
        raise RuntimeError(f"the program's recorder kept no span in the traced slice "
                           f"({len(rec.spans)} spans drained, none inside it)")
    out = ProgramSlice(spans, t0, t1, lambda: kineto_events(ctx._stopped), rec.dropped)
    out.report()
    return out


def kineto_events(prof):
    """The stopped profile's events as (category, name, start us, length us,
    correlation id), on the Chrome export's clock: read from its results,
    since its one export is spent (`trace.export_events`).  The categories
    are the export's, told by device and name (a torch before 2.13 does not
    give them): on the host, a CUDA runtime or driver call (`cu...`) or
    another event; on the card, a copy (`Memcpy ...`), a set (`Memset ...`),
    the card's copy of a host annotation (the name of a host event), or a
    kernel."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    host = {e.name() for e in events if e.device_type() == DeviceType.CPU}
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            cat = ("cuda_runtime" if name.startswith("cu")
                   else "user_annotation" if name == trace.WINDOW else "cpu_op")
        elif name.startswith("Memcpy"):
            cat = "gpu_memcpy"
        elif name.startswith("Memset"):
            cat = "gpu_memset"
        else:
            cat = "gpu_user_annotation" if name in host else "kernel"
        yield cat, name, e.start_ns() / 1e3, e.duration_ns() / 1e3, e.correlation_id()


def union(intervals: Iterable[Interval]) -> List[Interval]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        elif b > a:
            out.append([a, b])
    return [(a, b) for a, b in out]


def overlap(xs: Sequence[Interval], ys: Sequence[Interval]) -> float:
    """The length of the intersection of two sorted lists of disjoint intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def innermost(spans) -> List[Tuple[float, float, str]]:
    """One thread's properly nested spans, (start, end, name) each, as the
    segments of time each span is the innermost one open, in order."""
    segs: List[Tuple[float, float, str]] = []
    stack: List[Tuple[float, float, str]] = []
    at = 0.0
    for s in sorted(spans, key=lambda s: (s[0], -s[1])):
        while stack and stack[-1][1] <= s[0]:
            top = stack.pop()
            if top[1] > at:
                segs.append((at, top[1], top[2]))
            at = top[1]
        if stack and s[0] > at:
            segs.append((at, s[0], stack[-1][2]))
        at = s[0]
        stack.append(s)
    while stack:
        top = stack.pop()
        if top[1] > at:
            segs.append((at, top[1], top[2]))
        at = top[1]
    return segs


def by_segment(segs, intervals: Sequence[Interval]) -> Dict[Optional[str], float]:
    """The length of `intervals` (sorted, disjoint) under each segment's
    name, and under None where no segment lies."""
    out: Dict[Optional[str], float] = defaultdict(float)
    starts = [s[0] for s in segs]
    for a, b in intervals:
        covered = 0.0
        for s0, s1, name in segs[max(0, bisect.bisect_right(starts, a) - 1):
                                 bisect.bisect_left(starts, b)]:
            x, y = max(a, s0), min(b, s1)
            if y > x:
                out[name] += y - x
                covered += y - x
        out[None] += (b - a) - covered
    return out


def name_at(segs, starts, t: float) -> Optional[str]:
    i = bisect.bisect_right(starts, t) - 1
    return segs[i][2] if i >= 0 and t < segs[i][1] else None


class ProgramSlice:
    """Spans (`runtime/profiler.py::Span`) that overlap the traced slice
    [t0, t1] (perf_counter_ns), and the device trace's events (`events()`:
    `kineto_events`' tuples), read on first use."""

    def __init__(self, spans, t0: int, t1: int, events, dropped: int = 0):
        self.spans, self.t0, self.t1 = spans, t0, t1
        self._events, self.dropped = events, dropped

    @functools.cached_property
    def complete_all(self):
        """The spans that opened and closed inside the slice."""
        return [s for s in self.spans if s.start_ns >= self.t0 and s.end_ns <= self.t1]

    def complete(self, name: str):
        """The spans named `name` that opened and closed inside the slice."""
        return [s for s in self.complete_all if s.name == name]

    def mean_ms(self, name: str) -> Optional[float]:
        ds = [(s.end_ns - s.start_ns) / 1e6 for s in self.complete(name)]
        return sum(ds) / len(ds) if ds else None

    # ---- on the trace's clock ----

    @functools.cached_property
    def device(self):
        """(w0, w1) of the window in trace microseconds, the device's idle
        intervals in it (the complement of the union of its kernels, copies
        and sets, as `trace.reduce` counts `busy_s`), and each kernel's
        launch time (None: no launch matched) and length."""
        t = time.perf_counter()
        window, device, launched = None, [], {}
        for cat, name, ts, dur, corr in self._events():
            if cat in ("cuda_runtime", "cuda_driver"):
                launched[corr] = ts
            elif cat in trace.DEVICE_CATS:
                device.append((cat, ts, dur, corr))
            elif cat == "user_annotation" and name == trace.WINDOW and window is None:
                window = (ts, ts + dur)
        self._events = None
        w0, w1 = window
        busy = union((max(ts, w0), min(ts + dur, w1)) for _, ts, dur, _ in device)
        edges = [w0] + [x for iv in busy for x in iv] + [w1]
        idle = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
        kernels = [(launched.get(corr), dur) for cat, _, dur, corr in device if cat == "kernel"]
        self.read_s = time.perf_counter() - t
        return w0, w1, idle, kernels

    def us(self, t_ns: int) -> float:
        return self.device[0] + (t_ns - self.t0) / 1e3

    def intervals(self, name: str) -> List[Interval]:
        """The union of the spans named `name`, cut to the window."""
        w0, w1 = self.device[:2]
        return union((max(self.us(s.start_ns), w0), min(self.us(s.end_ns), w1))
                     for s in self.spans if s.name == name)

    def idle_share_within(self, name: str) -> Optional[float]:
        """Percent of the window in which the card is idle inside a span `name`."""
        w0, w1, idle, _ = self.device
        within = self.intervals(name)
        return 100.0 * overlap(idle, within) / (w1 - w0) if within else None

    def segments(self, thread: int):
        return innermost([(self.us(s.start_ns), self.us(s.end_ns), s.name)
                          for s in self.spans if s.thread == thread])

    @functools.cached_property
    def work_thread(self) -> int:
        """The thread whose outermost spans cover most of the slice."""
        cover: Dict[int, float] = defaultdict(float)
        for s in self.spans:
            if s.parent == 0:
                cover[s.thread] += min(s.end_ns, self.t1) - max(s.start_ns, self.t0)
        return max(cover, key=cover.get)

    def idle_by_span(self) -> Dict[Optional[str], float]:
        """The window's idle microseconds by the work thread's innermost span."""
        return by_segment(self.segments(self.work_thread), self.device[2])

    # ---- training steps ----

    @functools.cached_property
    def steps(self):
        """The complete `train.step` spans, the kernels launched from the
        first one's input (its `data.gather`) to the last one's end by the
        name of the step thread's span open at the launch (None: no span),
        and all those kernels' microseconds."""
        steps = sorted(self.complete("train.step"), key=lambda s: s.start_ns)
        if not steps:
            return None
        thread = steps[0].thread
        gathers = [s for s in self.complete("data.gather")
                   if s.thread == thread and s.end_ns <= steps[0].start_ns]
        lo = self.us(max(gathers, key=lambda s: s.end_ns).start_ns if gathers
                     else steps[0].start_ns)
        hi = self.us(steps[-1].end_ns)
        segs = self.segments(thread)
        starts = [s[0] for s in segs]
        by_name: Dict[Optional[str], float] = defaultdict(float)
        total = 0.0
        for at, dur in self.device[3]:
            if at is not None and lo <= at <= hi:
                by_name[name_at(segs, starts, at)] += dur
                total += dur
        return steps, by_name, total

    def step_device_ms(self, names: Sequence[str]) -> Optional[float]:
        """Device milliseconds a step of the kernels launched in spans `names`."""
        if self.steps is None:
            return None
        steps, by_name, _ = self.steps
        return sum(by_name.get(n, 0.0) for n in names) / 1e3 / len(steps)

    # ---- serving ----

    def host_ms_per_call(self) -> Optional[float]:
        """Mean host milliseconds a generator call (`synth.group`) spends in
        the work around it that does not wait on the card: pad, copy in,
        enqueue, trim (and the pattern's subtraction)."""
        groups = {s.id for s in self.complete("synth.group")}
        if not groups:
            return None
        host = sum(s.end_ns - s.start_ns for s in self.spans if s.parent in groups
                   and s.name in ("synth.pad", "synth.h2d", "synth.launch", "synth.trim"))
        host += sum(s.end_ns - s.start_ns for s in self.complete("serve.pattern"))
        return host / 1e6 / len(groups)

    def behind_call_ms(self) -> Optional[float]:
        """Mean milliseconds a request waited, from its submit to the start
        of the `batcher.call` that served it, behind other calls running."""
        calls = sorted(self.complete("batcher.call"), key=lambda s: s.start_ns)
        submitted = {s.ids["request"]: s.end_ns for s in self.spans
                     if s.name == "batcher.submit" and s.ids}
        busy = union((s.start_ns, s.end_ns) for s in self.spans if s.name == "batcher.call")
        waits = [overlap([(submitted[r], c.start_ns)], busy) / 1e6
                 for c in calls for r in (c.ids or {}).get("requests", ())
                 if r in submitted and submitted[r] >= self.t0]
        return sum(waits) / len(waits) if waits else None

    def self_ms(self) -> Dict[str, Tuple[float, int]]:
        """Each span name's host self time in the slice (its spans' length
        less their children's), in ms, and how many spans."""
        inside: Dict[int, int] = defaultdict(int)
        for s in self.spans:
            inside[s.parent] += s.end_ns - s.start_ns
        out: Dict[str, List] = defaultdict(lambda: [0.0, 0])
        for s in self.complete_all:
            out[s.name][0] += (s.end_ns - s.start_ns - inside[s.id]) / 1e6
            out[s.name][1] += 1
        return {k: (v[0], v[1]) for k, v in out.items()}

    # ---- the log ----

    def report(self) -> None:
        w0, w1, idle, _ = self.device
        idle_s = sum(b - a for a, b in idle) / 1e6
        named = self.idle_by_span()
        shown = ", ".join(f"{k or '(no span)'} {v / 1e6:.4f}"
                          for k, v in sorted(named.items(), key=lambda kv: -kv[1]))
        share = 100.0 * (1.0 - named.get(None, 0.0) / 1e6 / idle_s) if idle_s > 0 else 100.0
        print(f"program spans: {len(self.spans)} in the slice ({self.dropped} let go by the "
              f"recorder's bound); the window's idle {idle_s:.4f} of {(w1 - w0) / 1e6:.4f} s by the innermost span "
              f"of thread {self.work_thread}: {shown}; named {share:.2f}%; the trace read in "
              f"{self.read_s:.1f} s", file=sys.stderr)
        own = sorted(self.self_ms().items(), key=lambda kv: -kv[1][0])
        print("program spans: host self time, ms (spans): " + ", ".join(
            f"{k} {v:.1f} ({n})" for k, (v, n) in own), file=sys.stderr)
        if self.steps is not None:
            steps, by_name, total = self.steps
            named_us = sum(v for k, v in by_name.items()
                           if k == "data.gather" or (k or "").startswith("train.")
                           and k != "train.step")
            period = (steps[-1].start_ns - steps[0].start_ns) / 1e6 / max(len(steps) - 1, 1)
            shown = ", ".join(f"{k or '(no span)'} {v / 1e3 / len(steps):.3f}"
                              for k, v in sorted(by_name.items(), key=lambda kv: -kv[1]))
            unmatched = sum(d for at, d in self.device[3] if at is None)
            print(f"program spans: {len(steps)} steps, host {self.mean_ms('train.step'):.3f} "
                  f"ms a step (train.step), {period:.3f} ms from one step's start to the next; "
                  f"kernel ms a step by span: {shown}; the input and phase spans name "
                  f"{100.0 * named_us / total if total else 0.0:.2f}% of {total / 1e6:.4f} s; "
                  f"kernels with no launch matched {unmatched / 1e6:.4f} s", file=sys.stderr)
