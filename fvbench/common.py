"""What every driver shares: the run's context, the window, and the check
of served waveforms against the reference."""

from __future__ import annotations

import contextlib
import gc
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import numpy as np
import torch

from fvbench import disc_reference_of, reference_of, trace, traffic, weights


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def set_precision(dtype: str, tf32: bool) -> None:
    """The precision the configuration states, for the program and the
    reference alike: float32 with TF32 on or off for cuDNN and matmuls."""
    if dtype != "float32":
        raise ValueError(f"no cell of precision {dtype!r} yet")
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32


# A `--trace 1` run traces the window's first seconds only, so that reading
# the trace keeps the run well inside its time whatever the window's length.
TRACE_SECONDS = 10.0


@dataclass
class Context:
    cell: object
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float
    forward_override: Optional[Callable] = None  # the control: the reference in the program's place
    e2e: Dict[str, float] = field(default_factory=dict)
    checks: Dict[str, float] = field(default_factory=dict)
    record: dict = field(default_factory=dict)
    summary: Optional[trace.TraceSummary] = None
    memory_peak: int = 0
    attempted: int = 0
    failed: int = 0
    t0: Optional[float] = None  # the window's start on the host clock
    progress: object = 0  # the driver's count of work done in the window
    _prof: object = None

    @property
    def mix(self) -> dict:
        return self.cell.mix

    @property
    def hop(self) -> int:
        return self.cell.config["hop_size"]

    @property
    def family(self):
        """The generator's reference module."""
        return reference_of(self.cell)

    @property
    def disc_family(self):
        """The discriminator's reference module."""
        return disc_reference_of(self.cell)

    def stderr(self, msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    def phase(self, name: str) -> None:
        """Log a set-up phase's end, seconds from the process's start."""
        self.stderr(f"set-up: {name} at {time.perf_counter() - self.t_start:.3f} s")

    def serving_params(self):
        return weights.make_params(self.family, self.cell.config, self.seed, self.device,
                                   weight_norm=False)

    @contextlib.contextmanager
    def window(self):
        """Marks the measured window, and with `--trace 1` profiles its first
        `TRACE_SECONDS` (`tick`); the driver sets `t0` (host clock) when the
        window starts and keeps `progress`, its count of work done, up to
        date."""
        self.t0 = None
        # set-up ends on a collected heap: its garbage, and the interpreter's
        # full collection that it has made due, do not fall into the window
        gc.collect()
        sync(self.device)
        self._gc = []
        gc.callbacks.append(self._gc_event)
        if self.trace:
            self._prof = trace.start()
            self._span = trace.open_span(trace.WINDOW)
            self._anchor = time.perf_counter()
        yield
        sync(self.device)
        gc.callbacks.remove(self._gc_event)
        if self.trace:
            self.end_trace()
            # read once the window has closed: the work a served cell's load
            # thread keeps offering is not held up by it
            calls = self.record["forward_calls"][:self.record["traced"]["calls"]] \
                if "forward_calls" in self.record else []
            self.summary = trace.reduce(trace.export_events(self._stopped),
                                        [c[:2] for c in calls], self._anchor)
        self.e2e["setup_s"] = self.t0 - self.t_start

    def _gc_event(self, phase: str, info: dict) -> None:
        self._gc.append((time.perf_counter(), phase, info.get("generation")))

    def gc_pauses(self) -> str:
        """For the log: the interpreter's collections in the window."""
        spans = [(b[0] - a[0], a[2]) for a, b in zip(self._gc, self._gc[1:])
                 if a[1] == "start" and b[1] == "stop"]
        full = [d for d, g in spans if g == 2]
        return (f"{len(spans)} collections, {sum(d for d, _ in spans) * 1e3:.1f} ms, the "
                f"longest {max((d for d, _ in spans), default=0) * 1e3:.1f} ms, {len(full)} full")

    def tick(self) -> None:
        """Close the trace once `TRACE_SECONDS` of the window have passed."""
        if self._prof is not None and self.t0 is not None and \
                time.perf_counter() - self.t0 >= TRACE_SECONDS:
            sync(self.device)
            self.end_trace()

    def end_trace(self) -> None:
        if self._prof is None:
            return
        self._stopped, self._prof = self._prof, None
        trace.close_span(self._span)
        self._stopped.stop()
        self.record["traced"] = {"end": time.perf_counter(), "progress": self.progress,
                                 "calls": len(self.record.get("forward_calls", ()))}

    def window_done(self, attempted: int, failed: int) -> None:
        """Read what the window left: its counts and the memory peak, before
        anything of the check runs."""
        self.attempted, self.failed = attempted, failed
        if self.device.type == "cuda":
            self.memory_peak = int(torch.cuda.max_memory_allocated(self.device))

    def free(self) -> None:
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def relative_error(got: np.ndarray, want: np.ndarray) -> float:
    """The largest gap, as a share of the reference's peak."""
    if got.shape != want.shape:
        return float("inf")
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def served_error(ctx: Context, params, mels, Ts, sample, outputs) -> float:
    """The worst `relative_error` over the sampled requests' waveforms, each
    held against the reference's forward of its mel zero-padded to its
    bucket, trimmed to its frames; inf where a sampled request never came."""
    ref = reference_of(ctx.cell)
    arch = ctx.cell.config
    bf = ctx.mix["synthesizer"]["bucket_frames"]
    worst = 0.0
    with torch.no_grad():
        for i in sample:
            if i not in outputs:
                return float("inf")
            T = int(Ts[i])
            mel = np.zeros((traffic.bucket(T, bf), mels[i].shape[1]), np.float32)
            mel[:T] = mels[i]
            want = ref.inference(params, torch.from_numpy(mel)[None].to(ctx.device), arch)
            want = want[0, :T * ctx.hop].cpu().numpy()
            worst = max(worst, relative_error(np.asarray(outputs[i]), want))
    return worst
