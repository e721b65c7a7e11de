"""Step timing and tracing.

The port's copy of `fastvocoder_tpu/runtime/profiler.py`.  `StepTimer` is
the reference's rolling step-time window with its ETA (reference
bin/train.py:59, 199-254, hparams.py:40); `trace` captures a
`torch.profiler` trace of a block (host and, on a card, device activity)
into a Chrome trace file; `annotate` names a span inside it.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import List, Optional

import torch


@dataclass
class StepTimer:
    """Rolling step-time window with ETA (the reference's `time_list`:
    compacted to its mean every `clear_time` entries, bin/train.py:250-254)."""

    clear_time: int = 20
    window: List[float] = field(default_factory=list)
    _t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        assert self._t0 is not None, "start() not called"
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self.window.append(dt)
        if len(self.window) > self.clear_time:
            # keep the mean as one entry (the reference's compaction)
            self.window = [sum(self.window) / len(self.window)]
        return dt

    @property
    def mean(self) -> float:
        return sum(self.window) / len(self.window) if self.window else 0.0

    def eta_seconds(self, current_step: int, total_step: int) -> float:
        return max(0, total_step - current_step) * self.mean


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block with `torch.profiler` (CPU, and CUDA where
    a card is present) and write `<logdir>/trace.json`, a Chrome trace
    (open it in Perfetto or chrome://tracing).  Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """A named span inside a trace (`torch.profiler.record_function`)."""
    return torch.profiler.record_function(name)
