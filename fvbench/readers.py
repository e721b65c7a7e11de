"""What a per-layer metric's reader (`metrics/<name>.py`: `read(run)`) reads:
the window's counters, kept by the benchmark's wrappers around the
program's callables, the reduced device trace, and the reference's FLOP
counts.  A reader that finds nothing to read returns None, and the metric
is left out of the line."""

from __future__ import annotations

import functools
import hashlib
import json
import os
from typing import Optional

from fvbench import disc_reference_of, peaks, reference_of
from fvbench.reference import flops
from fvbench.reference.train import ReferenceTrainer
from fvbench.weights import meta_params

CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "build", "fvbench")


class Run:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cell = ctx.cell
        self.record = ctx.record
        self.summary = ctx.summary

    @property
    def peak_flop_per_s(self) -> float:
        return peaks.peak_flops(self.cell.config["dtype"])

    def _cached(self, what: str, compute):
        """A FLOP count of the cell's reference, kept in the checkout's build
        directory by the configuration's and mix's contents."""
        key = hashlib.sha256(json.dumps([what, self.cell.config, self.cell.mix],
                                        sort_keys=True).encode()).hexdigest()[:16]
        path = os.path.join(CACHE, f"flops_{self.cell.name}_{key}.json")
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError):
            value = compute()
            os.makedirs(CACHE, exist_ok=True)
            with open(path + ".tmp", "w") as f:
                json.dump(value, f)
            os.replace(path + ".tmp", path)
            return value

    def per_frame(self):
        """(a, b): the served forward of a row of T frames costs a T + b FLOPs."""
        return self._cached("per_frame", lambda: list(flops.per_frame(reference_of(self.cell),
                                                                      self.cell.config)))

    def forward_flops(self, rows: int, frames: int) -> float:
        a, b = self.per_frame()
        return rows * (a * frames + b)

    def step_flops(self) -> float:
        mix, cfg = self.cell.mix, self.cell.config
        return self._cached("step", lambda: flops.train_step_flops(
            ReferenceTrainer, reference_of(self.cell), disc_reference_of(self.cell), cfg,
            cfg["discriminator"], mix["step"], mix["batch"], mix["frames"], cfg["hop_size"],
            cfg["lamda_stft"], cfg["use_feature_map_loss"],
            cfg["out_channels"] if mix.get("weight_target") else 0))

    @functools.cached_property
    def n_weights(self) -> int:
        P = meta_params(reference_of(self.cell), self.cell.config, weight_norm=False)
        return sum(t.numel() for t in P.values())

    def forward_bytes(self, rows: int, frames: int) -> float:
        """A forward's bytes: the mels read and the waveform written once, in
        float32, and every weight read once."""
        return 4.0 * (rows * frames * (80 + self.cell.config["hop_size"]) + self.n_weights)

    # ---- shared by several readers ----

    @property
    def traced(self) -> Optional[dict]:
        """The traced slice: its end on the host clock, the driver's progress
        and the generator calls made by then."""
        return self.record.get("traced") if self.summary is not None else None

    @property
    def calls(self):
        """(start, end, rows, frames) of each generator call of the traced
        slice.  Counts are read there too: after it the trace is read on
        the host, inside the window, while a served cell's load goes on."""
        calls = self.record.get("forward_calls", [])
        return calls[:self.traced["calls"]] if self.traced else calls

    @property
    def synth_calls(self):
        """(start, request ids, its first and past-last generator call) of
        each synthesize call made whole in the traced slice."""
        last = self.traced["calls"] if self.traced else float("inf")
        return [c for c in self.record.get("synth_calls", []) if c[3] <= last]

    def idle_share(self) -> Optional[float]:
        if self.summary is None or self.summary.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.summary.busy_s / self.summary.window_s)

    def pad_share(self) -> Optional[float]:
        """Frames computed for padding over all frames computed: the
        generator calls against the frames of the work they served."""
        calls = self.record.get("forward_calls", [])
        if "Ts" in self.record:  # served: each synthesize call's requests and calls
            length = dict(zip(self.record["mel_ids"], self.record["Ts"]))
            useful = sum(int(length[i]) for _, ids, _, _ in self.synth_calls for i in ids)
            computed = sum(rows * frames for _, ids, a, b in self.synth_calls
                           for _, _, rows, frames in calls[a:b])
        else:  # offline: the slice ends with a chunk
            useful = (self.traced["progress"]["frames"] if self.traced
                      else self.record["useful_frames"])
            computed = sum(rows * frames for _, _, rows, frames in self.calls)
        return 100.0 * (computed - useful) / computed if computed else None

    def forward_roofline(self) -> Optional[float]:
        """The traced generator calls' bound over the device time of the
        kernels launched inside them."""
        if self.traced is None or self.summary.span_device_s <= 0:
            return None
        dtype = self.cell.config["dtype"]
        bound = sum(peaks.bound_s(self.forward_bytes(r, f), self.forward_flops(r, f), dtype)
                    for _, _, r, f in self.calls)
        return 100.0 * bound / self.summary.span_device_s

    def served_mfu(self) -> Optional[float]:
        """Model FLOPs of the audio completed in the traced slice, at its own
        lengths, over the slice at the peak."""
        if self.traced is None:
            return None
        a, b = self.per_frame()
        if "useful_frames" in self.record:  # offline: the chunks done by the slice's end
            frames, utterances = (self.traced["progress"]["frames"],
                                  self.traced["progress"]["utterances"])
        else:
            end = self.traced["end"]
            done = [int(T) for T, d, ok in zip(self.record["Ts"], self.record["done"],
                                               self.record["completed"]) if ok and d <= end]
            frames, utterances = sum(done), len(done)
        total = a * frames + b * utterances
        return 100.0 * total / (self.summary.window_s * self.peak_flop_per_s)

    def train_mfu(self) -> Optional[float]:
        if self.traced is None:
            return None
        total = self.step_flops() * self.traced["progress"]
        return 100.0 * total / (self.summary.window_s * self.peak_flop_per_s)
