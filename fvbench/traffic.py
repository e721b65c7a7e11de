"""The one traffic generator: a mix file's parameters -> lengths, arrival
times and mels, from the seed.

Every seed gets the same multiset of lengths and of gaps between arrivals,
in another order: the lengths are the law's quantiles at (i + 0.5) / n,
the gaps an exponential's, permuted by the seed.  So two seeds ask for the
same work and differ in its order and in the mels, which keeps the spread
between runs to what the system does.

Mix keys read here:
  lengths   {"law": "lognormal", "median": frames, "sigma": s,
             "min": frames, "max": frames}  (clipped to [min, max])
  arrivals  {"process": "poisson", "rate": requests/s}
  mel       {"mean": m, "std": s}: frames N(m, s) clipped to [0, 1]
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
from scipy.stats import norm

POOL_FRAMES = 8192


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), stream])


def quantile_lengths(law: dict, n: int) -> np.ndarray:
    """The law's n quantiles, whole frames, in ascending order."""
    if law["law"] != "lognormal":
        raise ValueError(f"unknown length law {law['law']!r}")
    q = (np.arange(n) + 0.5) / n
    x = law["median"] * np.exp(law["sigma"] * norm.ppf(q))
    return np.clip(np.rint(x), law["min"], law["max"]).astype(np.int64)


def lengths(law: dict, n: int, seed: int, stream: int = 1) -> np.ndarray:
    return rng(seed, stream).permutation(quantile_lengths(law, n))


def arrivals(spec: dict, seconds: float, seed: int) -> np.ndarray:
    """Due times in [0, seconds) of an open loop, seconds from the start."""
    if spec["process"] != "poisson":
        raise ValueError(f"unknown arrival process {spec['process']!r}")
    n = max(1, int(round(float(spec["rate"]) * seconds)))
    exp = -np.log1p(-(np.arange(n) + 0.5) / n)  # the exponential's n quantiles
    gaps = rng(seed, 2).permutation(exp) * (seconds / exp.sum())
    due = np.cumsum(gaps) - gaps[0]
    return due[due < seconds]


class MelPool:
    """Mels as slices of one seeded pool of frames: a request of T frames
    reads T consecutive frames at a seeded offset."""

    def __init__(self, spec: dict, seed: int, channels: int = 80):
        g = rng(seed, 3)
        self.frames = np.clip(spec["mean"] + spec["std"] * g.standard_normal(
            (POOL_FRAMES, channels)), 0.0, 1.0).astype(np.float32)
        self._g = g

    def take(self, T: int) -> np.ndarray:
        start = int(self._g.integers(0, POOL_FRAMES - T + 1))
        return self.frames[start:start + T]

    def many(self, Ts) -> List[np.ndarray]:
        return [self.take(int(T)) for T in Ts]


def bucket(T: int, bucket_frames: int) -> int:
    """The service's own rule (`models/batched.py::bucket_length`), worked
    out again: T rounded up to a multiple of the bucket."""
    return -(-T // bucket_frames) * bucket_frames


def crops(seed: int, frames: np.ndarray, batch: int, fixed: int) -> "CropStream":
    return CropStream(rng(seed, 4), frames, batch, fixed)


class CropStream:
    """Training batches as (utterance indices, crop starts): each batch draws
    `batch` distinct utterances, each crop's start uniform over
    [0, len - fixed)."""

    def __init__(self, g: np.random.Generator, frames: np.ndarray, batch: int, fixed: int):
        self.g, self.frames, self.batch, self.fixed = g, frames, batch, fixed

    def next(self) -> Tuple[np.ndarray, np.ndarray]:
        idx = self.g.choice(len(self.frames), self.batch, replace=False)
        starts = self.g.integers(0, np.maximum(self.frames[idx] - self.fixed, 1))
        return idx.astype(np.int64), starts.astype(np.int64)
