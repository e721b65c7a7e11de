"""Batched bucketed synthesis (counterpart of
`fastvocoder_tpu/models/batched.py`, without the mesh).

Utterances are grouped by length rounded up to `bucket_frames`, zero-padded
to the bucket, run as one batch per group and trimmed to `T * hop`.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import numpy as np
import torch


def bucket_length(T: int, bucket_frames: int) -> int:
    return ((T + bucket_frames - 1) // bucket_frames) * bucket_frames


class BatchedSynthesizer:
    """forward(mel (B, T, C) tensor on `device`) -> wav (B, >= T *
    samples_per_frame) tensor."""

    def __init__(
        self,
        forward: Callable[[torch.Tensor], torch.Tensor],
        samples_per_frame: int,
        device: torch.device,
        bucket_frames: int = 64,
        max_batch: int = 32,
        batch_pad: str = "exact",
    ):
        """batch_pad: "exact" runs each group at its own size; "pow2" pads
        each group to the next power of two (<= max_batch) by repeating its
        last row and trims the outputs, so live traffic meets a bounded set
        of batch shapes."""
        if batch_pad not in ("exact", "pow2"):
            raise ValueError(f"batch_pad: want 'exact' or 'pow2', got {batch_pad!r}")
        self.forward = forward
        self.spf = samples_per_frame
        self.device = torch.device(device)
        self.bucket_frames = bucket_frames
        self.max_batch = max_batch
        self.batch_pad = batch_pad

    def _group_size(self, n: int) -> int:
        if self.batch_pad == "pow2":
            p = 1
            while p < n:
                p *= 2
            return min(p, self.max_batch)
        return n

    def warmup(self, bucket_lengths: Sequence[int], feature_dim: int = 80) -> int:
        """Run every (bucket, group size) shape `__call__` can dispatch for
        the given lengths once, so that kernel builds and library autotuning
        happen before the first request; -> number of shapes run."""
        seen, raw_counts = set(), []
        for k in range(1, self.max_batch + 1):
            rows = self._group_size(k)
            if rows not in seen:
                seen.add(rows)
                raw_counts.append(k)
        n = 0
        for T in bucket_lengths:
            Tb = bucket_length(T, self.bucket_frames)
            for k in raw_counts:
                self([np.zeros((Tb, feature_dim), np.float32)] * k)
                n += 1
        return n

    def __call__(self, mels: Sequence[np.ndarray]) -> List[np.ndarray]:
        """mels: list of (T_i, C) -> list of (T_i * samples_per_frame,)
        float32 wavs, in input order."""
        order: Dict[int, List[int]] = {}
        for i, m in enumerate(mels):
            order.setdefault(bucket_length(m.shape[0], self.bucket_frames), []).append(i)

        out: List[np.ndarray] = [None] * len(mels)  # type: ignore[list-item]
        for Tb, idxs in sorted(order.items()):
            for start in range(0, len(idxs), self.max_batch):
                group = idxs[start : start + self.max_batch]
                batch = np.stack(
                    [np.pad(mels[i], ((0, Tb - mels[i].shape[0]), (0, 0))) for i in group]
                ).astype(np.float32)
                want_rows = self._group_size(batch.shape[0])
                if want_rows > batch.shape[0]:
                    batch = np.concatenate(
                        [batch, np.repeat(batch[-1:], want_rows - batch.shape[0], axis=0)]
                    )
                with torch.inference_mode():
                    wavs = self.forward(torch.from_numpy(batch).to(self.device)).cpu().numpy()
                for row, i in enumerate(group):
                    out[i] = wavs[row, : mels[i].shape[0] * self.spf]
        return out
