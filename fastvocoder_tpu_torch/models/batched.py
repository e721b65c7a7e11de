"""Batched bucketed synthesis (counterpart of
`fastvocoder_tpu/models/batched.py`).

Utterances are grouped by length rounded up to `bucket_frames`, zero-padded
to the bucket, run as one batch per group and trimmed to `T * hop`.

With a mesh (`parallel.make_mesh`: a list of devices, one may repeat) the
synthesizer holds one replica of the forward a device, each with its own
weights and kept kernel tables built on its own device, and splits each
group's rows over them, as the JAX package's mesh shards a batch along its
first axis: the rows are padded to a multiple of the mesh's size by
repeating the last row, every replica's chunk is launched before any is
copied back, and the waveforms come back in input order.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from fastvocoder_tpu_torch.parallel.mesh import shard_batch

Forward = Callable[[torch.Tensor], torch.Tensor]


def bucket_length(T: int, bucket_frames: int) -> int:
    return ((T + bucket_frames - 1) // bucket_frames) * bucket_frames


class BatchedSynthesizer:
    """forward(mel (B, T, C) tensor on `device`) -> wav (B, >= T *
    samples_per_frame) tensor.  With `mesh`, `forward` is a sequence of
    such callables, one a device of the mesh, each computing on its own
    device (`device` is then unused)."""

    def __init__(
        self,
        forward: Union[Forward, Sequence[Forward]],
        samples_per_frame: int,
        device: Optional[torch.device] = None,
        bucket_frames: int = 64,
        max_batch: int = 32,
        batch_pad: str = "exact",
        mesh: Optional[Sequence[torch.device]] = None,
    ):
        """batch_pad: "exact" runs each group at its own size; "pow2" pads
        each group to the next power of two (<= max_batch) by repeating its
        last row and trims the outputs, so live traffic meets a bounded set
        of batch shapes."""
        if batch_pad not in ("exact", "pow2"):
            raise ValueError(f"batch_pad: want 'exact' or 'pow2', got {batch_pad!r}")
        if mesh is None:
            self.mesh = [torch.device(device)]
            self.forwards = [forward]
        else:
            self.mesh = [torch.device(d) for d in mesh]
            self.forwards = list(forward)
            if len(self.forwards) != len(self.mesh):
                raise ValueError(f"a mesh of {len(self.mesh)} devices takes as many forwards, "
                                 f"got {len(self.forwards)}")
        self.device = self.mesh[0]
        self.n_dev = len(self.mesh)
        self.spf = samples_per_frame
        self.bucket_frames = bucket_frames
        self.max_batch = max_batch
        self.batch_pad = batch_pad

    def _group_size(self, n: int) -> int:
        if self.batch_pad == "pow2":
            p = 1
            while p < n:
                p *= 2
            n = min(p, self.max_batch)
        return n + (-n) % self.n_dev  # rows split evenly over the mesh

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

    def _run(self, batch: np.ndarray) -> np.ndarray:
        """The forwards over a padded batch, its rows split over the mesh."""
        with torch.inference_mode():
            if self.n_dev == 1:
                return self.forwards[0](torch.from_numpy(batch).to(self.device)).cpu().numpy()
            chunks = shard_batch({"mel": batch}, self.mesh, dp=None)
            outs = [fwd(c["mel"]) for fwd, c in zip(self.forwards, chunks)]  # all launched
            return np.concatenate([o.cpu().numpy() for o in outs])

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
                wavs = self._run(batch)
                for row, i in enumerate(group):
                    out[i] = wavs[row, : mels[i].shape[0] * self.spf]
        return out
