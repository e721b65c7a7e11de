"""The whole training corpus on the card, crops cut there.

The port's counterpart of `fastvocoder_tpu/data/device_cache.py`.  The
host path cuts random crops on the CPU and copies every batch to the card;
a Basis-MelGAN batch at the reference's geometry carries about 73 MB of
weight targets (32 x 2240 x 256 float32) a step.  A vocoder corpus is small
against the card's memory, so `DeviceCorpus` stages it there once and cuts
the crops on the card: each step the host sends the utterance indices and
crop starts (two int64 vectors of the batch's size) and the batch is a row
lookup.

Layout: every modality is frame-major, (N * F, row) with F the longest
utterance's frames (at least `fixed_length`), zero-padded: mel (with NHV's f0 as channel 80, as
`data.dataset.collate` packs it), wav (`hop_size` samples a frame row) and
Basis-MelGAN's weight target in bf16 (`hop_size / (L / 2)` weight steps a
frame row), as the JAX package stores it.  A crop is `fixed_length`
consecutive rows, so `gather` is `index_select` on axis 0 (plain tensor
indexing, as JAX's `jnp.take`).

Crop semantics are `data.dataset.crop_item`'s and `collate`'s: the start is
uniform over [0, len - fixed) when len > fixed + 1, else 0, and a short
utterance reads zero padding.  `batches` makes the JAX package's numpy
draws in its order: per epoch `default_rng((seed, epoch))` permutes the
items, the drop-last mega-batch arithmetic of `batch_iterator` sets the
epoch's length, and each batch draws its starts from the same generator
(no sort by length: with fixed-length crops it only reorders an epoch).
So both packages cut the same batches from the same corpus, and with
`shard_index` / `shard_count` (data parallelism: each rank holds its own
copy of the corpus on its own card) each rank takes its contiguous slice
of the common shuffled epoch, as the JAX package does.  Unlike the
JAX package, which replays from the first epoch, a resumed run
(`start_step`) skips the batches the run before it consumed.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch

from fastvocoder_tpu_torch import resolve_device
from fastvocoder_tpu_torch.hparams import HP, Hparams


class DeviceCorpus:
    """A `BufferDataset`'s or `WeightDataset`'s items staged on `device`
    (the card unless "cpu" is asked for), batches cut there.  Running out of
    device memory raises; nothing falls back to the host path."""

    def __init__(self, dataset, hp: Hparams = HP, L: Optional[int] = None, device="cuda",
                 log=print):
        self.device = resolve_device(device)
        self.hp = hp
        self.L = L
        items = [dataset[i] for i in range(len(dataset))]
        n = len(items)
        frames = np.array([it["mel"].shape[0] for it in items], np.int32)
        # at least a crop's rows, so that a crop of the longest utterance
        # reads its own zero padding (the JAX package's F is the longest's)
        F = max(int(frames.max()), hp.fixed_length)
        hop = hp.hop_size

        def stack(rows_of, length, row_shape, dtype=torch.float32) -> torch.Tensor:
            # (N, length, *row) on the host, zero-padded, cast item by item
            out = torch.zeros((n, length) + tuple(row_shape), dtype=dtype)
            for i, it in enumerate(items):
                x = torch.from_numpy(np.ascontiguousarray(rows_of(it)[:length], np.float32))
                out[i, : x.shape[0]] = x
            return out

        mel = stack(lambda it: it["mel"], F, (items[0]["mel"].shape[1],))
        if "f0" in items[0]:
            f0 = stack(lambda it: it["f0"], F, ())
            mel = torch.cat([mel, f0[..., None]], dim=-1)
        host = {"mel": mel.reshape(n * F, -1),
                "wav": stack(lambda it: it["wav"], F * hop, ()).reshape(n * F, hop)}
        self.wstep = None
        if "weight" in items[0]:
            self.wstep = hop // (L // 2)
            C = items[0]["weight"].shape[1]
            host["weight"] = stack(lambda it: it["weight"], F * self.wstep, (C,),
                                   torch.bfloat16).reshape(n * F, self.wstep, C)
        self.F = F
        self.n_items = n
        self.frames = frames
        self.nbytes = sum(t.numel() * t.element_size() for t in host.values())
        self.arrays: Dict[str, torch.Tensor] = {k: v.to(self.device) for k, v in host.items()}
        self._rows = torch.arange(hp.fixed_length, device=self.device)
        log(f"device corpus: {n} utterances, {F} max frames, {self.nbytes / 1e6:.0f} MB "
            f"staged on {self.device}")

    # ---- on-device gather ----

    def gather(self, idx, starts, with_weight: bool = False) -> Dict[str, torch.Tensor]:
        """The batch of crops `starts[b]` of utterances `idx[b]`: mel (B,
        fixed, C), wav (B, fixed * hop) and, with `with_weight` on a weight
        corpus, weight (B, fixed * wstep, C) in bf16.  The host sends the two
        index vectors (pinned, without a sync); the rest is on the device."""
        pair = torch.from_numpy(np.stack([np.asarray(idx, np.int64),
                                          np.asarray(starts, np.int64)]))
        if self.device.type == "cuda":
            pair = pair.pin_memory().to(self.device, non_blocking=True)
        fixed = self.hp.fixed_length
        B = pair.shape[1]
        rows = ((pair[0] * self.F + pair[1])[:, None] + self._rows[None, :]).reshape(-1)
        out = {"mel": self.arrays["mel"].index_select(0, rows).reshape(B, fixed, -1),
               "wav": self.arrays["wav"].index_select(0, rows).reshape(B, -1)}
        if with_weight and self.wstep is not None:
            w = self.arrays["weight"]
            out["weight"] = w.index_select(0, rows).reshape(B, fixed * self.wstep, w.shape[-1])
        return out

    # ---- the training stream ----

    def sample_crops(self, rng: np.random.Generator, idx: np.ndarray) -> np.ndarray:
        """`crop_item`'s start distribution: uniform over [0, len - fixed)
        when len > fixed + 1, else 0."""
        lens = self.frames[idx]
        fixed = self.hp.fixed_length
        starts = rng.integers(0, np.maximum(lens - fixed, 1))
        return np.where(lens > fixed + 1, starts, 0).astype(np.int32)

    def steps_per_epoch(self, batch_size: Optional[int] = None, shard_count: int = 1) -> int:
        bs = batch_size if batch_size is not None else self.hp.batch_size
        mega = bs * self.hp.batch_expand_size
        return (self.n_items // shard_count // mega) * mega // bs

    def batches(self, seed: int = 0, batch_size: Optional[int] = None, shard_index: int = 0,
                shard_count: int = 1, start_step: int = 0,
                weight_until: int = 0) -> Iterator[Dict[str, torch.Tensor]]:
        """The run's batch stream, epoch after epoch (`hp.epochs`), from
        batch `start_step + 1` on; with `shard_count > 1`, shard
        `shard_index`'s batches of `batch_size` rows.  The weight target is
        gathered for the batches of steps up to `weight_until` only (the
        weight L1 of the pre-adversarial phase, reference
        bin/train.py:87-89)."""
        hp = self.hp
        bs = batch_size if batch_size is not None else hp.batch_size
        per_epoch = self.steps_per_epoch(bs, shard_count)
        per = self.n_items // shard_count
        if per_epoch == 0:
            return
        first_epoch, skip = divmod(start_step, per_epoch)
        step = first_epoch * per_epoch
        for epoch in range(first_epoch, hp.epochs):
            rng = np.random.default_rng((seed, epoch))
            order = rng.permutation(self.n_items)[shard_index * per:][: per_epoch * bs]
            for b in range(per_epoch):
                idx = order[b * bs: (b + 1) * bs]
                starts = self.sample_crops(rng, idx)  # drawn for a skipped batch too
                step += 1
                if epoch == first_epoch and b < skip:
                    continue
                yield self.gather(idx, starts,
                                  with_weight=self.wstep is not None and step <= weight_until)
