"""Training data pipeline: the reference's artifact layout, static shapes.

The port's copy of `fastvocoder_tpu/data/dataset.py` (numpy only), with the
reference's dataset semantics (reference data/dataset.py):

  * `load_data_to_buffer` reads every (wav.npy, mel.npy) pair named by two
    index files into RAM, and can pickle the buffer for instant reload
    (dataset.py:19-52, `test_size` truncation dataset.py:34-35);
  * random fixed-length crops: `fixed_length` mel frames and the aligned
    `hop_size * fixed_length` wav samples (dataset.py:66-73); Basis-MelGAN
    items also carry weight targets cropped at `hop_size / (L/2)` steps per
    frame (dataset.py:99-100);
  * mega-batches of `batch_expand_size * batch_size` items, sorted by
    pre-crop mel length descending and split into `batch_expand_size`
    sub-batches (dataset.py:131-142);
  * with `with_f0` (NHV), each item's `<name>.f0.npy` beside its
    `<name>.mel.npy`, cropped with the mel and packed by `collate` as mel
    channel 80 (`dsp.f0.f0_to_condition`'s layout).

Every batch is padded to exactly `fixed_length` frames, so every step sees
one shape.  `to_device` moves a batch to the card through pinned memory
without blocking the host.
"""

from __future__ import annotations

import os
import pickle
import time
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from fastvocoder_tpu_torch.hparams import HP, Hparams

Item = Dict[str, np.ndarray]


def parse_path_file(path_file: str) -> List[str]:
    """One path per line (reference data/utils.py:9-14)."""
    with open(path_file, "r", encoding="utf-8") as f:
        return [line.rstrip("\n") for line in f if line.strip()]


def load_data_to_buffer(
    audio_index_path_file: str,
    mel_index_path_file: str,
    feature_savepath: Optional[str] = None,
    test_size: int = 0,
    log=print,
    with_f0: bool = False,
) -> List[Item]:
    """Every (mel (T, 80), wav) pair of the two index files, in order; with
    `with_f0` also its f0 (T,) from `<name>.f0.npy`.  With
    `feature_savepath` the buffer is pickled there and reloaded while the
    (truncated) mel index it records and its f0 still match."""
    audio_index = parse_path_file(audio_index_path_file)
    mel_index = parse_path_file(mel_index_path_file)
    if len(audio_index) != len(mel_index):
        raise ValueError(
            f"{audio_index_path_file} names {len(audio_index)} files, "
            f"{mel_index_path_file} names {len(mel_index)}"
        )
    n = len(audio_index)
    if test_size and test_size < n:
        n = test_size
    if feature_savepath and os.path.exists(feature_savepath):
        log(f"loading buffer from {feature_savepath}")
        with open(feature_savepath, "rb") as f:
            cached = pickle.load(f)
        if (isinstance(cached, dict) and cached.get("mel_index") == mel_index[:n]
                and cached.get("with_f0", False) == with_f0):
            return cached["items"]
        log("cached buffer was built from a different index or f0 choice; reloading")

    buffer: List[Item] = []
    start = time.perf_counter()
    min_length = None
    for i in range(n):
        mel = np.load(mel_index[i]).T.astype(np.float32)  # (T, 80)
        wav = np.load(audio_index[i]).astype(np.float32)
        min_length = mel.shape[0] if min_length is None else min(min_length, mel.shape[0])
        item = {"mel": mel, "wav": wav}
        if with_f0:
            f0 = np.load(mel_index[i].replace(".mel.npy", ".f0.npy")).astype(np.float32)
            item["f0"] = f0[: mel.shape[0]]
        buffer.append(item)
    log(f"loaded {n} items in {time.perf_counter() - start:.1f}s; min mel length {min_length}")

    if feature_savepath:
        tmp = feature_savepath + ".tmp"  # readers never see a partial pickle
        with open(tmp, "wb") as f:
            pickle.dump({"mel_index": mel_index[:n], "with_f0": with_f0, "items": buffer}, f)
        os.replace(tmp, feature_savepath)
    return buffer


@dataclass
class BufferDataset:
    """In-RAM (mel, wav) pairs with random fixed-length crops."""

    buffer: List[Item]
    hp: Hparams = HP

    def __len__(self) -> int:
        return len(self.buffer)

    def mel_length(self, idx: int) -> int:
        return self.buffer[idx]["mel"].shape[0]

    def __getitem__(self, idx):  # the whole item (validation)
        return self.buffer[idx]

    def crop(self, idx: int, rng: np.random.Generator) -> Item:
        return crop_item(self.buffer[idx], rng, self.hp)


@dataclass
class WeightDataset:
    """Basis-MelGAN dataset: lazy per-item load of (mel, wav, weight) with
    aligned crops (reference data/dataset.py:77-114).  `weight_dir` holds a
    `<wav-basename>.npy` weight target (C, Tw) per item."""

    audio_index: List[str]
    mel_index: List[str]
    L: int
    weight_dir: str
    hp: Hparams = HP

    @classmethod
    def from_index_files(cls, audio_index_file: str, mel_index_file: str, L: int,
                         weight_dir: str, hp: Hparams = HP,
                         test_size: int = 0) -> "WeightDataset":
        a = parse_path_file(audio_index_file)
        m = parse_path_file(mel_index_file)
        if len(a) != len(m):
            raise ValueError(f"{audio_index_file} and {mel_index_file} differ in length")
        if test_size and test_size < len(a):
            a, m = a[:test_size], m[:test_size]
        return cls(a, m, L, weight_dir, hp)

    def __len__(self) -> int:
        return len(self.audio_index)

    def mel_length(self, idx: int) -> int:
        return int(np.load(self.mel_index[idx], mmap_mode="r").shape[1])

    def load(self, idx: int) -> Item:
        mel = np.load(self.mel_index[idx]).T.astype(np.float32)
        wav = np.load(self.audio_index[idx]).astype(np.float32)
        weight_path = os.path.join(self.weight_dir, os.path.basename(self.audio_index[idx]))
        weight = np.load(weight_path).T.astype(np.float32)  # (Tw, C)
        return {"mel": mel, "wav": wav, "weight": weight}

    def __getitem__(self, idx):
        return self.load(idx)

    def crop(self, idx: int, rng: np.random.Generator) -> Item:
        return crop_item(self.load(idx), rng, self.hp, L=self.L)


def crop_item(data: Item, rng: np.random.Generator, hp: Hparams,
              L: Optional[int] = None) -> Item:
    """Random `fixed_length`-frame crop with aligned wav (and weight) spans
    (reference data/dataset.py:63-73, 96-107).  Items shorter than
    fixed_length are taken whole (the collate pads them)."""
    len_data = data["mel"].shape[0]
    fixed = hp.fixed_length
    start = int(rng.integers(0, len_data - fixed)) if len_data > fixed + 1 else 0
    end = start + fixed
    out: Item = {
        "mel": data["mel"][start:end],
        "wav": data["wav"][start * hp.hop_size: end * hp.hop_size],
    }
    if "f0" in data:
        out["f0"] = data["f0"][start:end]
    if "weight" in data:
        wstep = hp.hop_size // (L // 2)
        out["weight"] = data["weight"][start * wstep: end * wstep]
    return out


def _pad_to(x: np.ndarray, length: int) -> np.ndarray:
    if x.shape[0] >= length:
        return x[:length]
    return np.pad(x, [(0, length - x.shape[0])] + [(0, 0)] * (x.ndim - 1))


def collate(items: Sequence[Item], hp: Hparams, L: Optional[int] = None) -> Item:
    """Stack crops into a static-shape batch: mel (B, fixed, 80), or with f0
    (B, fixed, 81) with f0 as channel 80; wav (B, fixed * hop) [, weight
    (B, fixed * hop / (L/2), C)]."""
    fixed = hp.fixed_length
    batch: Item = {
        "mel": np.stack([_pad_to(d["mel"], fixed) for d in items]),
        "wav": np.stack([_pad_to(d["wav"], fixed * hp.hop_size) for d in items]),
    }
    if "f0" in items[0]:
        f0 = np.stack([_pad_to(d["f0"], fixed) for d in items])
        batch["mel"] = np.concatenate([batch["mel"], f0[..., None]], axis=-1)
    if "weight" in items[0]:
        wlen = fixed * (hp.hop_size // (L // 2))
        batch["weight"] = np.stack([_pad_to(d["weight"], wlen) for d in items])
    return batch


def batch_iterator(dataset, hp: Hparams = HP, seed: int = 0, epoch: int = 0,
                   L: Optional[int] = None, shard_index: int = 0, shard_count: int = 1,
                   batch_size: Optional[int] = None) -> Iterator[Item]:
    """One epoch of training batches (reference data/dataset.py:131-142 and
    bin/train.py:398-405): shuffle, take mega-batches of `batch_expand_size *
    batch_size`, sort each by mel length descending, emit `batch_expand_size`
    sub-batches.  Every draw comes from `default_rng((seed, epoch))`.  With
    `shard_count > 1` (data parallelism) shard `shard_index` takes its
    contiguous slice of the common shuffled epoch, as the JAX package's
    hosts do, and `batch_size` is then a shard's."""
    bs = batch_size if batch_size is not None else hp.batch_size
    mega = bs * hp.batch_expand_size
    rng = np.random.default_rng((seed, epoch))
    order = rng.permutation(len(dataset))
    per = len(order) // shard_count
    order = order[shard_index * per: (shard_index + 1) * per]
    for m in range(len(order) // mega):
        idxs = order[m * mega: (m + 1) * mega]
        lengths = np.array([dataset.mel_length(i) for i in idxs])
        idxs = idxs[np.argsort(-lengths)]
        for j in range(hp.batch_expand_size):
            sub = idxs[j * bs: (j + 1) * bs]
            yield collate([dataset.crop(int(i), rng) for i in sub], hp, L=L)


def num_batches_per_epoch(dataset_len: int, hp: Hparams, shard_count: int = 1,
                          batch_size: Optional[int] = None) -> int:
    """Batches of an epoch of `batch_iterator` (each shard's, with
    `shard_count`)."""
    bs = batch_size if batch_size is not None else hp.batch_size
    return ((dataset_len // shard_count) // (bs * hp.batch_expand_size)) * hp.batch_expand_size


def to_device(batch: Item, device: torch.device) -> Dict[str, torch.Tensor]:
    """The batch as tensors on `device`; to a CUDA device through pinned
    host memory, `non_blocking`, so the copy overlaps the step before."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out
