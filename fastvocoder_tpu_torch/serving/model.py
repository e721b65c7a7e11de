"""Checkpoint -> batched serving callable (counterpart of
`fastvocoder_tpu/serving/model.py`, Basis-MelGAN only).

Loads a release checkpoint into the fused generator, batches requests by
length bucket (`models/batched.py`) and subtracts Basis-MelGAN's published
`pattern` (the zero-mel response) from each utterance after the `T * hop`
trim, as the reference's test harness does (reference bin/test.py:85-88).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from fastvocoder_tpu_torch import resolve_device
from fastvocoder_tpu_torch.hparams import HP, Hparams, load_model_config
from fastvocoder_tpu_torch.models.batched import BatchedSynthesizer
from fastvocoder_tpu_torch.models.factory import load_generator
from fastvocoder_tpu_torch.models.streaming import check_pattern_covers


class ServingModel:
    """list[mel (T_i, C)] -> list[wav (T_i * hop,)] — load once, serve many."""

    def __init__(
        self,
        checkpoint_path: str,
        config_path: str,
        model_name: str,
        hp: Hparams = HP,
        bucket_frames: int = 64,
        max_batch: int = 32,
        batch_pad: str = "pow2",
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        self.hp = hp
        self.model_name = model_name
        self.cfg = load_model_config(model_name, config_path)
        self.generator, self.pattern = load_generator(
            checkpoint_path, self.cfg, self.device
        )
        self.batched = BatchedSynthesizer(
            self.generator.inference,
            samples_per_frame=hp.hop_size,
            device=self.device,
            bucket_frames=bucket_frames,
            max_batch=max_batch,
            batch_pad=batch_pad,
        )

    @property
    def input_channels(self) -> int:
        return self.hp.num_mels

    def warmup(self, max_frames: int) -> int:
        """Run every (bucket, group-size) shape for utterances up to
        `max_frames` mel frames once; returns how many were run."""
        b = self.batched.bucket_frames
        lengths = list(range(b, max_frames + b, b))
        return self.batched.warmup(lengths, feature_dim=self.input_channels)

    def validate(self, mel: np.ndarray) -> None:
        """Raise ValueError if `mel` cannot be served.  The HTTP frontend
        calls this per request before coalescing, so one bad request gets
        its own 400 instead of failing every request in its batch."""
        if mel.ndim != 2 or mel.shape[1] != self.input_channels:
            raise ValueError(
                f"expected (T, {self.input_channels}) mel, got {list(mel.shape)}"
            )
        if mel.shape[0] < 1:
            raise ValueError("empty mel (T=0)")
        check_pattern_covers(self.pattern, mel.shape[0] * self.hp.hop_size)

    def __call__(self, mels: Sequence[np.ndarray]) -> List[np.ndarray]:
        wavs = self.batched(mels)
        if self.pattern is not None:
            for i, w in enumerate(wavs):
                n = w.shape[0]
                check_pattern_covers(self.pattern, n)
                wavs[i] = w - self.pattern[:n]
        return wavs
