"""Checkpoint -> batched serving callable (counterpart of
`fastvocoder_tpu/serving/model.py`), for every generator family.

Loads a release checkpoint into the fused generator, batches requests by
length bucket (`models/batched.py`) through the generator's `inference`,
the method the JAX package serves the family with (Basis-MelGAN's
`inference`, HiFiGAN's plain call, MultiBand-HiFiGAN's `synthesize`;
`models/factory.py`), and subtracts a published `pattern` (Basis-MelGAN's
zero-mel response) from each utterance after the `T * hop` trim, as the
reference's test harness does (reference bin/test.py:85-88).  The other
families' checkpoints carry no pattern and are served as they come.  NHV
takes its conditioning (T, 81), the mel and f0 (`dsp.f0.f0_to_condition`).
`compute_dtype=torch.bfloat16` serves in bf16 (`models/factory.py`), as the
JAX package's `compute_dtype` (`bin/serve.py --bf16`).  `mesh` (a list of
devices, `parallel.make_mesh`) serves data-parallel: the checkpoint is
loaded once a device of the mesh, and each batch's rows are split over
the replicas (`models/batched.py`).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from fastvocoder_tpu_torch import resolve_device
from fastvocoder_tpu_torch.hparams import HP, Hparams, load_model_config
from fastvocoder_tpu_torch.models.batched import BatchedSynthesizer
from fastvocoder_tpu_torch.models.factory import load_generator
from fastvocoder_tpu_torch.models.streaming import check_pattern_covers


class ServingModel:
    """list[mel (T_i, C)] -> list[wav (T_i * hop,)], C = `input_channels` —
    load once, serve many."""

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
        compute_dtype=None,
        mesh: Optional[Sequence[torch.device]] = None,
    ):
        """`device` is the one device served without a mesh; with `mesh`
        the replicas sit on its devices and `device` is unused."""
        devices = [resolve_device(d) for d in mesh] if mesh is not None else [
            resolve_device(device)]
        self.device = devices[0]
        self.mesh_size = len(devices)
        self.hp = hp
        self.model_name = model_name
        self.cfg = load_model_config(model_name, config_path)
        replicas = [load_generator(checkpoint_path, self.cfg, d, compute_dtype=compute_dtype)
                    for d in devices]
        self.generator, self.pattern = replicas[0]
        forwards = [g.inference for g, _ in replicas]
        self.batched = BatchedSynthesizer(
            forwards[0] if mesh is None else forwards,
            samples_per_frame=hp.hop_size,
            device=self.device,
            bucket_frames=bucket_frames,
            max_batch=max_batch,
            batch_pad=batch_pad,
            mesh=None if mesh is None else devices,
        )

    @property
    def input_channels(self) -> int:
        return self.hp.num_mels + 1 if self.model_name == "nhv" else self.hp.num_mels

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
