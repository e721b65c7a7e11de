"""Multi-resolution STFT discriminator ("from universal MelGAN"), channels
last.

Counterpart of `fastvocoder_tpu/models/discriminator/mfd.py` (reference
model/discriminator/mfd.py:44-183): one STFT discriminator per resolution.
Each computes an in-graph magnitude STFT of the waveform (clamped at 1e-7),
then runs the conv stack over (B, frames, bins) with the bins as channels:
a conv of K = 15, grouped stride-4 downsample convs of K = 6 ds + 1, two
head convs; every layer's output is returned.  With `compute_dtype` the
STFT stays float32 and every conv casts to it, as the JAX package's.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from fastvocoder_tpu_torch.dsp.stft import stft_mag
from fastvocoder_tpu_torch.models.discriminator.msd import ConvStackDiscriminator


class STFTDiscriminator(ConvStackDiscriminator):
    def __init__(self, fft_size: int = 1024, shift_size: int = 120, win_length: int = 600,
                 channels: int = 64, max_downsample_channels: int = 1024,
                 downsample_scales: Sequence[int] = (4, 4), compute_dtype=None):
        super().__init__(fft_size // 2 + 1, channels, max_downsample_channels,
                         downsample_scales, down_taps=6, compute_dtype=compute_dtype)
        self.fft_size, self.shift_size, self.win_length = fft_size, shift_size, win_length

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """x (B, T) waveform -> the per-layer features."""
        return super().forward(stft_mag(x, self.fft_size, self.shift_size, self.win_length))


class MultiResolutionSTFTDiscriminator(nn.Module):
    def __init__(self, fft_sizes: Sequence[int] = (2048, 1024, 512),
                 hop_sizes: Sequence[int] = (240, 120, 50),
                 win_lengths: Sequence[int] = (1200, 600, 240), channels: int = 64,
                 max_downsample_channels: int = 1024, downsample_scales: Sequence[int] = (4, 4),
                 compute_dtype=None):
        super().__init__()
        self.discs = []
        for i, (fs, ss, wl) in enumerate(zip(fft_sizes, hop_sizes, win_lengths)):
            disc = STFTDiscriminator(fs, ss, wl, channels, max_downsample_channels,
                                     downsample_scales, compute_dtype)
            self.add_module(f"disc_{i}", disc)
            self.discs.append(disc)

    def forward(self, x: torch.Tensor) -> Tuple[Tuple[torch.Tensor, ...], ...]:
        """x (B, T, 1) or (B, T) -> per resolution the tuple of features."""
        if x.dim() == 3:
            x = x[..., 0]
        return tuple(disc(x) for disc in self.discs)
