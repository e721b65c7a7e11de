"""Composite discriminator: MSD + MFD.

Counterpart of `fastvocoder_tpu/models/discriminator/composite.py`
(reference model/discriminator/discriminator.py:8-19): the per-scale outputs
of the sub-discriminators, concatenated; each element is a tuple of
per-layer features whose last entry is the score.  The optional
multi-period discriminator is not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from fastvocoder_tpu_torch.hparams import DISC, DiscriminatorConfig
from fastvocoder_tpu_torch.models.discriminator.mfd import MultiResolutionSTFTDiscriminator
from fastvocoder_tpu_torch.models.discriminator.msd import MelGANMultiScaleDiscriminator


class Discriminator(nn.Module):
    def __init__(self, cfg: DiscriminatorConfig = DISC):
        super().__init__()
        if cfg.use_mpd:
            raise NotImplementedError(
                "the multi-period discriminator is not ported yet (ROADMAP queue A)"
            )
        self.cfg = cfg
        self.msd = MelGANMultiScaleDiscriminator(
            scales=cfg.msd_scales, channels=cfg.msd_channels,
            max_downsample_channels=cfg.msd_max_channels,
            downsample_scales=cfg.msd_downsample_scales)
        self.mfd = MultiResolutionSTFTDiscriminator(
            fft_sizes=cfg.mfd_fft_sizes, hop_sizes=cfg.mfd_hop_sizes,
            win_lengths=cfg.mfd_win_lengths, channels=cfg.mfd_channels,
            max_downsample_channels=cfg.mfd_max_channels,
            downsample_scales=cfg.mfd_downsample_scales)

    def forward(self, x: torch.Tensor) -> Tuple[Tuple[torch.Tensor, ...], ...]:
        """x (B, T) waveform -> the tuple of per-scale feature tuples."""
        if x.dim() == 2:
            x = x[..., None]
        return self.msd(x) + self.mfd(x)
