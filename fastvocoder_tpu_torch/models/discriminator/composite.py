"""Composite discriminator: MSD + MFD, and with `use_mpd` the MPD.

Counterpart of `fastvocoder_tpu/models/discriminator/composite.py`
(reference model/discriminator/discriminator.py:8-19): the per-scale outputs
of the sub-discriminators, concatenated in that order; each element is a
tuple of per-layer features whose last entry is the score.  The
multi-period discriminator is off by default, as in the reference, and on
with `use_mpd` (the argument or `cfg.use_mpd`).  `compute_dtype` (None or
torch.bfloat16) reaches every conv of every sub-discriminator, as the JAX
package's.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from fastvocoder_tpu_torch.hparams import DISC, DiscriminatorConfig
from fastvocoder_tpu_torch.models.discriminator.mfd import MultiResolutionSTFTDiscriminator
from fastvocoder_tpu_torch.models.discriminator.mpd import MultiPeriodDiscriminator
from fastvocoder_tpu_torch.models.discriminator.msd import MelGANMultiScaleDiscriminator


class Discriminator(nn.Module):
    def __init__(self, cfg: DiscriminatorConfig = DISC, use_mpd: bool = False,
                 compute_dtype=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(compute_dtype=compute_dtype)
        self.msd = MelGANMultiScaleDiscriminator(
            scales=cfg.msd_scales, channels=cfg.msd_channels,
            max_downsample_channels=cfg.msd_max_channels,
            downsample_scales=cfg.msd_downsample_scales, **kw)
        self.mfd = MultiResolutionSTFTDiscriminator(
            fft_sizes=cfg.mfd_fft_sizes, hop_sizes=cfg.mfd_hop_sizes,
            win_lengths=cfg.mfd_win_lengths, channels=cfg.mfd_channels,
            max_downsample_channels=cfg.mfd_max_channels,
            downsample_scales=cfg.mfd_downsample_scales, **kw)
        self.mpd = None
        if use_mpd or cfg.use_mpd:
            self.mpd = MultiPeriodDiscriminator(periods=cfg.mpd_periods, channels=cfg.mpd_channels,
                                                **kw)

    def forward(self, x: torch.Tensor) -> Tuple[Tuple[torch.Tensor, ...], ...]:
        """x (B, T) waveform -> the tuple of per-scale feature tuples."""
        if x.dim() == 2:
            x = x[..., None]
        outs = self.msd(x) + self.mfd(x)
        if self.mpd is not None:
            outs = outs + self.mpd(x)
        return outs
