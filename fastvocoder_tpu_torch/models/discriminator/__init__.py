"""Discriminators: MelGAN multi-scale (MSD), multi-resolution STFT (MFD),
HiFiGAN multi-period (MPD) and their composite."""

from fastvocoder_tpu_torch.models.discriminator.composite import Discriminator
from fastvocoder_tpu_torch.models.discriminator.mfd import MultiResolutionSTFTDiscriminator
from fastvocoder_tpu_torch.models.discriminator.mpd import MultiPeriodDiscriminator
from fastvocoder_tpu_torch.models.discriminator.msd import MelGANMultiScaleDiscriminator

__all__ = ["Discriminator", "MelGANMultiScaleDiscriminator", "MultiPeriodDiscriminator",
           "MultiResolutionSTFTDiscriminator"]
