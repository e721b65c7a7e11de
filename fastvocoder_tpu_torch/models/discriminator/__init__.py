"""Discriminators: MelGAN multi-scale (MSD), multi-resolution STFT (MFD) and
their composite."""

from fastvocoder_tpu_torch.models.discriminator.composite import Discriminator
from fastvocoder_tpu_torch.models.discriminator.mfd import MultiResolutionSTFTDiscriminator
from fastvocoder_tpu_torch.models.discriminator.msd import MelGANMultiScaleDiscriminator

__all__ = ["Discriminator", "MelGANMultiScaleDiscriminator", "MultiResolutionSTFTDiscriminator"]
