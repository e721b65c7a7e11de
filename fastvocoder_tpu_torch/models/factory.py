"""Model factory (counterpart of `fastvocoder_tpu/models/factory.py`).

Every generator the port builds has `inference(mel (B, T, 80)) -> waveform
(B, N)`, the method the JAX package serves its family with: Basis-MelGAN's
`inference` (raw, untrimmed decode), HiFiGAN's plain call, and
MultiBand-HiFiGAN's `synthesize` (PQMF synthesis of the trunk's bands).
"""

from __future__ import annotations

import torch
from torch import nn

from fastvocoder_tpu_torch.checkpoint import load_release_npz
from fastvocoder_tpu_torch.hparams import DISC, DiscriminatorConfig, ModelConfig
from fastvocoder_tpu_torch.models.basis_melgan import BasisMelGANGenerator
from fastvocoder_tpu_torch.models.discriminator.composite import Discriminator
from fastvocoder_tpu_torch.models.hifigan import HiFiGANGenerator
from fastvocoder_tpu_torch.models.multiband_hifigan import MultiBandHiFiGANGenerator


def build_generator(cfg: ModelConfig, weight_norm: bool = False,
                    basis_signal_weight=None) -> nn.Module:
    """The generator for `cfg.model_name`: the fused (weight-norm-removed)
    form that serves, or with `weight_norm=True` the form that trains.
    `basis_signal_weight` (L, 256) fills Basis-MelGAN's frozen basis."""
    if cfg.model_name == "basis-melgan":
        return BasisMelGANGenerator(cfg.arch, weight_norm=weight_norm,
                                    basis_signal_weight=basis_signal_weight)
    if cfg.model_name == "hifigan":
        return HiFiGANGenerator(cfg.arch, weight_norm=weight_norm)
    if cfg.model_name == "multiband-hifigan":
        return MultiBandHiFiGANGenerator(cfg.arch, weight_norm=weight_norm)
    raise NotImplementedError(
        f"{cfg.model_name!r} is not ported yet: MelGAN and NHV are in ROADMAP queue A"
    )


def build_discriminator(disc_cfg: DiscriminatorConfig = DISC) -> Discriminator:
    """The composite discriminator (MSD + MFD) at `disc_cfg`'s sizes."""
    return Discriminator(disc_cfg)


def load_generator(checkpoint_path: str, cfg: ModelConfig, device: torch.device):
    """Release checkpoint (`checkpoint.load_release_npz`) -> (generator on
    `device` in eval mode without gradients, pattern or None)."""
    ckpt = load_release_npz(checkpoint_path)
    if ckpt["model_name"] != cfg.model_name:
        raise ValueError(
            f"{checkpoint_path} holds a {ckpt['model_name']!r} model, "
            f"not {cfg.model_name!r}"
        )
    gen = build_generator(cfg)
    gen.load_state_dict(ckpt["state_dict"])
    gen.to(device).eval().requires_grad_(False)
    return gen, ckpt["pattern"]
