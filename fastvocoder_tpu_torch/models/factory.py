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
from fastvocoder_tpu_torch.hparams import ModelConfig
from fastvocoder_tpu_torch.models.basis_melgan import BasisMelGANGenerator
from fastvocoder_tpu_torch.models.hifigan import HiFiGANGenerator
from fastvocoder_tpu_torch.models.multiband_hifigan import MultiBandHiFiGANGenerator


def build_generator(cfg: ModelConfig) -> nn.Module:
    """The fused (weight-norm-removed) generator for `cfg.model_name`."""
    if cfg.model_name == "basis-melgan":
        return BasisMelGANGenerator(cfg.arch)
    if cfg.model_name == "hifigan":
        return HiFiGANGenerator(cfg.arch)
    if cfg.model_name == "multiband-hifigan":
        return MultiBandHiFiGANGenerator(cfg.arch)
    raise NotImplementedError(
        f"{cfg.model_name!r} is not ported yet: MelGAN and NHV come with "
        "ROADMAP queue A slice 3"
    )


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
