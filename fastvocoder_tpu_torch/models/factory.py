"""Model factory (counterpart of `fastvocoder_tpu/models/factory.py`)."""

from __future__ import annotations

import torch

from fastvocoder_tpu_torch.checkpoint import load_release_npz
from fastvocoder_tpu_torch.hparams import ModelConfig
from fastvocoder_tpu_torch.models.basis_melgan import BasisMelGANGenerator


def build_generator(cfg: ModelConfig) -> BasisMelGANGenerator:
    """The fused (weight-norm-removed) generator for `cfg.model_name`.
    Only Basis-MelGAN is ported so far."""
    if cfg.model_name == "basis-melgan":
        return BasisMelGANGenerator(cfg.arch)
    raise NotImplementedError(
        f"{cfg.model_name!r} is not ported yet: HiFiGAN and MultiBand-HiFiGAN "
        "come with ROADMAP queue A slice 2, MelGAN and NHV with slice 3"
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
