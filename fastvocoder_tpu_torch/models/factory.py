"""Model factory (counterpart of `fastvocoder_tpu/models/factory.py`).

Builds all five generator families.  Every generator has
`inference(mel (B, T, C)) -> waveform (B, N)`, the method the JAX package
serves its family with: Basis-MelGAN's `inference` (raw, untrimmed decode),
the plain call of HiFiGAN, MelGAN and NHV (whose conditioning is the mel
and an f0 channel, C = 81), and MultiBand-HiFiGAN's `synthesize` (PQMF
synthesis of the trunk's bands).
"""

from __future__ import annotations

import torch
from torch import nn

from fastvocoder_tpu_torch.checkpoint import (
    TRAIN_FORMAT,
    checkpoint_format,
    jax_tree_from_state_dict,
    load_release_npz,
    state_dict_from_jax,
)
from fastvocoder_tpu_torch.hparams import DISC, DiscriminatorConfig, ModelConfig
from fastvocoder_tpu_torch.models.basis_melgan import BasisMelGANGenerator
from fastvocoder_tpu_torch.models.discriminator.composite import Discriminator
from fastvocoder_tpu_torch.models.hifigan import HiFiGANGenerator
from fastvocoder_tpu_torch.models.melgan import MelGANGenerator
from fastvocoder_tpu_torch.models.multiband_hifigan import MultiBandHiFiGANGenerator
from fastvocoder_tpu_torch.models.nhv import NHVGenerator
from fastvocoder_tpu_torch.ops.precision import check_compute_dtype


def build_generator(cfg: ModelConfig, weight_norm: bool = False,
                    basis_signal_weight=None, compute_dtype=None) -> nn.Module:
    """The generator for `cfg.model_name`: the fused (weight-norm-removed)
    form that serves, or with `weight_norm=True` the form that trains.
    `basis_signal_weight` (L, 256) fills Basis-MelGAN's frozen basis.
    `compute_dtype` (None, or torch.bfloat16 for bf16 inference): the type
    it computes in, as the JAX package's `compute_dtype`; parameters stay
    float32 and the waveform is float32."""
    compute_dtype = check_compute_dtype(compute_dtype)
    kw = dict(weight_norm=weight_norm, compute_dtype=compute_dtype)
    if cfg.model_name == "basis-melgan":
        return BasisMelGANGenerator(cfg.arch, basis_signal_weight=basis_signal_weight, **kw)
    if cfg.model_name == "hifigan":
        return HiFiGANGenerator(cfg.arch, **kw)
    if cfg.model_name == "multiband-hifigan":
        return MultiBandHiFiGANGenerator(cfg.arch, **kw)
    if cfg.model_name == "melgan":
        return MelGANGenerator(cfg.arch, **kw)
    if cfg.model_name == "nhv":
        return NHVGenerator(cfg.arch, **kw)
    raise ValueError(f"no model {cfg.model_name!r}")


def build_discriminator(disc_cfg: DiscriminatorConfig = DISC, use_mpd: bool = False,
                        compute_dtype=None) -> Discriminator:
    """The composite discriminator (MSD + MFD, and the MPD with `use_mpd` or
    `disc_cfg.use_mpd`) at `disc_cfg`'s sizes, its convs computing in
    `compute_dtype` (None, or torch.bfloat16 for bf16 training)."""
    return Discriminator(disc_cfg, use_mpd=use_mpd,
                         compute_dtype=check_compute_dtype(compute_dtype))


def load_generator(checkpoint_path: str, cfg: ModelConfig, device: torch.device,
                   compute_dtype=None):
    """A checkpoint -> (generator on `device` in eval mode without
    gradients, computing in `compute_dtype` (`build_generator`), pattern or
    None).  Takes a release checkpoint
    (`checkpoint.load_release_npz`) or a checkpoint of the port's trainer
    (`train/checkpoint.py`, format `TRAIN_FORMAT`), of which only the
    generator is read: its training form, with weight norm fused into the
    serving form in float32 as a release's JAX tree is fused.  A trained
    checkpoint has no pattern.  Any other file raises ValueError."""
    if checkpoint_format(checkpoint_path) == "release":
        ckpt = load_release_npz(checkpoint_path)
        _check_model(checkpoint_path, ckpt["model_name"], cfg)
        state, pattern = ckpt["state_dict"], ckpt["pattern"]
    else:
        payload = torch.load(checkpoint_path, map_location="cpu", weights_only=True)
        if not isinstance(payload, dict) or payload.get("format") != TRAIN_FORMAT:
            raise ValueError(f"{checkpoint_path} is a torch file but not a checkpoint of this "
                             f"package's trainer (format {TRAIN_FORMAT!r})")
        _check_model(checkpoint_path, payload["model_name"], cfg)
        trained = build_generator(cfg, weight_norm=True)
        trained.load_state_dict(payload["generator"])
        state, pattern = state_dict_from_jax(jax_tree_from_state_dict(trained.state_dict())), None
    gen = build_generator(cfg, compute_dtype=compute_dtype)
    gen.load_state_dict(state)
    gen.to(device).eval().requires_grad_(False)
    return gen, pattern


def _check_model(path: str, model_name: str, cfg: ModelConfig) -> None:
    if model_name != cfg.model_name:
        raise ValueError(f"{path} holds a {model_name!r} model, not {cfg.model_name!r}")
