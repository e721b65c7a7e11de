"""The system under test: `fastvocoder_tpu_torch`, built from a configuration
file and the benchmark's weights.

The benchmark takes from the program only its entry points (the factory,
the batched synthesizer, the request batcher, the trainer, the on-device
corpus); the weights, the inputs and the yardstick are the benchmark's.
"""

from __future__ import annotations

import torch

from fastvocoder_tpu_torch.hparams import HP, DiscriminatorConfig, load_model_config
from fastvocoder_tpu_torch.models.factory import build_discriminator, build_generator
from fastvocoder_tpu_torch.train.trainer import (
    TrainState,
    make_discriminator_optimizer,
    make_generator_optimizer,
    make_trainer,
)


def model_config(cell):
    """The program's `ModelConfig`, read from the configuration file itself
    (JSON is YAML; the file holds the FastVocoder YAML's keys)."""
    return load_model_config(cell.config["model_name"], cell.config_path)


def disc_config(cell) -> DiscriminatorConfig:
    d = {k: tuple(v) if isinstance(v, list) else v for k, v in cell.config["discriminator"].items()}
    return DiscriminatorConfig(**d)


def _loaded(module: torch.nn.Module, params, device) -> torch.nn.Module:
    module.to_empty(device=device)
    module.load_state_dict({k: v.detach() for k, v in params.items()})
    return module


def serving_generator(cell, params, device) -> torch.nn.Module:
    """The fused (served) form of the generator, holding `params`."""
    with torch.device("meta"):
        gen = build_generator(model_config(cell))
    return _loaded(gen, params, device).eval().requires_grad_(False)


def trainer_and_state(cell, gen_params, disc_params, device):
    """The program's trainer and its `TrainState`, the training-form
    generator and the discriminator holding the given parameters."""
    cfg = model_config(cell)
    trainer = make_trainer(cfg, hp=HP, disc_cfg=disc_config(cell), device=device)
    with torch.device("meta"):
        gen = build_generator(cfg, weight_norm=True)
        disc = build_discriminator(trainer.disc_cfg)
    gen = _loaded(gen, gen_params, device).train()
    disc = _loaded(disc, disc_params, device).train()
    state = TrainState(step=0, generator=gen, discriminator=disc,
                       gen_opt=make_generator_optimizer(gen, trainer.hp),
                       disc_opt=make_discriminator_optimizer(disc, trainer.hp))
    return trainer, state
