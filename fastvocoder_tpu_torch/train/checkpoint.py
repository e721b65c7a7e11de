"""Save and load the port's training state, and find a run's newest
checkpoint.

A checkpoint is one `torch.save` file, `checkpoint_<step>.pth.tar` as the
JAX package names its own: the generator's and discriminator's `state_dict`
in the training form (weight-norm gains beside the directions), both Adam
states, the step and each optimiser's update count.
`models/factory.py::load_generator` reads its generator for synthesis and
serving.  The reference's own checkpoint layout
(`fastvocoder_tpu/train/checkpoint.py`'s key maps) is not read or written
here yet.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from fastvocoder_tpu_torch.checkpoint import TRAIN_FORMAT as FORMAT
from fastvocoder_tpu_torch.train.trainer import TrainState


def latest_checkpoint(run_dir: str) -> Optional[str]:
    """The checkpoint_<step>.pth.tar of the highest step under `run_dir`,
    searched recursively (a run directory or its checkpoint/ root)."""
    best, best_step = None, -1
    for root, _, files in os.walk(run_dir):
        for f in files:
            if f.startswith("checkpoint_") and f.endswith(".pth.tar"):
                try:
                    step = int(f[len("checkpoint_"):-len(".pth.tar")])
                except ValueError:
                    continue
                if step > best_step:
                    best, best_step = os.path.join(root, f), step
    return best


def save_checkpoint(path: str, state: TrainState, model_name: str) -> None:
    """Write `state` to `path` (through a temporary file, so a reader never
    sees half a checkpoint)."""
    payload = {
        "format": FORMAT,
        "model_name": model_name,
        "step": state.step,
        "gen_updates": state.gen_updates,
        "disc_updates": state.disc_updates,
        "generator": state.generator.state_dict(),
        "discriminator": state.discriminator.state_dict(),
        "optimizer": state.gen_opt.state_dict(),
        "discriminator_optimizer": state.disc_opt.state_dict(),
    }
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, state: TrainState, model_name: str) -> TrainState:
    """Load `path` into `state`'s modules and optimisers, in place."""
    device = next(state.generator.parameters()).device
    payload = torch.load(path, map_location=device, weights_only=True)
    if payload.get("format") != FORMAT:
        raise ValueError(f"{path} is not a checkpoint of this package's trainer")
    if payload["model_name"] != model_name:
        raise ValueError(f"{path} holds a {payload['model_name']!r} run, not {model_name!r}")
    state.generator.load_state_dict(payload["generator"])
    state.discriminator.load_state_dict(payload["discriminator"])
    state.gen_opt.load_state_dict(payload["optimizer"])
    state.disc_opt.load_state_dict(payload["discriminator_optimizer"])
    state.step = int(payload["step"])
    state.gen_updates = int(payload["gen_updates"])
    state.disc_updates = int(payload["disc_updates"])
    return state
