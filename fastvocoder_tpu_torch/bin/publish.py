"""Publish entry point: a training checkpoint -> the deployable
`{model, pattern}` file (counterpart of `fastvocoder_tpu/bin/publish.py`,
reference bin/publish.py).

For Basis-MelGAN the pattern is the generator's zero-input response to a
30,000-frame (300 s) mel, computed on the device (reference
bin/publish.py:67-75); the other families are published with an empty
pattern, as in the JAX package.  The file is the JAX package's layout
(`train/checkpoint.py::save_published`), so either package loads it.
Runs on CUDA unless `--device cpu`.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from fastvocoder_tpu_torch import resolve_device
from fastvocoder_tpu_torch.checkpoint import jax_tree_from_state_dict, state_dict_from_jax
from fastvocoder_tpu_torch.hparams import load_model_config
from fastvocoder_tpu_torch.models.factory import build_generator
from fastvocoder_tpu_torch.train.checkpoint import generator_state, save_published

PATTERN_FRAMES = 30000  # "support up to synthesize 300s waveform" (reference publish.py:69)


def zero_mel_response(generator: torch.nn.Module, frames: int, channels: int,
                      device: torch.device) -> np.ndarray:
    """The generator's raw `inference` on a (1, frames, channels) zero mel."""
    with torch.inference_mode():
        wav = generator.inference(torch.zeros(1, frames, channels, device=device))
    return wav[0].float().cpu().numpy()


def publish_model(checkpoint_path: str, config_path: str, model_name: str, save_path: str,
                  pattern_frames: int = PATTERN_FRAMES, device="cuda") -> np.ndarray:
    """Write the published file; -> its pattern."""
    dev = resolve_device(device)
    cfg = load_model_config(model_name, config_path)
    state = generator_state(checkpoint_path, cfg)
    pattern = np.zeros((0,), np.float32)
    if model_name == "basis-melgan":
        gen = build_generator(cfg)  # the fused form, as it serves
        gen.load_state_dict(state_dict_from_jax(jax_tree_from_state_dict(state)))
        gen.to(dev).eval().requires_grad_(False)
        pattern = zero_mel_response(gen, pattern_frames, cfg.arch.in_channels, dev)
    save_published(save_path, cfg, state, pattern)
    print(f"published {model_name} -> {save_path}")
    return pattern


def run_publisher(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint_path", type=str, required=True)
    parser.add_argument("--model_name", type=str, required=True,
                        help="basis-melgan, hifigan, multiband-hifigan, melgan or nhv")
    parser.add_argument("--config", type=str, required=True,
                        help="path to model configuration file")
    parser.add_argument("--save_path", type=str, required=True,
                        help="path to save published model")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    return publish_model(args.checkpoint_path, args.config, args.model_name, args.save_path,
                         device=args.device)


if __name__ == "__main__":
    run_publisher()
