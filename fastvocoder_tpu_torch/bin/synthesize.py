"""Synthesis entry point (counterpart of `fastvocoder_tpu/bin/synthesize.py`,
reference bin/synthesize.py:17-104), for Basis-MelGAN, HiFiGAN and
MultiBand-HiFiGAN.

`Synthesizer` loads a release checkpoint into the fused generator and
synthesizes with zero-mel bias removal (reference bin/synthesize.py:74-80),
through the generator's `inference` (the method the JAX package serves the
family with, `models/factory.py`).  With `bucket_frames > 0` the mel is
zero-padded up to a multiple of it and the waveform trimmed back to the
unpadded length: Basis-MelGAN's raw decode length, `T * hop` for the other
families, as the JAX package's entry point trims.  Samples within the
generator's receptive field of the pad boundary then differ from an
exact-length run by edge effects only.
"""

from __future__ import annotations

import argparse
from typing import Tuple

import numpy as np
import torch

from fastvocoder_tpu_torch import resolve_device
from fastvocoder_tpu_torch.dsp import audio
from fastvocoder_tpu_torch.hparams import HP, Hparams, load_model_config
from fastvocoder_tpu_torch.models.factory import load_generator


class Synthesizer:
    def __init__(
        self,
        checkpoint_path: str,
        config_path: str,
        model_name: str,
        hp: Hparams = HP,
        bucket_frames: int = 0,
        device: str | torch.device = "cuda",
    ) -> None:
        self.device = resolve_device(device)
        self.hp = hp
        self.cfg = load_model_config(model_name, config_path)
        self.model_name = model_name
        self.bucket_frames = bucket_frames
        self.L = getattr(self.cfg.arch, "L", None)  # Basis-MelGAN's frame length
        self.generator, self.pattern = load_generator(
            checkpoint_path, self.cfg, self.device
        )

    def _pad_frames(self, T: int) -> int:
        if self.bucket_frames <= 0:
            return T
        b = self.bucket_frames
        return ((T + b - 1) // b) * b

    def _run_device(self, mel: np.ndarray) -> torch.Tensor:
        """mel (T, 80) -> raw waveform (1, N) on the device, not synchronised."""
        T = mel.shape[0]
        Tp = self._pad_frames(T)
        if Tp != T:
            mel = np.pad(mel, ((0, Tp - T), (0, 0)))
        with torch.inference_mode():
            x = torch.from_numpy(np.ascontiguousarray(mel, np.float32)[None])
            return self.generator.inference(x.to(self.device))

    def _run(self, mel: np.ndarray) -> np.ndarray:
        """mel (T, 80) -> raw inference waveform (1-D, untrimmed)."""
        T = mel.shape[0]
        wav = self._run_device(mel)[0].cpu().numpy()
        if self._pad_frames(T) != T:
            if self.model_name == "basis-melgan":
                keep = (T * self._weight_steps() - 1) * (self.L // 2) + self.L
            else:
                keep = T * self.hp.hop_size
            wav = wav[:keep]
        return wav

    def _weight_steps(self) -> int:
        steps = 1
        for s in self.cfg.arch.upsample_scales:
            steps *= s
        return steps

    def synthesize(self, mel: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """mel (T, 80) -> (est, est - bias, bias); bias from a zero mel."""
        mel = np.asarray(mel, dtype=np.float32)
        bias = self._run(np.zeros_like(mel))
        est = self._run(mel)
        return est, est - bias, bias

    def test_rtf(self, mel: np.ndarray) -> torch.Tensor:
        """RTF-protocol inference: the waveform stays on the device (the
        timed loop synchronises once at the end)."""
        return self._run_device(np.asarray(mel, dtype=np.float32))


def run_synthesizer(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint_path", type=str, required=True,
                        help="release checkpoint (.npz, docs/checkpoints/)")
    parser.add_argument("--mel_path", type=str, required=True, help="(80, T) .npy")
    parser.add_argument("--wav_path", type=str, required=True)
    parser.add_argument("--model_name", type=str, default="basis-melgan",
                        help="basis-melgan, hifigan or multiband-hifigan")
    parser.add_argument("--config", type=str, required=True,
                        help="path to model configuration file")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    hp = HP
    synthesizer = Synthesizer(
        args.checkpoint_path, args.config, args.model_name, hp, device=args.device
    )
    mel = np.load(args.mel_path)
    est, est_remove, bias = synthesizer.synthesize(mel.T)
    audio.save_wav(est, args.wav_path, hp.sample_rate, rescale_out=hp.rescale_out)
    audio.save_wav(est_remove, args.wav_path[:-3] + "remove.wav", hp.sample_rate,
                   rescale_out=hp.rescale_out)
    audio.save_wav(bias, args.wav_path[:-3] + "bias.wav", hp.sample_rate,
                   rescale_out=hp.rescale_out)


if __name__ == "__main__":
    run_synthesizer()
