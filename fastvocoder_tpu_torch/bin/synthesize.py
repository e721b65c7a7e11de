"""Synthesis entry point (counterpart of `fastvocoder_tpu/bin/synthesize.py`,
reference bin/synthesize.py:17-104), for every generator family.

`Synthesizer` loads a release checkpoint into the fused generator and
synthesizes with zero-mel bias removal (reference bin/synthesize.py:74-80),
through the generator's `inference` (the method the JAX package serves the
family with, `models/factory.py`).  With `bucket_frames > 0` the mel is
zero-padded up to a multiple of it and the waveform trimmed back to the
unpadded length: Basis-MelGAN's raw decode length, `T * hop` for the other
families, as the JAX package's entry point trims.  Samples within the
generator's receptive field of the pad boundary then differ from an
exact-length run by edge effects only.

NHV is conditioned on the mel and f0 (T, 81) (`dsp.f0.f0_to_condition`):
`synthesize` takes the packed tensor, or an 80-channel mel with `f0=`; its
zero-conditioning bias has f0 = 0 everywhere (no voicing: the noise source
alone).  The CLI reads f0 from `--f0_path`, by default the `<name>.f0.npy`
beside a `<name>.mel.npy`.

`Synthesizer(compute_dtype=torch.bfloat16)` synthesizes in bf16 as the JAX
package's `compute_dtype` does (parameters float32, the waveform float32);
the CLI has no bf16 flag, as the JAX package's has none.
"""

from __future__ import annotations

import argparse
from typing import Tuple

import numpy as np
import torch

from fastvocoder_tpu_torch import resolve_device
from fastvocoder_tpu_torch.dsp import audio
from fastvocoder_tpu_torch.dsp.f0 import f0_to_condition
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
        compute_dtype=None,
    ) -> None:
        self.device = resolve_device(device)
        self.hp = hp
        self.cfg = load_model_config(model_name, config_path)
        self.model_name = model_name
        self.bucket_frames = bucket_frames
        self.L = getattr(self.cfg.arch, "L", None)  # Basis-MelGAN's frame length
        self.generator, self.pattern = load_generator(
            checkpoint_path, self.cfg, self.device, compute_dtype=compute_dtype
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

    def condition(self, mel: np.ndarray, f0=None) -> np.ndarray:
        """The generator's input for mel (T, C): NHV's (T, 81) from an
        80-channel mel and `f0` (T,), which it then needs; else the mel."""
        mel = np.asarray(mel, dtype=np.float32)
        if self.model_name == "nhv" and mel.shape[1] == self.cfg.arch.in_channels:
            if f0 is None:
                raise ValueError(
                    "nhv conditioning must be mel + f0: pass f0=(T,) with the 80-channel "
                    "mel, or the packed (T, 81) tensor (dsp.f0.f0_to_condition)")
            mel = f0_to_condition(mel, np.asarray(f0, np.float32))
        return mel

    def synthesize(self, mel: np.ndarray, f0=None
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """mel (T, 80) -> (est, est - bias, bias); bias from a zero mel (for
        NHV a zero conditioning, f0 = 0 included).  NHV takes (T, 81), or
        the mel with `f0` (T,)."""
        mel = self.condition(mel, f0)
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
                        help="release checkpoint (.npz, docs/checkpoints/) or a "
                             "checkpoint_<step>.pth.tar of bin/train.py")
    parser.add_argument("--mel_path", type=str, required=True, help="(80, T) .npy")
    parser.add_argument("--wav_path", type=str, required=True)
    parser.add_argument("--model_name", type=str, default="basis-melgan",
                        help="basis-melgan, hifigan, multiband-hifigan, melgan or nhv")
    parser.add_argument("--config", type=str, required=True,
                        help="path to model configuration file")
    parser.add_argument("--f0_path", type=str, default="",
                        help="nhv only: the f0 track (T,) .npy; by default the <name>.f0.npy "
                             "beside a --mel_path <name>.mel.npy")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    hp = HP
    synthesizer = Synthesizer(
        args.checkpoint_path, args.config, args.model_name, hp, device=args.device
    )
    mel = np.load(args.mel_path)
    f0 = None
    if args.model_name == "nhv":
        f0_path = args.f0_path or args.mel_path.replace(".mel.npy", ".f0.npy")
        if f0_path == args.mel_path:
            raise SystemExit("nhv needs an f0 track: --mel_path is not named <name>.mel.npy, so "
                             "there is no default f0 path; pass --f0_path")
        f0 = np.load(f0_path)
    est, est_remove, bias = synthesizer.synthesize(mel.T, f0=f0)
    audio.save_wav(est, args.wav_path, hp.sample_rate, rescale_out=hp.rescale_out)
    audio.save_wav(est_remove, args.wav_path[:-3] + "remove.wav", hp.sample_rate,
                   rescale_out=hp.rescale_out)
    audio.save_wav(bias, args.wav_path[:-3] + "bias.wav", hp.sample_rate,
                   rescale_out=hp.rescale_out)


if __name__ == "__main__":
    run_synthesizer()
