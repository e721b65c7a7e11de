"""RTF benchmark / published-checkpoint test entry point (counterpart of
`fastvocoder_tpu/bin/test.py`, reference bin/test.py).

For Basis-MelGAN, synthesizes every mel in a directory with the published
pattern bias subtracted and writes `<mel>.npy.wav` beside it (reference
bin/test.py:82-91; the JAX package writes these for Basis-MelGAN only).  For
every family it then measures RTF with the reference protocol: 10
inference passes over every mel, rtf = elapsed / (10 * total audio
seconds) (reference bin/test.py:123-132), best of 2 windows.  Each window
ends with `torch.cuda.synchronize()`.

NHV reads its conditioning as the mel and f0: a packed (81, T) file, or an
(80, T) `<name>.mel.npy` with its `<name>.f0.npy` beside it (f0 files are
not mels of their own).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from fastvocoder_tpu_torch.bin.synthesize import Synthesizer as _BaseSynthesizer
from fastvocoder_tpu_torch.dsp import audio
from fastvocoder_tpu_torch.hparams import HP

class Synthesizer(_BaseSynthesizer):
    """Published-checkpoint synthesizer with pattern-bias subtraction."""

    def synthesize(self, mel: np.ndarray) -> np.ndarray:  # type: ignore[override]
        """Basis-MelGAN only (reference bin/test.py:83): raw inference, trim
        the L/2 tail, subtract the pattern (or a recomputed zero-mel bias)
        (reference bin/test.py:83-91)."""
        if self.model_name != "basis-melgan":
            raise ValueError(
                f"pattern-subtracted synthesis is Basis-MelGAN's, not {self.model_name!r}")
        mel = np.asarray(mel, dtype=np.float32)
        est = self._run(mel)[: -(self.L // 2)]
        if self.pattern is not None:
            est = est - self.pattern[: est.shape[0]]
        else:
            est = est - self._run(np.zeros_like(mel))[: -(self.L // 2)]
        return est


def run_test(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint_path", type=str, required=True)
    parser.add_argument("--file_path", type=str, required=True,
                        help="directory of mel .npy files")
    parser.add_argument("--model_name", type=str, default="basis-melgan",
                        help="basis-melgan, hifigan, multiband-hifigan, melgan or nhv")
    parser.add_argument("--config", type=str, required=True,
                        help="path to model configuration file")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    hp = HP
    # bucket mel lengths to multiples of 64 frames, as the JAX driver does
    synthesizer = Synthesizer(
        args.checkpoint_path, args.config, args.model_name, hp,
        bucket_frames=64, device=args.device,
    )

    mels = []
    duration = 0.0
    list_files = sorted(f for f in os.listdir(args.file_path)
                        if f.endswith(".npy") and not f.endswith(".f0.npy"))
    for file in list_files:
        mel = np.load(os.path.join(args.file_path, file))
        if mel.shape[0] == hp.num_mels or (args.model_name == "nhv"
                                            and mel.shape[0] == hp.num_mels + 1):
            mel = mel.T
        f0 = None
        if args.model_name == "nhv" and mel.shape[1] == hp.num_mels:
            f0_file = os.path.join(args.file_path, file.replace(".mel.npy", ".f0.npy"))
            if f0_file.endswith(".f0.npy") and os.path.exists(f0_file):
                f0 = np.load(f0_file)
        mels.append(synthesizer.condition(mel, f0))
        duration += (mels[-1].shape[0] * hp.hop_size) / hp.sample_rate
    print(f"duration is {duration}s.")

    if args.model_name == "basis-melgan":
        for mel, filename in zip(mels, list_files):
            audio.save_wav(
                synthesizer.synthesize(mel),
                os.path.join(args.file_path, f"{filename}.wav"),
                sample_rate=hp.sample_rate,
            )

    return measure_rtf(synthesizer, mels, duration)


def measure_rtf(synthesizer: _BaseSynthesizer, mels, duration: float) -> float:
    """The reference's protocol: 10 inference passes over every mel (the
    generator's input, `Synthesizer.condition`), rtf = elapsed / (10 *
    `duration` seconds of audio), best of 2 windows; the first pass, untimed,
    builds the kernels and lets the libraries tune."""

    def sync():
        if synthesizer.device.type == "cuda":
            torch.cuda.synchronize(synthesizer.device)

    for mel in mels:  # first use (kernel build, library autotuning) untimed
        synthesizer.test_rtf(mel)
    sync()
    cost = float("inf")
    for _ in range(2):
        s = time.perf_counter()
        for _ in range(10):
            for mel in mels:
                synthesizer.test_rtf(mel)
        sync()
        cost = min(cost, time.perf_counter() - s)
    print(f"cost time: {cost}s.")
    rtf = cost / (10.0 * duration)
    print(f"rtf is {rtf}.")
    return rtf


if __name__ == "__main__":
    run_test()
