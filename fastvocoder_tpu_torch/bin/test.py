"""RTF benchmark / published-checkpoint test entry point (counterpart of
`fastvocoder_tpu/bin/test.py`, reference bin/test.py).

Synthesizes every mel in a directory with the published pattern bias
subtracted (reference bin/test.py:82-91), then measures RTF with the
reference protocol: 10 inference passes over every mel,
rtf = elapsed / (10 * total audio seconds) (reference bin/test.py:123-132),
best of 2 windows.  Each window ends with `torch.cuda.synchronize()`.
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
        """Raw inference, trim the L/2 tail, subtract the pattern (or a
        recomputed zero-mel bias) (reference bin/test.py:83-91)."""
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
    parser.add_argument("--model_name", type=str, default="basis-melgan")
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
    list_files = sorted(f for f in os.listdir(args.file_path) if f.endswith(".npy"))
    for file in list_files:
        mel = np.load(os.path.join(args.file_path, file))
        if mel.shape[0] == hp.num_mels:
            mel = mel.T
        mels.append(mel.astype(np.float32))
        duration += (mel.shape[0] * hp.hop_size) / hp.sample_rate
    print(f"duration is {duration}s.")

    for mel, filename in zip(mels, list_files):
        audio.save_wav(
            synthesizer.synthesize(mel),
            os.path.join(args.file_path, f"{filename}.wav"),
            sample_rate=hp.sample_rate,
        )

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
