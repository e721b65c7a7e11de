"""Wav output with the reference's 16-bit peak-normalised encode
(reference data/audio.py:12-26); the port's copy of the part of
`fastvocoder_tpu/dsp/audio.py` that synthesis needs."""

from __future__ import annotations

import numpy as np
import scipy.io.wavfile


def encode_16bits(x: np.ndarray, rescale_out: float = 1.0) -> np.ndarray:
    x = x * (32767 / max(0.01, float(np.max(np.abs(x)))) * rescale_out)
    return x.astype(np.int16)


def save_wav(y: np.ndarray, filename: str, sample_rate: int, rescale_out: float = 1.0):
    y = encode_16bits(np.asarray(y, dtype=np.float32), rescale_out)
    scipy.io.wavfile.write(filename, sample_rate, y.astype(np.int16))
