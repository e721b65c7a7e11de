"""Slaney-style mel filterbank, numerically matching librosa.filters.mel.

The port's own copy of `fastvocoder_tpu/dsp/mel.py` (the port imports
nothing of the JAX package): numpy, since the filterbank is built once, in
float64.  The reference builds its basis with
``librosa.filters.mel(sr, n_fft, n_mels=80, fmin=40)`` (reference
data/audio.py:142-144): the Slaney mel scale, Slaney area normalisation and
fmax = sr / 2.
"""

from __future__ import annotations

import numpy as np

_F_SP = 200.0 / 3          # Hz per mel below the break
_MIN_LOG_HZ = 1000.0       # break frequency
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(f):
    f = np.asarray(f, dtype=np.float64)
    mels = f / _F_SP
    log_region = f >= _MIN_LOG_HZ
    return np.where(
        log_region,
        _MIN_LOG_MEL + np.log(np.maximum(f, 1e-10) / _MIN_LOG_HZ) / _LOGSTEP,
        mels,
    )


def mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    f = m * _F_SP
    log_region = m >= _MIN_LOG_MEL
    return np.where(log_region, _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL)), f)


def mel_filter_bank(
    sample_rate: int,
    n_fft: int,
    n_mels: int = 80,
    fmin: float = 0.0,
    fmax: float | None = None,
    dtype=np.float32,
) -> np.ndarray:
    """Triangular mel filterbank, shape (n_mels, n_fft // 2 + 1)."""
    if fmax is None:
        fmax = sample_rate / 2.0

    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_fft // 2 + 1)
    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    # Slaney area normalisation
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(dtype)
