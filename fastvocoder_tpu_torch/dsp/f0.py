"""Frame-level f0 estimation and NHV's conditioning, in numpy.

The port's own copy of `fastvocoder_tpu/dsp/f0.py` (the port imports
nothing of the JAX package), with the same arithmetic, so that the results
are bit-identical: a normalised autocorrelation per frame (through an FFT),
its peak over the lag range of [fmin, fmax], a parabolic refinement of the
peak, and a voicing threshold.  NHV (`models/nhv.py`) reads f0 as channel
80 of its conditioning (`f0_to_condition`).
"""

from __future__ import annotations

import numpy as np

from fastvocoder_tpu_torch.hparams import HP, Hparams


def extract_f0(
    wav: np.ndarray,
    hp: Hparams = HP,
    fmin: float = 50.0,
    fmax: float = 600.0,
    frame_length: int = 1024,
    voicing_threshold: float = 0.3,
) -> np.ndarray:
    """wav (N,) -> f0 (T,) in Hz, 0 where unvoiced; T = N // hop + 1, the
    mel's frame count."""
    sr = hp.sample_rate
    hop = hp.hop_size
    n_frames = wav.shape[0] // hop + 1
    half = frame_length // 2
    padded = np.pad(wav.astype(np.float64), (half, half + frame_length))

    # frames centred at t * hop: (T, frame_length)
    idx = (np.arange(n_frames) * hop)[:, None] + np.arange(frame_length)[None, :]
    frames = padded[idx]
    frames = frames - frames.mean(axis=1, keepdims=True)

    # autocorrelation through the power spectrum, normalised by lag 0
    nfft = 2 * frame_length
    spec = np.fft.rfft(frames, nfft, axis=1)
    ac = np.fft.irfft(spec * np.conj(spec), nfft, axis=1)[:, :frame_length]
    nac = ac / np.maximum(ac[:, :1], 1e-9)

    lag_min = max(2, int(sr / fmax))
    lag_max = min(frame_length - 1, int(sr / fmin))
    window = nac[:, lag_min : lag_max + 1]
    best = np.argmax(window, axis=1)
    peak = window[np.arange(n_frames), best]

    # parabolic interpolation around the peak: a sub-sample lag
    li = (best + lag_min).clip(1, frame_length - 2)
    y0 = nac[np.arange(n_frames), li - 1]
    y1 = nac[np.arange(n_frames), li]
    y2 = nac[np.arange(n_frames), li + 1]
    denom = y0 - 2 * y1 + y2
    with np.errstate(divide="ignore", invalid="ignore"):
        delta = np.where(np.abs(denom) > 1e-12, 0.5 * (y0 - y2) / denom, 0.0)
    lag = li + np.clip(delta, -1, 1)

    f0 = sr / lag
    voiced = (peak > voicing_threshold) & (f0 >= fmin) & (f0 <= fmax)
    return np.where(voiced, f0, 0.0).astype(np.float32)


def f0_to_condition(mel: np.ndarray, f0: np.ndarray) -> np.ndarray:
    """(T, 80) mel and (T,) f0 -> NHV's conditioning (T', 81), f0 in Hz on
    channel 80 (0 = unvoiced), T' the shorter of the two lengths."""
    t = min(mel.shape[0], f0.shape[0])
    return np.concatenate([mel[:t], f0[:t, None]], axis=1).astype(np.float32)
