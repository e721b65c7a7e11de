"""Griffin-Lim phase recovery and mel inversion, in torch on the device.

Counterpart of both of the JAX package's loops: the jitted one
(`fastvocoder_tpu/dsp/griffin_lim.py`, float32, frames trimmed to the
magnitude's count) and the numpy one (`dsp/audio.py::_griffin_lim`,
float64, the phase as `np.angle`).  The magnitude's dtype decides which
one `griffin_lim` mirrors.  The FFTs are cuFFT through `torch.fft` (the JAX
package runs them as XLA FFTs, outside any Pallas kernel).  The initial
phase is `phase0` when given (the tests pass in the JAX package's draw),
else uniform in [0, 2 pi) from the caller's `torch.Generator`, so a seeded
inversion is reproducible on one device.  The inverse preemphasis is an
IIR filter and runs on the host (`scipy.signal.lfilter`), as in the JAX
package.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import scipy.signal
import torch

from fastvocoder_tpu_torch import resolve_device
from fastvocoder_tpu_torch.dsp.mel import mel_filter_bank
from fastvocoder_tpu_torch.dsp.stft import istft, padded_window, stft_complex
from fastvocoder_tpu_torch.hparams import HP, Hparams


@functools.lru_cache(maxsize=8)
def _inv_mel_basis(sample_rate: int, n_fft: int, num_mels: int, fmin: float) -> np.ndarray:
    """pinv of the float64 mel filterbank, (n_fft // 2 + 1, num_mels)."""
    return np.linalg.pinv(mel_filter_bank(sample_rate, n_fft, num_mels, fmin, dtype=np.float64))


def griffin_lim(mag: torch.Tensor, n_iters: int, n_fft: int, hop: int, win: int, length: int,
                phase0=None, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Phase recovery from the magnitude (frames, bins) -> waveform
    (length,), in mag's dtype on mag's device: float32 as the JAX loop
    (phase z / max(|z|, 1e-8)), float64 as the numpy loop (exp(i angle z))."""
    if phase0 is None:
        phase0 = 2.0 * math.pi * torch.rand(mag.shape, generator=generator, dtype=mag.dtype,
                                            device=mag.device)
    else:
        phase0 = torch.as_tensor(phase0).to(device=mag.device, dtype=mag.dtype)
    exact = mag.dtype == torch.float64
    window = padded_window(win, n_fft, mag.device, mag.dtype)
    y = istft(mag * torch.exp(1j * phase0), n_fft, hop, win, length=length)
    for _ in range(n_iters):
        z = stft_complex(y, n_fft, hop, win, window=window)[..., : mag.shape[-2], :]
        if exact:
            angles = torch.exp(1j * torch.angle(z))
        else:
            angles = z / torch.clamp(z.abs(), min=1e-8)
        y = istft(mag * angles, n_fft, hop, win, length=length)
    return y


def griffin_lim_waveform(S: torch.Tensor, hp: Hparams = HP, seed: int = 0) -> np.ndarray:
    """A linear magnitude (bins, frames) on the device -> the waveform of
    `griffin_lim` on S ** power (phase drawn from `seed`), length
    hop * (frames - 1), inverse preemphasis on the host, float64."""
    generator = torch.Generator(device=S.device)
    generator.manual_seed(seed)
    y = griffin_lim((S ** hp.power).T, n_iters=hp.griffin_lim_iters, n_fft=hp.n_fft,
                    hop=hp.hop_length, win=hp.win_length,
                    length=hp.hop_length * (S.shape[1] - 1), generator=generator)
    return scipy.signal.lfilter([1], [1, -hp.preemphasis], y.double().cpu().numpy())


def inv_mel_spectrogram(mel, hp: Hparams = HP, seed: int = 0, device="cuda",
                        dtype=torch.float32) -> np.ndarray:
    """mel (num_mels, frames) -> waveform (hop * (frames - 1),) through
    Griffin-Lim on `device`, as the JAX package's `inv_mel_spectrogram_jax`
    (denormalise, dB to amplitude, the filterbank's pseudo-inverse, GL on
    S ** power, inverse preemphasis); computes in `dtype` (float64:
    `dsp.audio.inv_mel_spectrogram`)."""
    dev = resolve_device(device)
    mel = torch.as_tensor(np.asarray(mel)).to(device=dev, dtype=dtype)
    D = torch.clamp(mel, 0, 1) * -hp.min_level_db + hp.min_level_db \
        if hp.signal_normalization else mel
    amp = torch.pow(10.0, (D + hp.ref_level_db) * 0.05)
    inv = torch.from_numpy(_inv_mel_basis(hp.sample_rate, hp.n_fft, hp.num_mels, hp.fmin))
    S = torch.clamp(inv.to(device=dev, dtype=dtype) @ amp, min=1e-10)
    return griffin_lim_waveform(S, hp, seed)
