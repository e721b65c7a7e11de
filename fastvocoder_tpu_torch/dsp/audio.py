"""Audio I/O and feature extraction with the reference's semantics.

The port's own copy of `fastvocoder_tpu/dsp/audio.py` (reference
data/audio.py): the 16-bit peak-normalised encode (audio.py:12-14), wav
loading with a kaiser_best-class polyphase resampler, preemphasis
(audio.py:29-34), the STFT 2048 / 240 / 1200 (audio.py:103-127), the Slaney
mel of 80 bins from 40 Hz (audio.py:135-144), dB and the [0, 1] clip
normalisation (audio.py:147-168), and Griffin-Lim inversion (audio.py:74-84,
181-191).

Wav I/O and the resampler stay numpy / scipy on the host, as in the JAX
package.  The transforms run in torch in float64 on `device` (CUDA unless
the caller passes "cpu"), so they equal the JAX package's numpy to
rounding; they take numpy arrays or tensors and return numpy arrays.  The
preemphasis FIR runs on the device inside them; the inverse preemphasis is
an IIR filter and runs on the host.
"""

from __future__ import annotations

import functools

import numpy as np
import scipy.io.wavfile
import scipy.signal
import torch

from fastvocoder_tpu_torch import resolve_device
from fastvocoder_tpu_torch.dsp import griffin_lim as _gl
from fastvocoder_tpu_torch.dsp.mel import mel_filter_bank
from fastvocoder_tpu_torch.dsp.stft import istft, padded_window, stft_complex
from fastvocoder_tpu_torch.hparams import HP, Hparams


# ---------------------------------------------------------------------------
# Wav I/O (reference data/audio.py:12-26), on the host
# ---------------------------------------------------------------------------


def encode_16bits(x: np.ndarray, rescale_out: float = 1.0) -> np.ndarray:
    x = x * (32767 / max(0.01, float(np.max(np.abs(x)))) * rescale_out)
    return x.astype(np.int16)


# librosa/resampy "kaiser_best" design constants: 64 zero crossings, Kaiser
# beta 14.77, 0.9476 roll-off (scipy's default resample_poly window, Kaiser
# beta 5, is far noisier on the 22.05 -> 24 kHz path)
_KAISER_BEST = dict(zeros=64, beta=14.769656459379492, rolloff=0.9475937167399596)


@functools.lru_cache(maxsize=16)
def _resample_filter(up: int, down: int) -> np.ndarray:
    kb = _KAISER_BEST
    ntaps = 2 * kb["zeros"] * max(up, down) + 1
    return scipy.signal.firwin(ntaps, kb["rolloff"] / max(up, down),
                               window=("kaiser", kb["beta"]))


def resample(x: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resample with a librosa-kaiser_best-class filter."""
    if sr == target_sr:
        return np.asarray(x, dtype=np.float32)
    g = np.gcd(int(sr), int(target_sr))
    up, down = target_sr // g, sr // g
    return scipy.signal.resample_poly(x, up, down, window=_resample_filter(up, down)
                                      ).astype(np.float32)


def load_wav(filename: str, sample_rate: int = 24000, encode: bool = True) -> np.ndarray:
    """Load and resample to `sample_rate`: float32 in [-1, 1], or with
    `encode` the 16-bit peak-normalised encode (librosa.load parity)."""
    sr, data = scipy.io.wavfile.read(filename)
    if data.dtype == np.int16:
        x = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        x = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        x = (data.astype(np.float32) - 128.0) / 128.0
    else:
        x = data.astype(np.float32)
    if x.ndim > 1:
        x = x.mean(axis=1)
    if sr != sample_rate:
        x = resample(x, sr, sample_rate)
    if encode:
        x = encode_16bits(x)
    return x


def save_wav(y: np.ndarray, filename: str, sample_rate: int, rescale_out: float = 1.0):
    y = encode_16bits(np.asarray(y, dtype=np.float32), rescale_out)
    scipy.io.wavfile.write(filename, sample_rate, y.astype(np.int16))


# ---------------------------------------------------------------------------
# Preemphasis (reference data/audio.py:29-34)
# ---------------------------------------------------------------------------


def preemphasis(x, hp: Hparams = HP):
    """The FIR x[n] - p x[n - 1]: scipy on an array, torch on a tensor's
    device (the same float64 arithmetic)."""
    if isinstance(x, torch.Tensor):
        return torch.cat([x[..., :1], x[..., 1:] - hp.preemphasis * x[..., :-1]], dim=-1)
    return scipy.signal.lfilter([1, -hp.preemphasis], [1], x)


def inv_preemphasis(x: np.ndarray, hp: Hparams = HP) -> np.ndarray:
    return scipy.signal.lfilter([1], [1, -hp.preemphasis], x)


# ---------------------------------------------------------------------------
# STFT in float64 (librosa.stft parity), layout (bins, frames)
# ---------------------------------------------------------------------------


def _float64(x, device: torch.device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x))
    return x.to(device=device, dtype=torch.float64)


def _stft(y: torch.Tensor, hp: Hparams = HP) -> torch.Tensor:
    """Complex STFT of a float64 (N,) -> (1 + n_fft / 2, frames)."""
    window = padded_window(hp.win_length, hp.n_fft, y.device, torch.float64)
    return stft_complex(y, hp.n_fft, hp.hop_length, hp.win_length, window=window).T


def _istft(z: torch.Tensor, hp: Hparams = HP) -> torch.Tensor:
    """Inverse of `_stft` (librosa.istft parity), input (bins, frames)."""
    return istft(z.T, hp.n_fft, hp.hop_length, hp.win_length)


# ---------------------------------------------------------------------------
# Conversions (reference data/audio.py:130-168)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def _mel_basis(sample_rate: int, n_fft: int, num_mels: int, fmin: float) -> np.ndarray:
    return mel_filter_bank(sample_rate, n_fft, n_mels=num_mels, fmin=fmin, dtype=np.float64)


def _linear_to_mel(spectrogram: torch.Tensor, hp: Hparams = HP) -> torch.Tensor:
    basis = _mel_basis(hp.sample_rate, hp.n_fft, hp.num_mels, hp.fmin)
    return torch.from_numpy(basis).to(spectrogram.device) @ spectrogram


def _amp_to_db(x: torch.Tensor) -> torch.Tensor:
    return 20 * torch.log10(torch.clamp(x, min=1e-5))


def _db_to_amp(x: torch.Tensor) -> torch.Tensor:
    return torch.pow(10.0, x * 0.05)


def _normalize(S: torch.Tensor, hp: Hparams = HP) -> torch.Tensor:
    return torch.clamp((S - hp.min_level_db) / -hp.min_level_db, 0, 1)


def _denormalize(S: torch.Tensor, hp: Hparams = HP) -> torch.Tensor:
    return (torch.clamp(S, 0, 1) * -hp.min_level_db) + hp.min_level_db


# ---------------------------------------------------------------------------
# Public feature extraction (reference data/audio.py:37-61)
# ---------------------------------------------------------------------------


def spectrogram(y, hp: Hparams = HP, device="cuda") -> np.ndarray:
    """wav (N,) -> normalised linear spectrogram (1 + n_fft / 2, frames)."""
    D = _stft(preemphasis(_float64(y, resolve_device(device)), hp), hp)
    S = _amp_to_db(D.abs()) - hp.ref_level_db
    return _normalize(S, hp).cpu().numpy()


def melspectrogram(y, hp: Hparams = HP, device="cuda") -> np.ndarray:
    """wav (N,) -> normalised mel (num_mels, frames), float64."""
    D = _stft(preemphasis(_float64(y, resolve_device(device)), hp), hp)
    S = _amp_to_db(_linear_to_mel(D.abs(), hp)) - hp.ref_level_db
    return _normalize(S, hp).cpu().numpy()


# ---------------------------------------------------------------------------
# Griffin-Lim inversion (reference data/audio.py:74-84,171-191)
# ---------------------------------------------------------------------------


def inv_spectrogram(spec, hp: Hparams = HP, seed: int = 0, device="cuda") -> np.ndarray:
    """Normalised linear spectrogram (bins, frames) -> waveform, Griffin-Lim
    in float64 on `device` from a phase drawn from `seed`."""
    S = _db_to_amp(_denormalize(_float64(spec, resolve_device(device)), hp) + hp.ref_level_db)
    return _gl.griffin_lim_waveform(S, hp, seed)


def inv_mel_spectrogram(mel_spectrogram, hp: Hparams = HP, seed: int = 0,
                        device="cuda") -> np.ndarray:
    """mel (num_mels, frames) -> waveform via Griffin-Lim in float64 on
    `device` (`dsp.griffin_lim.inv_mel_spectrogram`)."""
    return _gl.inv_mel_spectrogram(mel_spectrogram, hp, seed=seed, device=device,
                                   dtype=torch.float64)
