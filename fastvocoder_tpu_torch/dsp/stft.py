"""STFT and inverse STFT with `torch.stft` / `librosa.stft` numeric parity.

Counterpart of `fastvocoder_tpu/dsp/stft.py`: `center=True` reflect padding
of n_fft // 2, a periodic Hann window zero-padded symmetrically to n_fft,
one-sided FFT, no normalisation.  The losses and the MFD discriminator take
`stft_complex` / `stft_mag`, whose framing is `Tensor.unfold`; Griffin-Lim
and feature extraction (`dsp/griffin_lim.py`, `dsp/audio.py`) take `istft`
as well, an overlap-add through `ops/overlap_add.py` normalised by the
squared window's envelope.  `frame_signal` is the JAX package's framing
gather, reads past the end clamped to the last sample; its gradient is
autograd's (the JAX package's custom VJP exists for XLA:TPU's scatter).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from fastvocoder_tpu_torch.ops.conv import reflect_index
from fastvocoder_tpu_torch.ops.overlap_add import overlap_and_add


def hann_window(win_length: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """Periodic Hann window, as `torch.hann_window(win_length)`; computed in
    float64 and rounded once to `dtype`, as the JAX package does."""
    n = torch.arange(win_length, dtype=torch.float64, device=device)
    return (0.5 - 0.5 * torch.cos(2.0 * math.pi * n / win_length)).to(dtype)


def padded_window(win_length: int, n_fft: int, device=None,
                  dtype=torch.float32) -> torch.Tensor:
    """The Hann window centred inside an n_fft frame (torch.stft's rule)."""
    w = hann_window(win_length, device, dtype)
    if win_length == n_fft:
        return w
    left = (n_fft - win_length) // 2
    return torch.nn.functional.pad(w, (left, n_fft - win_length - left))


def num_stft_frames(length: int, n_fft: int, hop: int, center: bool = True) -> int:
    if center:
        length = length + 2 * (n_fft // 2)
    return 1 + (length - n_fft) // hop


def frame_signal(x: torch.Tensor, num_frames: int, n_fft: int, hop: int) -> torch.Tensor:
    """(..., T) -> (..., num_frames, n_fft) overlapping frames, frame f
    starting at f * hop.  A read past the end reads x[T - 1], so its
    cotangent goes to sample T - 1."""
    starts = torch.arange(num_frames, device=x.device)[:, None] * hop
    idx = (starts + torch.arange(n_fft, device=x.device)[None, :]).clamp(max=x.shape[-1] - 1)
    return x[..., idx]


def stft_complex(x: torch.Tensor, fft_size: int, hop_size: int, win_length: int,
                 center: bool = True, window: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Complex STFT of (..., T) -> (..., frames, fft_size // 2 + 1).  The
    window is `padded_window` rounded to float32 (then cast to x's type)
    unless `window` (fft_size,) is given."""
    if center:
        idx = reflect_index(x.shape[-1], fft_size // 2, device=x.device)
        x = x.index_select(-1, idx)
    frames = x.unfold(-1, fft_size, hop_size)  # (..., frames, fft_size)
    if window is None:
        window = padded_window(win_length, fft_size, x.device)
    frames = frames * window.to(x.dtype)
    if frames.dtype not in (torch.float32, torch.float64):
        frames = frames.float()  # the transform never runs in half precision
    return torch.fft.rfft(frames, n=fft_size, dim=-1)


def stft_mag(x: torch.Tensor, fft_size: int, hop_size: int, win_length: int,
             eps: float = 1e-7, center: bool = True) -> torch.Tensor:
    """Magnitude STFT, sqrt(max(re^2 + im^2, eps)) as the reference's loss
    and discriminator clamp it (reference model/loss/stft_loss.py:37,
    model/discriminator/mfd.py:40); -> (..., frames, fft_size // 2 + 1)."""
    z = stft_complex(x, fft_size, hop_size, win_length, center=center)
    power = z.real ** 2 + z.imag ** 2
    return torch.sqrt(torch.clamp(power, min=eps))


def istft(z: torch.Tensor, fft_size: int, hop_size: int, win_length: int,
          center: bool = True, length: Optional[int] = None) -> torch.Tensor:
    """Inverse STFT (librosa.istft's convention) of (..., frames, bins) ->
    (..., T): windowed inverse FFTs overlap-added, divided by the squared
    window's envelope (at least 1e-10), the window in z's real type."""
    nf = z.shape[-2]
    frames = torch.fft.irfft(z, n=fft_size, dim=-1)
    win = padded_window(win_length, fft_size, frames.device, frames.dtype)
    out = overlap_and_add(frames * win, hop_size)
    wsq = overlap_and_add((win * win).expand(nf, fft_size), hop_size)
    out = out / torch.clamp(wsq, min=1e-10)
    if center:
        total = fft_size + hop_size * (nf - 1)
        out = out[..., fft_size // 2 : total - fft_size // 2]
    if length is not None:
        out = out[..., :length]
    return out
