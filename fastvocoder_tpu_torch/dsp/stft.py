"""STFT with `torch.stft` / `librosa.stft` numeric parity, as the losses and
the MFD discriminator use it.

Counterpart of `fastvocoder_tpu/dsp/stft.py` (`stft_complex`, `stft_mag`):
`center=True` reflect padding of n_fft // 2, a periodic Hann window
zero-padded symmetrically to n_fft, one-sided FFT, no normalisation.  Framing
is `Tensor.unfold` and the transform `torch.fft.rfft`, both differentiable;
the JAX package's custom VJP of its framing is a TPU device and has no
counterpart.
"""

from __future__ import annotations

import math

import torch

from fastvocoder_tpu_torch.ops.conv import reflect_index


def hann_window(win_length: int, device=None) -> torch.Tensor:
    """Periodic Hann window, as `torch.hann_window(win_length)`; computed in
    float64 and rounded once, as the JAX package does."""
    n = torch.arange(win_length, dtype=torch.float64, device=device)
    return (0.5 - 0.5 * torch.cos(2.0 * math.pi * n / win_length)).float()


def padded_window(win_length: int, n_fft: int, device=None) -> torch.Tensor:
    """The Hann window centred inside an n_fft frame (torch.stft's rule)."""
    w = hann_window(win_length, device)
    if win_length == n_fft:
        return w
    left = (n_fft - win_length) // 2
    return torch.nn.functional.pad(w, (left, n_fft - win_length - left))


def stft_complex(x: torch.Tensor, fft_size: int, hop_size: int, win_length: int,
                 center: bool = True) -> torch.Tensor:
    """Complex STFT of (..., T) -> (..., frames, fft_size // 2 + 1)."""
    if center:
        idx = reflect_index(x.shape[-1], fft_size // 2, device=x.device)
        x = x.index_select(-1, idx)
    frames = x.unfold(-1, fft_size, hop_size)  # (..., frames, fft_size)
    frames = frames * padded_window(win_length, fft_size, x.device).to(x.dtype)
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
