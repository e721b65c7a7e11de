"""Multi-resolution STFT reconstruction loss, plain functions on tensors.

Counterpart of `fastvocoder_tpu/losses/stft_loss.py` (reference
model/loss/stft_loss.py): spectral convergence ||Y - X||_F / ||Y||_F over the
whole batch, log-magnitude L1, three resolutions averaged.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from fastvocoder_tpu_torch.dsp.stft import stft_mag

# (fft_size, hop_size, win_length): reference stft_loss.py:123-125
DEFAULT_RESOLUTIONS: Tuple[Tuple[int, int, int], ...] = (
    (2048, 240, 1200),
    (1024, 120, 600),
    (512, 50, 240),
)


def spectral_convergence_loss(x_mag: torch.Tensor, y_mag: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(y_mag - x_mag) / torch.linalg.vector_norm(y_mag)


def log_stft_magnitude_loss(x_mag: torch.Tensor, y_mag: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(torch.log(y_mag) - torch.log(x_mag)))


def stft_loss(x: torch.Tensor, y: torch.Tensor, fft_size: int, hop_size: int,
              win_length: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sc, mag) losses of the estimate x against the target y, both (B, T)."""
    x_mag = stft_mag(x, fft_size, hop_size, win_length)
    y_mag = stft_mag(y, fft_size, hop_size, win_length)
    return spectral_convergence_loss(x_mag, y_mag), log_stft_magnitude_loss(x_mag, y_mag)


def multi_resolution_stft_loss(
    x: torch.Tensor, y: torch.Tensor,
    resolutions: Sequence[Tuple[int, int, int]] = DEFAULT_RESOLUTIONS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    sc_total, mag_total = 0.0, 0.0
    for fft_size, hop, win in resolutions:
        sc, mag = stft_loss(x, y, fft_size, hop, win)
        sc_total = sc_total + sc
        mag_total = mag_total + mag
    n = float(len(resolutions))
    return sc_total / n, mag_total / n


def _stft_loss_masked(x, y, valid_samples, fft_size, hop_size, win_length):
    """(sc, mag) over the STFT frames whose centre f * hop lies inside
    `valid_samples` (a scalar or (B,)): a zero-padded utterance scored at
    its true length.  `<=` keeps the boundary frame, so the mask changes
    nothing when valid_samples == T."""
    x_mag = stft_mag(x, fft_size, hop_size, win_length)  # (B, F, bins)
    y_mag = stft_mag(y, fft_size, hop_size, win_length)
    valid = torch.as_tensor(valid_samples, device=x.device).reshape(-1, 1, 1)
    centre = torch.arange(x_mag.shape[1], device=x.device) * hop_size
    m = (centre[None, :, None] <= valid).to(x_mag.dtype)
    sc = torch.linalg.vector_norm((y_mag - x_mag) * m) / torch.clamp(
        torch.linalg.vector_norm(y_mag * m), min=1e-12)
    mag = torch.sum(torch.abs(torch.log(y_mag) - torch.log(x_mag)) * m) / torch.clamp(
        torch.sum(m) * x_mag.shape[-1], min=1.0)
    return sc, mag


def multi_resolution_stft_loss_masked(
    x: torch.Tensor, y: torch.Tensor, valid_samples,
    resolutions: Sequence[Tuple[int, int, int]] = DEFAULT_RESOLUTIONS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Length-masked MR-STFT, for full-utterance validation on padded
    inputs."""
    sc_total, mag_total = 0.0, 0.0
    for fft_size, hop, win in resolutions:
        sc, mag = _stft_loss_masked(x, y, valid_samples, fft_size, hop, win)
        sc_total = sc_total + sc
        mag_total = mag_total + mag
    n = float(len(resolutions))
    return sc_total / n, mag_total / n
