"""Multi-resolution STFT reconstruction loss, plain functions on tensors.

Counterpart of `fastvocoder_tpu/losses/stft_loss.py` (reference
model/loss/stft_loss.py): spectral convergence ||Y - X||_F / ||Y||_F over the
whole batch, log-magnitude L1, three resolutions averaged.

Under data parallelism (`dp`, a `parallel.DataParallel` of two or more
ranks) the loss is the global batch's, as the JAX package's mesh computes
it.  The log-magnitude term is a mean over equal shards: the ranks' mean of
their local terms, and of their gradients, is the global one.  Spectral
convergence is not: sqrt(A) / sqrt(B), with A = sum (Y - X)^2 and B = sum
Y^2 over the global batch, and the mean of each rank's gradient of its own
shard's ratio is another gradient (a second-order error where the shards
are alike).  So the global sums are all-reduced (detached, one all-reduce
for every resolution), and each rank's term is W A_r / (2 sqrt(A) sqrt(B)),
A_r its own share of A and W the world size, whose gradient, averaged over
the ranks as every gradient is, is the global ratio's; a detached
correction makes its value the global ratio.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional, Sequence, Tuple

import torch

from fastvocoder_tpu_torch.dsp.stft import stft_mag

if TYPE_CHECKING:
    from fastvocoder_tpu_torch.parallel.distributed import DataParallel

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
    dp: Optional["DataParallel"] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sc, mag) averaged over `resolutions`; with `dp` of two or more ranks,
    the global batch's (module docstring), x and y this rank's rows."""
    n = float(len(resolutions))
    if dp is None or dp.world == 1:
        sc_total, mag_total = 0.0, 0.0
        for fft_size, hop, win in resolutions:
            sc, mag = stft_loss(x, y, fft_size, hop, win)
            sc_total = sc_total + sc
            mag_total = mag_total + mag
        return sc_total / n, mag_total / n
    local, mag_total = [], 0.0
    for fft_size, hop, win in resolutions:
        x_mag = stft_mag(x, fft_size, hop, win_length=win)
        y_mag = stft_mag(y, fft_size, hop, win_length=win)
        local += [torch.sum(torch.square(y_mag - x_mag)), torch.sum(torch.square(y_mag))]
        mag_total = mag_total + log_stft_magnitude_loss(x_mag, y_mag)
    sums = dp.all_reduce_sum(torch.stack(local))  # (A, B) of each resolution, global
    sc_total = 0.0
    for i in range(len(resolutions)):
        root_a, root_b = torch.sqrt(sums[2 * i]), torch.sqrt(sums[2 * i + 1])
        term = dp.world * local[2 * i] / (2.0 * root_a * root_b)
        sc_total = sc_total + term + (root_a / root_b - term).detach()
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
