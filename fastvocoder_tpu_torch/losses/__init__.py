"""Loss functions: MR-STFT reconstruction and the GAN losses.

`reconstruction_loss` is the counterpart of
`fastvocoder_tpu/losses/__init__.py` (the reference's top-level Loss module,
model/loss/loss.py:7-42): full-band MR-STFT with Basis-MelGAN's optional
weight L1, or, given a PQMF, the mean of the sub-band and full-band MR-STFT
losses.

Under data parallelism (`dp`) the MR-STFT losses, the sub-band one
included, are the global batch's (`losses/stft_loss.py`).  The weight L1 is
a mean over equal shards, so the ranks' mean of their local values and
gradients is the global one, and it needs no collective; so are the GAN
losses (`losses/gan.py`).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional, Tuple

import torch

from fastvocoder_tpu_torch.losses.gan import (
    adversarial_loss,
    discriminator_loss,
    feature_map_loss,
)
from fastvocoder_tpu_torch.losses.stft_loss import (
    DEFAULT_RESOLUTIONS,
    multi_resolution_stft_loss,
    multi_resolution_stft_loss_masked,
    stft_loss,
)
from fastvocoder_tpu_torch.ops.pqmf import PQMF

if TYPE_CHECKING:
    from fastvocoder_tpu_torch.parallel.distributed import DataParallel

__all__ = [
    "DEFAULT_RESOLUTIONS",
    "adversarial_loss",
    "discriminator_loss",
    "feature_map_loss",
    "multi_resolution_stft_loss",
    "multi_resolution_stft_loss_masked",
    "reconstruction_loss",
    "reconstruction_loss_masked",
    "stft_loss",
]


def _bands_to_rows(x: torch.Tensor) -> torch.Tensor:
    """(B, T', S) -> (B * S, T'), the reference's view(-1, T') of a
    (B, S, T') tensor."""
    return x.transpose(1, 2).reshape(-1, x.shape[1])


def reconstruction_loss(
    est_source: torch.Tensor,
    wav: torch.Tensor,
    est_weight: Optional[torch.Tensor] = None,
    weight: Optional[torch.Tensor] = None,
    pqmf: Optional[PQMF] = None,
    dp: Optional["DataParallel"] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """-> (stft_loss, weight_loss or None); with `dp`, of the global batch
    (module docstring).

    Full band (reference loss.py:33-42): est_source and wav are (B, T).
    Multiband (reference loss.py:16-31): est_source is the sub-band signal
    (B, T', S); the real wav is PQMF-analysed, the estimate PQMF-synthesised,
    and the MR-STFT losses of both domains are averaged.
    """
    wav = wav.detach()
    if pqmf is not None:
        wav_sub = pqmf.analysis(wav[..., None])  # (B, T', S)
        est_full = pqmf.synthesis(est_source)[..., 0]  # (B, T)
        sc_s, mag_s = multi_resolution_stft_loss(_bands_to_rows(est_source),
                                                 _bands_to_rows(wav_sub), dp=dp)
        sc_f, mag_f = multi_resolution_stft_loss(est_full, wav, dp=dp)
        return ((sc_s + mag_s) + (sc_f + mag_f)) / 2.0, None

    sc, mag = multi_resolution_stft_loss(est_source, wav, dp=dp)
    weight_loss = None
    if est_weight is not None and weight is not None:
        weight_loss = torch.mean(torch.abs(est_weight.float() - weight.float()))
    return sc + mag, weight_loss


def reconstruction_loss_masked(est_source: torch.Tensor, wav: torch.Tensor, valid_samples,
                               pqmf: Optional[PQMF] = None) -> torch.Tensor:
    """`reconstruction_loss` over the first `valid_samples` samples only, for
    full-utterance validation on padded inputs."""
    wav = wav.detach()
    if pqmf is not None:
        wav_sub = pqmf.analysis(wav[..., None])
        est_full = pqmf.synthesis(est_source)[..., 0]
        sub_valid = torch.as_tensor(valid_samples) // pqmf.subbands
        sc_s, mag_s = multi_resolution_stft_loss_masked(
            _bands_to_rows(est_source), _bands_to_rows(wav_sub), sub_valid)
        sc_f, mag_f = multi_resolution_stft_loss_masked(est_full, wav, valid_samples)
        return ((sc_s + mag_s) + (sc_f + mag_f)) / 2.0
    sc, mag = multi_resolution_stft_loss_masked(est_source, wav, valid_samples)
    return sc + mag
