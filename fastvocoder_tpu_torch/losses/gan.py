"""GAN losses over the composite discriminator's output: per scale a tuple of
per-layer features whose last entry is the score.

Counterpart of `fastvocoder_tpu/losses/gan.py` (the loss math inlined in the
reference trainer, bin/train.py:100-120, 157-169): MSE-to-ones adversarial
loss on each scale's score, L1 feature matching over the other layers
against the real features without gradient, MSE real/fake discriminator
loss; each a mean over scales (and layers).

Each is a mean over the batch's rows (a score or a feature map per row;
the multi-period discriminator folds each row on its own), so under data
parallelism the ranks' mean of their local losses, and of their gradients,
is the global batch's: none needs a collective.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

DiscOut = Sequence[Sequence[torch.Tensor]]


def adversarial_loss(est_p: DiscOut) -> torch.Tensor:
    """mean_i MSE(est_p[i][-1], 1)."""
    total = 0.0
    for feats in est_p:
        total = total + torch.mean(torch.square(feats[-1].float() - 1.0))
    return total / float(len(est_p))


def feature_map_loss(est_p: DiscOut, real_p: DiscOut) -> torch.Tensor:
    """mean_{i, j < last} L1(est_p[i][j], real_p[i][j] without gradient)."""
    total = 0.0
    for est_feats, real_feats in zip(est_p, real_p):
        for e, r in zip(est_feats[:-1], real_feats[:-1]):
            total = total + torch.mean(torch.abs(e.float() - r.detach().float()))
    return total / (float(len(est_p)) * float(len(est_p[0]) - 1))


def discriminator_loss(real_p: DiscOut, fake_p: DiscOut) -> Tuple[torch.Tensor, torch.Tensor]:
    """(real_loss, fake_loss): mean_i MSE(real[i][-1], 1), mean_i
    MSE(fake[i][-1], 0)."""
    real_loss, fake_loss = 0.0, 0.0
    for real_feats, fake_feats in zip(real_p, fake_p):
        real_loss = real_loss + torch.mean(torch.square(real_feats[-1].float() - 1.0))
        fake_loss = fake_loss + torch.mean(torch.square(fake_feats[-1].float()))
    n = float(len(real_p))
    return real_loss / n, fake_loss / n
