"""FastVocoder's training steps, plain PyTorch (bin/train.py:48-255).

* `pre_adv_step`: generator only; the multi-resolution STFT loss times
  `lamda_stft`, plus for Basis-MelGAN the unscaled L1 of its weights
  against the weight target.
* `gan_step`: the generator update with the MSE-to-ones adversarial loss
  and the feature-map L1 (features of the real waveform without gradient,
  summed over every scale's features but the score and divided by the
  scales times the first scale's feature count, as bin/train.py:100-120
  does), then the discriminator update on the estimate of the *updated*
  generator: MSE of the real scores to 1 and the fake ones to 0.

Both optimisers are Adam (b1 0.9, b2 0.999, eps 1e-6) behind a global-norm
clip at 1.0 (g unchanged below it, g / norm above); Basis-MelGAN's basis is
frozen but its gradient counts in the clip norm.  Written by hand in
float32 from the equations, so that it shares no code with the program.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from fvbench.reference.nn import Params, stft_mag

RESOLUTIONS = ((2048, 240, 1200), (1024, 120, 600), (512, 50, 240))
BETAS, EPS, CLIP = (0.9, 0.999), 1e-6, 1.0
FROZEN = ("basis_signal.",)


def mr_stft_loss(est: torch.Tensor, wav: torch.Tensor) -> torch.Tensor:
    """Spectral convergence plus log-magnitude L1, averaged over the three
    resolutions (FastVocoder model/loss/stft_loss.py)."""
    total = 0.0
    for n_fft, hop, win in RESOLUTIONS:
        x, y = stft_mag(est, n_fft, hop, win), stft_mag(wav, n_fft, hop, win)
        total = total + torch.linalg.vector_norm(y - x) / torch.linalg.vector_norm(y)
        total = total + torch.mean(torch.abs(torch.log(y) - torch.log(x)))
    return total / len(RESOLUTIONS)


@dataclass
class Adam:
    """torch.optim.Adam's update, written out: m, v, bias corrections."""

    lr: float
    m: Dict[str, torch.Tensor] = field(default_factory=dict)
    v: Dict[str, torch.Tensor] = field(default_factory=dict)
    t: int = 0

    @torch.no_grad()
    def step(self, P: Params, grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        b1, b2 = BETAS
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for k, g in grads.items():
            m = self.m.get(k, torch.zeros_like(g)) * b1 + (1 - b1) * g
            v = self.v.get(k, torch.zeros_like(g)) * b2 + (1 - b2) * g * g
            self.m[k], self.v[k] = m, v
            P[k].sub_(self.lr / c1 * m / (torch.sqrt(v) / math.sqrt(c2) + EPS))


def value(t: torch.Tensor) -> float:
    return 0.0 if t.is_meta else float(t.detach())


def clipped(grads: Dict[str, torch.Tensor], counted: List[torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The global-norm clip over `grads` and the extra `counted` gradients."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in list(grads.values()) + counted))
    if not norm.is_meta and norm < CLIP:  # (on the meta device, FLOPs are counted)
        return grads
    return {k: g / norm * CLIP for k, g in grads.items()}


@dataclass
class ReferenceTrainer:
    """The reference's training state and its two steps.  `gen` and `disc`
    hold leaf tensors; `disc_family.forward` gives, per sub-discriminator,
    its features with the score last; `first_grads` keeps each network's
    clipped gradient of the first update, as its optimiser got it."""

    family: object  # the generator's reference module
    disc_family: object  # the discriminator's: `forward(P, wav, disc_cfg)`
    arch: dict
    disc_cfg: dict
    lambda_stft: float
    use_feature_map_loss: bool
    gen: Params
    disc: Params
    lr_g: float = 1e-4
    lr_d: float = 5e-5
    gen_opt: Adam = None
    disc_opt: Adam = None
    first_grads: Dict[str, Dict[str, torch.Tensor]] = field(default_factory=dict)

    def __post_init__(self):
        self.gen_opt = self.gen_opt or Adam(self.lr_g)
        self.disc_opt = self.disc_opt or Adam(self.lr_d)

    def _update(self, which: str, P: Params, opt: Adam, loss: torch.Tensor) -> None:
        names = list(P)
        grads = dict(zip(names, torch.autograd.grad(loss, [P[n] for n in names],
                                                    allow_unused=True)))
        grads = {k: torch.zeros_like(P[k]) if g is None else g for k, g in grads.items()}
        counted = [g for k, g in grads.items() if k.startswith(FROZEN)]
        trained = {k: g for k, g in grads.items() if not k.startswith(FROZEN)}
        trained = clipped(trained, counted)
        if which not in self.first_grads:
            self.first_grads[which] = {k: g.detach().clone() for k, g in trained.items()}
        opt.step(P, trained)

    def pre_adv_step(self, mel, wav, weight: Optional[torch.Tensor] = None) -> Dict[str, float]:
        est, est_weight = self.family.train_forward(self.gen, mel, self.arch)
        total = self.lambda_stft * mr_stft_loss(est, wav)
        if est_weight is not None and weight is not None:
            total = total + torch.mean(torch.abs(est_weight - weight))
        self._update("generator", self.gen, self.gen_opt, total)
        return {"generator": value(total)}

    def gan_step(self, mel, wav) -> Dict[str, float]:
        est, _ = self.family.train_forward(self.gen, mel, self.arch)
        total = self.lambda_stft * mr_stft_loss(est, wav)
        est_p = self.disc_family.forward(self.disc, est, self.disc_cfg)
        total = total + sum(torch.mean((f[-1] - 1.0) ** 2) for f in est_p) / len(est_p)
        if self.use_feature_map_loss:
            with torch.no_grad():
                real_p = self.disc_family.forward(self.disc, wav, self.disc_cfg)
            fm = sum(torch.mean(torch.abs(e - r)) for ef, rf in zip(est_p, real_p)
                     for e, r in zip(ef[:-1], rf[:-1]))
            total = total + fm / (len(est_p) * (len(est_p[0]) - 1))
        self._update("generator", self.gen, self.gen_opt, total)
        del est_p, est
        with torch.no_grad():
            fake, _ = self.family.train_forward(self.gen, mel, self.arch)
        real_p = self.disc_family.forward(self.disc, wav, self.disc_cfg)
        fake_p = self.disc_family.forward(self.disc, fake, self.disc_cfg)
        d_loss = (sum(torch.mean((f[-1] - 1.0) ** 2) for f in real_p)
                  + sum(torch.mean(f[-1] ** 2) for f in fake_p)) / len(real_p)
        self._update("discriminator", self.disc, self.disc_opt, d_loss)
        return {"generator": value(total), "discriminator": value(d_loss)}
