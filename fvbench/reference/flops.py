"""Model FLOPs of the reference, counted by `torch.utils.flop_counter` on the
meta device at a cell's shapes (the FFTs of the STFTs are not counted: the
counter has no formula for them, so the counts are a lower bound there).

The counts come from the benchmark's own reference, never from the
program, so a kernel that is renamed, replaced or does more work than the
model needs does not change them.  `FlopCounterMode` counts a conv as
2 * output elements * (Cin / groups) * K, a transposed conv likewise on
its input, and the backward of each as the two products autograd runs.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from fvbench.weights import meta_params


def _count(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())


def forward_flops(family, arch: dict, rows: int, frames: int) -> int:
    """FLOPs of the served forward over (rows, frames) mels."""
    P = meta_params(family, arch, weight_norm=False)
    mel = torch.empty(rows, frames, 80, device="meta")
    return _count(lambda: family.inference(P, mel, arch))


def per_frame(family, arch: dict):
    """(a, b): the served forward of one row of T frames costs a T + b FLOPs
    (every layer is a conv over time, so the count is affine in T)."""
    f1, f2 = forward_flops(family, arch, 1, 64), forward_flops(family, arch, 1, 128)
    a = (f2 - f1) / 64
    return a, f1 - 64 * a


def train_step_flops(trainer_cls, family, disc_family, arch: dict, disc_cfg: dict, step: str,
                     rows: int, frames: int, hop: int, lambda_stft: float, use_fm: bool,
                     weight_channels: int = 0) -> int:
    """FLOPs of one reference training step (`step`: "gan_step" or
    "pre_adv_step") of generator `family` against discriminator
    `disc_family` (reference modules) over `rows` crops of `frames` frames,
    forward and backward, on the meta device."""
    gen = meta_params(family, arch, weight_norm=True, grad=True)
    disc = (meta_params(disc_family, disc_cfg, weight_norm=True, grad=True)
            if step == "gan_step" else {})
    tr = trainer_cls(family=family, disc_family=disc_family, arch=arch, disc_cfg=disc_cfg,
                     lambda_stft=lambda_stft, use_feature_map_loss=use_fm, gen=gen, disc=disc)
    mel = torch.empty(rows, frames, 80, device="meta")
    wav = torch.empty(rows, frames * hop, device="meta")
    if step == "gan_step":
        return _count(lambda: tr.gan_step(mel, wav))
    weight = None
    if weight_channels:
        weight = torch.empty(rows, frames * 16, weight_channels, device="meta")
    return _count(lambda: tr.pre_adv_step(mel, wav, weight))
