"""FastVocoder's composite discriminator, plain PyTorch: MelGAN's multi-scale
discriminator (model/discriminator/msd.py) followed by the multi-resolution
STFT discriminator (mfd.py).  Every conv is weight-normalised.

One conv stack (`stack`), on (B, Cin, T): reflect pad and conv_first
(K = k0 k1 = 15), grouped stride-ds downsample convs (K = ds * taps + 1,
padding ds * taps // 2, groups Cin // 4), conv_head (K = 5), conv_out
(K = 3), leaky(0.2) after all but the last; every layer's output is a
feature, the last is the score.  The MSD runs three such stacks (taps 10)
on the waveform, average-pooled (4, 2, 1, not counting the pad) between
scales; the MFD runs one (taps 6) per resolution on the magnitude STFT,
its bins as channels.

The discriminator's reference of a configuration that names none
(`disc_reference`).  Another one offers what this module offers:
`param_shapes(disc_cfg)`, `forward(P, wav, disc_cfg)` returning per
sub-discriminator a tuple of its features with the score last,
`TRANSPOSED` and `STREAM`.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from fvbench.reference.nn import Params, conv, leaky, reflect, stft_mag

Features = Tuple[torch.Tensor, ...]


def _stack_shapes(prefix: str, cin: int, channels: int, max_channels: int,
                  downsample_scales: Sequence[int], taps: int) -> Dict[str, Tuple[int, ...]]:
    shapes = {prefix + "conv_first": (channels, cin, 15)}
    c = channels
    for i, ds in enumerate(downsample_scales):
        out = min(c * ds, max_channels)
        shapes[f"{prefix}conv_down_{i}"] = (out, 4, ds * taps + 1)
        c = out
    out = min(c * 2, max_channels)
    shapes[prefix + "conv_head"] = (out, c, 5)
    shapes[prefix + "conv_out"] = (1, out, 3)
    return shapes


def param_shapes(disc: dict) -> Dict[str, Tuple[int, ...]]:
    """Every conv's weight shape by name: (Cout, Cin / groups, K)."""
    shapes = {}
    for s in range(disc["msd_scales"]):
        shapes.update(_stack_shapes(f"msd.disc_{s}.", 1, disc["msd_channels"],
                                    disc["msd_max_channels"], disc["msd_downsample_scales"], 10))
    for i, n_fft in enumerate(disc["mfd_fft_sizes"]):
        shapes.update(_stack_shapes(f"mfd.disc_{i}.", n_fft // 2 + 1, disc["mfd_channels"],
                                    disc["mfd_max_channels"], disc["mfd_downsample_scales"], 6))
    return shapes


TRANSPOSED = None
STREAM = 3  # the seed stream of this network's draw (`fvbench/weights.py`)


def stack(P: Params, prefix: str, x: torch.Tensor, downsample_scales: Sequence[int],
          taps: int) -> Features:
    outs: List[torch.Tensor] = []
    h = leaky(conv(reflect(x, 7), P, prefix + "conv_first"), 0.2)
    outs.append(h)
    for i, ds in enumerate(downsample_scales):
        h = leaky(conv(h, P, f"{prefix}conv_down_{i}", stride=ds, padding=ds * taps // 2,
                       groups=h.shape[1] // 4), 0.2)
        outs.append(h)
    h = leaky(conv(h, P, prefix + "conv_head", padding=2), 0.2)
    outs.append(h)
    outs.append(conv(h, P, prefix + "conv_out", padding=1))
    return tuple(outs)


def forward(P: Params, wav: torch.Tensor, disc: dict) -> Tuple[Features, ...]:
    """wav (B, T) -> per scale, then per resolution, its features."""
    outs = []
    x = wav[:, None, :]
    for s in range(disc["msd_scales"]):
        outs.append(stack(P, f"msd.disc_{s}.", x, disc["msd_downsample_scales"], 10))
        x = F.avg_pool1d(x, 4, 2, 1, count_include_pad=False)
    for i, (n_fft, hop, win) in enumerate(zip(disc["mfd_fft_sizes"], disc["mfd_hop_sizes"],
                                              disc["mfd_win_lengths"])):
        outs.append(stack(P, f"mfd.disc_{i}.", stft_mag(wav, n_fft, hop, win),
                          disc["mfd_downsample_scales"], 6))
    return tuple(outs)
