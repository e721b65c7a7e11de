"""MelGAN multi-scale discriminator, channels last.

Counterpart of `fastvocoder_tpu/models/discriminator/msd.py` (reference
model/discriminator/msd.py:13-234): identical per-scale discriminators
separated by AvgPool1d(4, 2, 1, count_include_pad=False).  Each scale:
reflect pad and a conv of K = 15, grouped strided downsample convs (stride
and K from the scale, groups = in / 4), two head convs; every layer's
activation is returned.  Submodules are named as in the JAX package
(`disc_<s>`, `conv_first`, `conv_down_<i>`, `conv_head`, `conv_out`).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from fastvocoder_tpu_torch.models.layers import Conv1d
from fastvocoder_tpu_torch.ops.conv import avg_pool1d, reflect_pad1d
from fastvocoder_tpu_torch.ops.fused_resstack import leaky_relu


class ConvStackDiscriminator(nn.Module):
    """The conv stack both discriminator families share: `conv_first`
    (K = k0 * k1 on a reflect-padded input), grouped stride-`ds` downsample
    convs of K = ds * `down_taps` + 1, `conv_head` (K = k0) and `conv_out`
    (K = k1), leaky-relu between them.  -> every layer's output, the score
    last."""

    def __init__(self, in_channels: int, channels: int, max_downsample_channels: int,
                 downsample_scales: Sequence[int], down_taps: int, out_channels: int = 1,
                 kernel_sizes: Sequence[int] = (5, 3), bias: bool = True,
                 negative_slope: float = 0.2, weight_norm: bool = True):
        super().__init__()
        self.negative_slope = negative_slope
        kw = dict(bias=bias, weight_norm=weight_norm)
        k0 = kernel_sizes[0] * kernel_sizes[1]
        self.first_pad = (k0 - 1) // 2
        self.conv_first = Conv1d(in_channels, channels, k0, **kw)
        self.downs = []
        in_chs = channels
        for i, ds in enumerate(downsample_scales):
            out_chs = min(in_chs * ds, max_downsample_channels)
            down = Conv1d(in_chs, out_chs, ds * down_taps + 1, stride=ds,
                          padding=ds * down_taps // 2, groups=in_chs // 4, **kw)
            self.add_module(f"conv_down_{i}", down)
            self.downs.append(down)
            in_chs = out_chs
        out_chs = min(in_chs * 2, max_downsample_channels)
        self.conv_head = Conv1d(in_chs, out_chs, kernel_sizes[0],
                                padding=(kernel_sizes[0] - 1) // 2, **kw)
        self.conv_out = Conv1d(out_chs, out_channels, kernel_sizes[1],
                               padding=(kernel_sizes[1] - 1) // 2, **kw)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        outs = []
        h = leaky_relu(self.conv_first(reflect_pad1d(x, self.first_pad)), self.negative_slope)
        outs.append(h)
        for down in self.downs:
            h = leaky_relu(down(h), self.negative_slope)
            outs.append(h)
        h = leaky_relu(self.conv_head(h), self.negative_slope)
        outs.append(h)
        outs.append(self.conv_out(h))
        return tuple(outs)


class MelGANDiscriminator(ConvStackDiscriminator):
    """One scale of the MSD on a waveform (B, T, 1): downsample convs of
    K = 10 ds + 1, padding 5 ds."""

    def __init__(self, channels: int = 16, max_downsample_channels: int = 1024,
                 downsample_scales: Sequence[int] = (4, 4, 4, 4)):
        super().__init__(1, channels, max_downsample_channels, downsample_scales, down_taps=10)


class MelGANMultiScaleDiscriminator(nn.Module):
    def __init__(self, scales: int = 3, channels: int = 16, max_downsample_channels: int = 1024,
                 downsample_scales: Sequence[int] = (4, 4, 4, 4)):
        super().__init__()
        self.discs = []
        for s in range(scales):
            disc = MelGANDiscriminator(channels, max_downsample_channels, downsample_scales)
            self.add_module(f"disc_{s}", disc)
            self.discs.append(disc)

    def forward(self, x: torch.Tensor) -> Tuple[Tuple[torch.Tensor, ...], ...]:
        """x (B, T, 1) -> per scale the tuple of per-layer features."""
        outs = []
        for disc in self.discs:
            outs.append(disc(x))
            x = avg_pool1d(x, 4, 2, 1, count_include_pad=False)
        return tuple(outs)
