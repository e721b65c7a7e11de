"""HiFiGAN's multi-period discriminator.

Counterpart of `fastvocoder_tpu/models/discriminator/mpd.py` (reference
model/discriminator/mpd.py:130-163, 288-304): one discriminator per period
P in (2, 3, 5, 7, 11).  Each reflect-pads the waveform at its end to a
multiple of P, folds it into a (T / P, P) image and runs 2-D convs of
kernel (5, 1) over it: four of stride (3, 1) at the configured widths, one
of stride 1, each followed by leaky(0.1), then `conv_post` (3, 1) to one
channel.  Outputs, as the JAX package's: the five activations, the
`conv_post` map, then that map flattened to (B, H * P, 1), the score.  Maps
are channels last (B, H, P, C), the JAX package's layout; the convs are
cuDNN's.  Submodules are named as in the JAX package (`disc_<i>`,
`conv_<j>`, `conv_post`).  With `compute_dtype` every conv casts its input,
kernel and bias to it (`fastvocoder_tpu/models/discriminator/mpd.py:54-57`).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fastvocoder_tpu_torch.models.layers import _in_compute_dtype, _norm_except, _uniform_
from fastvocoder_tpu_torch.ops.conv import reflect_pad1d
from fastvocoder_tpu_torch.ops.fused_mrf import LRELU_SLOPE
from fastvocoder_tpu_torch.ops.fused_resstack import leaky_relu
from fastvocoder_tpu_torch.ops.precision import check_compute_dtype


class Conv2d(nn.Module):
    """`_WNConv2d`: weight (Cout, Cin, kh, kw), a bias, zero `padding`
    (ph, pw).  With `weight_norm`, `g` (Cout,) scales each output channel
    normalised over (Cin, kh, kw), starting at the norm.  `compute_dtype`:
    the type x, kernel and bias are cast to, as `layers.Conv1d`'s."""

    def __init__(self, cin: int, cout: int, kernel_size: Tuple[int, int],
                 stride: Tuple[int, int] = (1, 1), padding: Tuple[int, int] = (0, 0),
                 weight_norm: bool = True, compute_dtype=None):
        super().__init__()
        self.compute_dtype = check_compute_dtype(compute_dtype)
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.empty(cout, cin, *kernel_size))
        self.bias = nn.Parameter(torch.empty(cout))
        fan_in = cin * kernel_size[0] * kernel_size[1]
        _uniform_(self.weight, fan_in)
        _uniform_(self.bias, fan_in)
        self.g = None
        if weight_norm:
            self.g = nn.Parameter(_norm_except(self.weight.detach(), 0).reshape(cout))

    def effective_weight(self) -> torch.Tensor:
        if self.g is None:
            return self.weight
        return self.weight * (self.g[:, None, None, None] / _norm_except(self.weight, 0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, Cin, H, W) -> (B, Cout, H', W')."""
        x, w, b = _in_compute_dtype(self, self.effective_weight, x)
        return F.conv2d(x, w, b, stride=self.stride, padding=self.padding)


class PeriodDiscriminator(nn.Module):
    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3,
                 channels: Sequence[int] = (32, 128, 512, 1024), compute_dtype=None):
        super().__init__()
        self.period = period
        pad = (kernel_size - 1) // 2
        kw = dict(compute_dtype=compute_dtype)
        self.convs = []
        cin = 1
        for i, ch in enumerate(channels):
            conv = Conv2d(cin, ch, (kernel_size, 1), (stride, 1), (pad, 0), **kw)
            self.add_module(f"conv_{i}", conv)
            self.convs.append(conv)
            cin = ch
        conv = Conv2d(cin, channels[-1], (kernel_size, 1), (1, 1), (pad, 0), **kw)
        self.add_module(f"conv_{len(channels)}", conv)
        self.convs.append(conv)
        self.conv_post = Conv2d(channels[-1], 1, (3, 1), (1, 1), (1, 0), **kw)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """x (B, T, 1) -> the five activations and the `conv_post` map, each
        (B, H, P, C), then the score (B, H * P, 1)."""
        b, t, _ = x.shape
        if t % self.period:
            x = reflect_pad1d(x, (0, self.period - t % self.period))
        h = x.reshape(b, 1, -1, self.period)  # (B, 1, T / P, P)
        outs = []
        for conv in self.convs:
            h = leaky_relu(conv(h), LRELU_SLOPE)
            outs.append(h.permute(0, 2, 3, 1))
        h = self.conv_post(h)
        outs.append(h.permute(0, 2, 3, 1))
        outs.append(h.reshape(b, -1, 1))
        return tuple(outs)


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11),
                 channels: Sequence[int] = (32, 128, 512, 1024), compute_dtype=None):
        super().__init__()
        self.discs = []
        for i, p in enumerate(periods):
            disc = PeriodDiscriminator(p, channels=channels, compute_dtype=compute_dtype)
            self.add_module(f"disc_{i}", disc)
            self.discs.append(disc)

    def forward(self, x: torch.Tensor) -> Tuple[Tuple[torch.Tensor, ...], ...]:
        """x (B, T, 1) -> per period the tuple of features."""
        return tuple(disc(x) for disc in self.discs)
