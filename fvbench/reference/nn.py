"""Plain-PyTorch building blocks of the benchmark's reference, channels first.

The reference reads its parameters from a dict keyed as the published
checkpoints name them (`conv_pre.weight`, `up_0.gt`, `msd.disc_0.conv_first.g`,
...): the benchmark makes that dict from the seed (`fvbench/weights.py`) and
hands the same values to the program and to the reference.  A conv with a
gain (`.g`, a transposed conv's `.gt`) is weight-normalised over every axis
but the first, as `torch.nn.utils.weight_norm(dim=0)` does.

It imports nothing of the program and nothing of JAX.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def effective_weight(P: Params, name: str, gain: str = "g") -> torch.Tensor:
    w = P[name + ".weight"]
    g = P.get(f"{name}.{gain}")
    if g is None:
        return w
    norm = torch.sqrt(torch.sum(w * w, dim=tuple(range(1, w.dim()))))
    return w * (g / norm).view(-1, *[1] * (w.dim() - 1))


def conv(x: torch.Tensor, P: Params, name: str, stride: int = 1, padding: int = 0,
         dilation: int = 1, groups: int = 1) -> torch.Tensor:
    """x (B, Cin, T); weight (Cout, Cin // groups, K)."""
    return F.conv1d(x, effective_weight(P, name), P.get(name + ".bias"), stride=stride,
                    padding=padding, dilation=dilation, groups=groups)


def conv_transpose(x: torch.Tensor, P: Params, name: str, stride: int, padding: int,
                   output_padding: int) -> torch.Tensor:
    """x (B, Cin, T); weight (Cin, Cout, K)."""
    return F.conv_transpose1d(x, effective_weight(P, name, "gt"), P.get(name + ".bias"),
                              stride=stride, padding=padding, output_padding=output_padding)


def leaky(x: torch.Tensor, slope: float) -> torch.Tensor:
    return F.leaky_relu(x, slope)


def reflect(x: torch.Tensor, left: int, right: Optional[int] = None) -> torch.Tensor:
    return F.pad(x, (left, left if right is None else right), mode="reflect")


def stft_mag(x: torch.Tensor, fft_size: int, hop: int, win_length: int) -> torch.Tensor:
    """|STFT| of (B, T) -> (B, bins, frames): torch.stft, centred with a
    reflect pad, a periodic Hann window of `win_length` centred in the
    frame; the magnitude clamped at sqrt(1e-7) as FastVocoder's loss and
    MFD clamp it (model/loss/stft_loss.py:37, model/discriminator/mfd.py:40)."""
    window = torch.hann_window(win_length, periodic=True, dtype=x.dtype, device=x.device)
    z = torch.stft(x, fft_size, hop, win_length, window=window, center=True,
                   pad_mode="reflect", return_complex=True)
    return torch.sqrt(torch.clamp(z.real ** 2 + z.imag ** 2, min=1e-7))
