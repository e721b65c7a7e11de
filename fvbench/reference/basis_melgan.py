"""Basis-MelGAN generator, plain PyTorch (FastVocoder
model/generator/basis_melgan.py).

Trunk: reflect pad 3 and conv_pre (K = 7) -> per upsample scale s:
leaky(0.2), a transposed conv (kernel 2s, stride s, padding s // 2 + s % 2,
output padding s % 2) and `stacks` residual stacks of dilation K^j
(leaky(0.2), reflect pad, dilated conv, leaky(0.2), 1x1 conv, plus a 1x1
skip conv of the stack's input) -> ReLU: non-negative basis weights.
Decode: each weight row times the frozen basis (L, C) is a frame of L
samples, the frames overlap-added at hop L / 2.
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from fvbench.reference.nn import Params, conv, conv_transpose, leaky, reflect


def check(arch: dict) -> None:
    if arch["use_causal_conv"] or not arch.get("transposedconv", True):
        raise ValueError("the reference covers non-causal stacks behind transposed convs")


def param_shapes(arch: dict) -> Dict[str, Tuple[int, ...]]:
    """Every conv's weight shape by name, and the basis (L, C)."""
    C, K, sk = arch["channels"], arch["kernel_size"], arch["stack_kernel_size"]
    shapes = {"conv_pre": (C[0], arch["in_channels"], K)}
    for i, s in enumerate(arch["upsample_scales"]):
        shapes[f"up_{i}"] = (C[i], C[i + 1], 2 * s)
        for j in range(arch["stacks"]):
            shapes[f"stack_{i}_{j}.conv_dilated"] = (C[i + 1], C[i + 1], sk)
            shapes[f"stack_{i}_{j}.conv_1x1"] = (C[i + 1], C[i + 1], 1)
            shapes[f"stack_{i}_{j}.skip"] = (C[i + 1], C[i + 1], 1)
    shapes["basis_signal.basis"] = (arch["L"], arch["out_channels"])
    return shapes


TRANSPOSED = re.compile(r"up_\d+$")
STREAM = 2  # the seed stream of this network's draw (`fvbench/weights.py`)


def trunk(P: Params, mel: torch.Tensor, arch: dict) -> torch.Tensor:
    """mel (B, T, 80) -> weights (B, C, T * prod(upsample_scales))."""
    check(arch)
    K = arch["kernel_size"]
    x = conv(reflect(mel.transpose(1, 2), (K - 1) // 2), P, "conv_pre")
    sk = arch["stack_kernel_size"]
    for i, s in enumerate(arch["upsample_scales"]):
        x = conv_transpose(leaky(x, 0.2), P, f"up_{i}", stride=s, padding=s // 2 + s % 2,
                           output_padding=s % 2)
        for j in range(arch["stacks"]):
            d = sk ** j
            h = reflect(leaky(x, 0.2), (sk - 1) // 2 * d)
            h = leaky(conv(h, P, f"stack_{i}_{j}.conv_dilated", dilation=d), 0.2)
            x = conv(h, P, f"stack_{i}_{j}.conv_1x1") + conv(x, P, f"stack_{i}_{j}.skip")
    return torch.relu(x)


def decode(P: Params, weight: torch.Tensor) -> torch.Tensor:
    """weights (B, C, F) -> (B, (F + 1) * L / 2) by overlap-add."""
    basis = P["basis_signal.basis"]  # (L, C)
    L = basis.shape[0]
    frames = torch.einsum("bcf,lc->blf", weight, basis)  # (B, L, F)
    n = (frames.shape[-1] + 1) * (L // 2)
    out = F.fold(frames, output_size=(1, n), kernel_size=(1, L), stride=(1, L // 2))
    return out.reshape(weight.shape[0], n)


def inference(P: Params, mel: torch.Tensor, arch: dict) -> torch.Tensor:
    """What is served: the raw decode, (B, (16 T + 1) * L / 2), untrimmed."""
    return decode(P, trunk(P, mel, arch))


def train_forward(P: Params, mel: torch.Tensor, arch: dict):
    """Training forward with the zero-mel response removed (FastVocoder
    basis_melgan.py:140-162): -> (waveform (B, F * L/2), weights (B, F, C))."""
    zero = trunk(P, torch.zeros_like(mel), arch)
    w = trunk(P, mel, arch)
    n = w.shape[-1] * (P["basis_signal.basis"].shape[0] // 2)
    est = decode(P, w)[:, :n] - decode(P, zero)[:, :n]
    return est, (w - zero).transpose(1, 2)
