"""HiFiGAN generator, plain PyTorch (FastVocoder model/generator/hifigan.py).

conv_pre (K = 7, zero pad 3) -> per stage: leaky(0.1), a transposed conv
(stride u, kernel k, padding u // 2 + u % 2, output padding u % 2: u
samples a frame, FastVocoder's rule) and the MRF, the mean of the stage's
type-1 resblocks (per dilation d: x += conv_k(leaky(conv_k,d(leaky(x)))),
slope 0.1, zero "same" pads) -> leaky(0.01) -> conv_post (K = 7) -> tanh.
The width halves every stage.
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import torch

from fvbench.reference.nn import Params, conv, conv_transpose, leaky


def check(arch: dict) -> None:
    if str(arch["resblock_type"]) != "1" or not arch["transposedconv"]:
        raise ValueError("the reference covers type-1 resblocks behind transposed convs")


def param_shapes(arch: dict, in_channels: int = 80) -> Dict[str, Tuple[int, ...]]:
    """Every conv's weight shape by name: (Cout, Cin, K), a transposed
    conv's (Cin, Cout, K)."""
    ch = arch["upsample_initial_channel"]
    shapes = {"conv_pre": (ch, in_channels, 7)}
    for i, (u, k) in enumerate(zip(arch["upsample_rates"], arch["upsample_kernel_sizes"])):
        cin, ch = ch, arch["upsample_initial_channel"] // 2 ** (i + 1)
        shapes[f"up_{i}"] = (cin, ch, k)
        for j, (rk, rd) in enumerate(zip(arch["resblock_kernel_sizes"],
                                         arch["resblock_dilation_sizes"])):
            for p in range(len(rd)):
                shapes[f"resblock_{i}_{j}.conv1_{p}"] = (ch, ch, rk)
                shapes[f"resblock_{i}_{j}.conv2_{p}"] = (ch, ch, rk)
    shapes["conv_post"] = (1, ch, 7)
    return shapes


TRANSPOSED = re.compile(r"up_\d+$")
STREAM = 1  # the seed stream of this network's draw (`fvbench/weights.py`)


def forward(P: Params, mel: torch.Tensor, arch: dict) -> torch.Tensor:
    """mel (B, T, 80) -> waveform (B, T * prod(upsample_rates))."""
    check(arch)
    x = conv(mel.transpose(1, 2), P, "conv_pre", padding=3)
    kernels, dilations = arch["resblock_kernel_sizes"], arch["resblock_dilation_sizes"]
    for i, (u, k) in enumerate(zip(arch["upsample_rates"], arch["upsample_kernel_sizes"])):
        x = conv_transpose(leaky(x, 0.1), P, f"up_{i}", stride=u, padding=u // 2 + u % 2,
                           output_padding=u % 2)
        acc = None
        for j, (rk, rd) in enumerate(zip(kernels, dilations)):
            y = x
            for p, d in enumerate(rd):
                h = conv(leaky(y, 0.1), P, f"resblock_{i}_{j}.conv1_{p}", dilation=d,
                         padding=(rk * d - d) // 2)
                y = y + conv(leaky(h, 0.1), P, f"resblock_{i}_{j}.conv2_{p}",
                             padding=(rk - 1) // 2)
            acc = y if acc is None else acc + y
        x = acc / len(kernels)
    x = conv(leaky(x, 0.01), P, "conv_post", padding=3)
    return torch.tanh(x)[:, 0]


def inference(P: Params, mel: torch.Tensor, arch: dict) -> torch.Tensor:
    """What is served: the plain forward."""
    return forward(P, mel, arch)


def train_forward(P: Params, mel: torch.Tensor, arch: dict):
    """-> (waveform, None): no weight target."""
    return forward(P, mel, arch), None
