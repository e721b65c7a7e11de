"""HiFiGAN generator, channels last (B, T, C).

Counterpart of `fastvocoder_tpu/models/hifigan.py` (reference
model/generator/hifigan.py:13-129): conv_pre (K = 7, zero padding 3) ->
per upsample stage: leaky(0.1), `up_<i>` (a transposed conv, or a
nearest-neighbour upsample and conv), and the MRF, the mean of the stage's
resblocks -> leaky(0.01) -> conv_post (K = 7) -> tanh.  The width halves at
every stage: upsample_initial_channel // 2**(i + 1).

On CUDA, ResBlock1 MRF stages run the MRF kernel (`ops/fused_mrf.py`), and
the last stage runs the tail kernel (`ops/fused_tail.py`) with the output
head whenever the JAX package would fuse it: a transposed conv with stride 2
and ResBlock1 blocks.  A width the kernels do not take raises there.

Submodules are named as in the JAX package (`conv_pre`, `up_<i>`,
`resblock_<i>_<j>`, `conv_post`), so a parameter's path there is its
`state_dict` key here.
"""

from __future__ import annotations

import torch
from torch import nn

from fastvocoder_tpu_torch.hparams import HiFiGANConfig
from fastvocoder_tpu_torch.models.layers import (
    Conv1d,
    ConvTranspose1d,
    ResBlock1,
    ResBlock2,
    UpsampleLayer,
    apply_mrf,
)
from fastvocoder_tpu_torch.ops._build import refuse_autograd
from fastvocoder_tpu_torch.ops.fused_mrf import LRELU_SLOPE
from fastvocoder_tpu_torch.ops.fused_resstack import leaky_relu
from fastvocoder_tpu_torch.ops.fused_tail import HEAD_SLOPE, fused_hifigan_tail_cuda


class HiFiGANGenerator(nn.Module):
    def __init__(self, cfg: HiFiGANConfig, in_channels: int = 80):
        super().__init__()
        self.cfg = cfg
        ch = cfg.upsample_initial_channel
        self.conv_pre = Conv1d(in_channels, ch, 7, bias=cfg.bias, padding=3)
        resblock = ResBlock1 if cfg.resblock_type == "1" else ResBlock2
        self.ups, self.mrfs = [], []
        for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
            cin, ch = ch, cfg.upsample_initial_channel // 2 ** (i + 1)
            if cfg.transposedconv:
                up = ConvTranspose1d(cin, ch, k, stride=u, padding=u // 2 + u % 2,
                                     output_padding=u % 2, bias=cfg.bias)
            else:
                up = UpsampleLayer(cin, ch, upsample_rate=u, kernel_size=k, bias=cfg.bias)
            self.add_module(f"up_{i}", up)
            self.ups.append(up)
            blocks = []
            for j, (rk, rd) in enumerate(zip(cfg.resblock_kernel_sizes,
                                             cfg.resblock_dilation_sizes)):
                block = resblock(ch, kernel_size=rk, dilations=rd, bias=cfg.bias)
                self.add_module(f"resblock_{i}_{j}", block)
                blocks.append(block)
            self.mrfs.append(blocks)
        self.conv_post = Conv1d(ch, cfg.out_bands, 7, bias=cfg.bias, padding=3)
        # the JAX package's tail gate (models/hifigan.py::_use_fused_tail),
        # widths aside: those the kernel does not take raise
        self.tail_fusable = (cfg.transposedconv and cfg.upsample_rates[-1] == 2
                             and cfg.resblock_type == "1")

    def tail_operands(self):
        """The last stage and the head in the form `ops.fused_tail` takes."""
        up = self.ups[-1]
        k_up, b_up = up.tap_major()
        k_post, b_post = self.conv_post.tap_major()
        return (k_up, b_up, up.stride, up.padding,
                [b.mrf_operands() for b in self.mrfs[-1]], k_post, b_post)

    def trunk(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, T, in) -> (B, T * prod(rates), out_bands), after tanh."""
        x = self.conv_pre(mel)
        last = len(self.ups) - 1
        for i, (up, blocks) in enumerate(zip(self.ups, self.mrfs)):
            if i == last and x.is_cuda and self.tail_fusable:
                refuse_autograd("fused_tail", self.parameters())
                return fused_hifigan_tail_cuda(x.contiguous(), *self.tail_operands())
            x = leaky_relu(x, LRELU_SLOPE)
            x = up(x)
            x = apply_mrf(x, blocks)
        x = leaky_relu(x, HEAD_SLOPE)  # the reference's default slope (hifigan.py:104)
        return torch.tanh(self.conv_post(x))

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, T, in) -> waveform (B, T * prod(rates)) for one band, else the
        bands (B, T * prod(rates), out_bands)."""
        x = self.trunk(mel)
        return x[..., 0] if self.cfg.out_bands == 1 else x

    def inference(self, mel: torch.Tensor) -> torch.Tensor:
        """The waveform: the plain call, as the JAX package serves HiFiGAN."""
        return self(mel)
