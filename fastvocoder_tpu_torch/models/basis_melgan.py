"""Basis-MelGAN generator, channels last (B, T, C).

Counterpart of `fastvocoder_tpu/models/basis_melgan.py` (reference
model/generator/basis_melgan.py:19-213): a MelGAN-style trunk with 16x
temporal upsampling, ending in ReLU, predicts non-negative basis weights
(B, T*16, 256); a frozen basis of length L = 30 maps each weight row to a
frame, and the frames are 50 %-overlap-added into the waveform.

The upsamplers are transposed convs, or with `transposedconv: False`
nearest-neighbour upsampling and a conv (`UpsampleLayer`); the stacks run
the chain kernels on CUDA unless `use_causal_conv` asks for causal stacks,
which run as library convs (`models.layers.apply_residual_stacks`).

With `compute_dtype=torch.bfloat16` the trunk computes in bf16 as the JAX
package's does (library convs and the chain kernel's bf16 form), the
decode takes bf16 weights and the basis in bf16 and writes float32
(`fastvocoder_tpu/models/basis_melgan.py:100-135`); parameters stay
float32.

Submodules are named as in the JAX package (`conv_pre`, `up_<i>`,
`stack_<i>_<j>`, `basis_signal`), so a parameter's path there is its
`state_dict` key here.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from fastvocoder_tpu_torch.hparams import BasisMelGANConfig
from fastvocoder_tpu_torch.models.layers import (
    BasisSignalLayer,
    Conv1d,
    ConvTranspose1d,
    ResidualStack,
    UpsampleLayer,
    apply_residual_stacks,
)
from fastvocoder_tpu_torch.ops.conv import reflect_pad1d
from fastvocoder_tpu_torch.ops.fused_resstack import leaky_relu


class BasisMelGANGenerator(nn.Module):
    def __init__(self, cfg: BasisMelGANConfig, weight_norm: bool = False,
                 basis_signal_weight=None, compute_dtype=None, fused_train: bool = True):
        """`basis_signal_weight` (L, out_channels) fills the frozen basis, as
        training from scratch needs; a checkpoint's `load_state_dict` fills
        it otherwise.  `compute_dtype`: None or torch.bfloat16.
        `fused_train=False` runs the training form's stacks as the modules
        (`models.layers.stage_runs_kernels`); the decode is not gated by it,
        as in the JAX package."""
        super().__init__()
        self.cfg = cfg
        kw = dict(bias=cfg.bias, weight_norm=weight_norm, compute_dtype=compute_dtype)
        self.conv_pre = Conv1d(cfg.in_channels, cfg.channels[0], cfg.kernel_size, **kw)
        self.ups = []
        self.stacks = []
        for i, scale in enumerate(cfg.upsample_scales):
            if cfg.transposedconv:
                up = ConvTranspose1d(
                    cfg.channels[i], cfg.channels[i + 1], kernel_size=scale * 2,
                    stride=scale, padding=scale // 2 + scale % 2,
                    output_padding=scale % 2, **kw,
                )
            else:  # nearest-neighbour upsampling and a conv of K = 2s + 1
                up = UpsampleLayer(cfg.channels[i], cfg.channels[i + 1], upsample_rate=scale,
                                   kernel_size=scale * 2 + 1, **kw)
            self.add_module(f"up_{i}", up)
            self.ups.append(up)
            group = []
            for j in range(cfg.stacks):
                stack = ResidualStack(
                    cfg.channels[i + 1], kernel_size=cfg.stack_kernel_size,
                    dilation=cfg.stack_kernel_size ** j,
                    use_causal_conv=cfg.use_causal_conv, fused_train=fused_train, **kw,
                )
                self.add_module(f"stack_{i}_{j}", stack)
                group.append(stack)
            self.stacks.append(group)
        self.basis_signal = BasisSignalLayer(cfg.L, cfg.out_channels)
        if basis_signal_weight is not None:
            with torch.no_grad():
                self.basis_signal.basis.copy_(torch.as_tensor(basis_signal_weight))

    def trunk(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, T, in) -> weights (B, T * prod(scales), out_channels)."""
        x = reflect_pad1d(mel, (self.cfg.kernel_size - 1) // 2)
        x = self.conv_pre(x)
        for up, group in zip(self.ups, self.stacks):
            x = leaky_relu(x)
            x = up(x)
            x = apply_residual_stacks(x, group)
        return torch.relu(x)  # non-negative basis weights

    def forward(self, mel: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Training forward with zero-input bias removal (reference
        basis_melgan.py:140-162): -> (est_source (B, T*hop), weight
        (B, T*16, C)), both with the zero-mel response subtracted."""
        half_l = self.cfg.L // 2
        zero_weight = self.trunk(torch.zeros_like(mel))
        zero_source = self.basis_signal(zero_weight)[:, : zero_weight.shape[1] * half_l]
        weight = self.trunk(mel)
        est_source = self.basis_signal(weight)[:, : weight.shape[1] * half_l]
        return est_source - zero_source, (weight - zero_weight).float()

    def inference(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, T, in) -> (B, (T*16 - 1) * L/2 + L) raw waveform: no bias
        removal, no trim (reference basis_melgan.py:196-208)."""
        return self.basis_signal(self.trunk(mel))

    def decode(self, weight: torch.Tensor) -> torch.Tensor:
        """Decode precomputed weights (reference basis_melgan.py:210-212)."""
        return self.basis_signal(weight)
