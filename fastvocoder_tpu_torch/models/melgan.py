"""MelGAN generator, channels last (B, T, C).

Counterpart of `fastvocoder_tpu/models/melgan.py` (reference
model/generator/melgan.py:17-185): a reflect pad and `conv_pre`, then per
upsample scale s a leaky(0.2), a transposed conv `up_<i>` (K = 2s, stride s,
padding s // 2 + s % 2, output padding s % 2) and `stacks` ResidualStacks
`stack_<i>_<j>` of dilation K_stack ** j, then `conv_post` (a `LastLayer`)
and tanh: mel (B, T, 80) -> waveform (B, T * prod(scales)).

The stacks of a stage run the residual-stack chain kernels on CUDA (forward,
and backward under autograd) at every width of `conf/melgan/original.yaml`
(256, 128, 64, 32); causal stacks run as library convs
(`models.layers.apply_residual_stacks`), and so does the training form built
with `fused_train=False`.  With `compute_dtype=torch.bfloat16`
it computes in bf16 as the JAX package's does (library convs, the chain
kernel's bf16 form, tanh in bf16), the waveform float32.  Submodules are
named as in the JAX package, so a parameter's path there is its
`state_dict` key here.
"""

from __future__ import annotations

import torch
from torch import nn

from fastvocoder_tpu_torch.hparams import MelGANConfig
from fastvocoder_tpu_torch.models.layers import (
    Conv1d,
    ConvTranspose1d,
    LastLayer,
    ResidualStack,
    apply_residual_stacks,
)
from fastvocoder_tpu_torch.ops.conv import reflect_pad1d
from fastvocoder_tpu_torch.ops.fused_resstack import leaky_relu


class MelGANGenerator(nn.Module):
    def __init__(self, cfg: MelGANConfig, weight_norm: bool = False, compute_dtype=None,
                 fused_train: bool = True):
        super().__init__()
        self.cfg = cfg
        kw = dict(bias=cfg.bias, weight_norm=weight_norm, compute_dtype=compute_dtype)
        self.conv_pre = Conv1d(cfg.in_channels, cfg.channels[0], cfg.kernel_size, **kw)
        self.ups, self.stacks = [], []
        ch = cfg.channels[0]
        for i, scale in enumerate(cfg.upsample_scales):
            cin, ch = ch, cfg.channels[min(i + 1, len(cfg.channels) - 1)]
            up = ConvTranspose1d(cin, ch, kernel_size=scale * 2, stride=scale,
                                 padding=scale // 2 + scale % 2, output_padding=scale % 2, **kw)
            self.add_module(f"up_{i}", up)
            self.ups.append(up)
            group = []
            for j in range(cfg.stacks):
                stack = ResidualStack(ch, kernel_size=cfg.stack_kernel_size,
                                      dilation=cfg.stack_kernel_size ** j,
                                      use_causal_conv=cfg.use_causal_conv,
                                      fused_train=fused_train, **kw)
                self.add_module(f"stack_{i}_{j}", stack)
                group.append(stack)
            self.stacks.append(group)
        self.conv_post = LastLayer(ch, cfg.out_channels, cfg.kernel_size, **kw)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, T, in_channels) -> waveform (B, T * prod(upsample_scales))."""
        x = self.conv_pre(reflect_pad1d(mel, (self.cfg.kernel_size - 1) // 2))
        for up, group in zip(self.ups, self.stacks):
            x = apply_residual_stacks(up(leaky_relu(x)), group)
        return torch.tanh(self.conv_post(x))[..., 0].float()

    def inference(self, mel: torch.Tensor) -> torch.Tensor:
        """The waveform: the plain call, as the JAX package serves MelGAN."""
        return self(mel)
