"""Building blocks of the MelGAN family, channels last (B, T, C).

Counterpart of `fastvocoder_tpu/models/layers.py`, in the fused form only:
weight norm is folded into the weights when a checkpoint is loaded
(`fastvocoder_tpu_torch.checkpoint`), as the reference's
`remove_weight_norm()` does before synthesis.  Weights are in PyTorch's
layout; `ResidualStack.chain_operands` hands the CUDA chain kernel the
(tap, c_in, c_out) layout it reads.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from fastvocoder_tpu_torch.ops.basis_decode import basis_decode
from fastvocoder_tpu_torch.ops.conv import conv1d, conv_transpose1d, reflect_pad1d
from fastvocoder_tpu_torch.ops.fused_resstack import (
    fused_residual_stacks,
    leaky_relu,
    stack_margin,
)


def _uniform_(t: torch.Tensor, fan_in: int) -> None:
    """torch.nn.Conv1d's default init: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        t.uniform_(-bound, bound)


class Conv1d(nn.Module):
    """Fused `WNConv1d`: weight (Cout, Cin, K), optional bias."""

    def __init__(self, cin: int, cout: int, kernel_size: int, dilation: int = 1,
                 bias: bool = True):
        super().__init__()
        self.dilation = dilation
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel_size))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None
        fan_in = cin * kernel_size
        _uniform_(self.weight, fan_in)
        if self.bias is not None:
            _uniform_(self.bias, fan_in)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv1d(x, self.weight, self.bias, dilation=self.dilation)


class ConvTranspose1d(nn.Module):
    """Fused `WNConvTranspose1d`: weight (Cin, Cout, K), optional bias,
    torch padding semantics."""

    def __init__(self, cin: int, cout: int, kernel_size: int, stride: int,
                 padding: int = 0, output_padding: int = 0, bias: bool = True):
        super().__init__()
        self.stride = stride
        self.padding = padding
        self.output_padding = output_padding
        self.weight = nn.Parameter(torch.empty(cin, cout, kernel_size))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None
        fan_in = cout * kernel_size  # torch's fan_in for a transposed conv
        _uniform_(self.weight, fan_in)
        if self.bias is not None:
            _uniform_(self.bias, fan_in)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_transpose1d(x, self.weight, self.bias, stride=self.stride,
                                padding=self.padding,
                                output_padding=self.output_padding)


class ResidualStack(nn.Module):
    """MelGAN residual stack (reference modules.py:320-382):
    leaky(0.2) -> reflect-pad -> dilated conv -> leaky(0.2) -> 1x1 conv,
    plus a 1x1 skip conv."""

    def __init__(self, channels: int, kernel_size: int = 3, dilation: int = 1,
                 bias: bool = True):
        super().__init__()
        self.kernel_size = kernel_size
        self.dilation = dilation
        self.conv_dilated = Conv1d(channels, channels, kernel_size, dilation=dilation, bias=bias)
        self.conv_1x1 = Conv1d(channels, channels, 1, bias=bias)
        self.skip = Conv1d(channels, channels, 1, bias=bias)
        self._operands = None
        self._operands_key = None

    def forward(self, c: torch.Tensor) -> torch.Tensor:
        h = leaky_relu(c)
        h = reflect_pad1d(h, stack_margin(self.kernel_size, self.dilation))
        h = self.conv_dilated(h)
        h = leaky_relu(h)
        return self.conv_1x1(h) + self.skip(c)

    def chain_operands(self):
        """(k_dilated (K, C, C), b_d, dilation, k_1x1 (1, C, C), b_1,
        k_skip (1, C, C), b_s): the weights laid out (tap, c_in, c_out) for
        `ops.fused_resstack`, detached.  Cached until a weight is moved or
        written."""
        convs = (self.conv_dilated, self.conv_1x1, self.skip)
        params = [p for m in convs for p in (m.weight, m.bias) if p is not None]
        key = tuple((p.device, p.data_ptr(), p._version) for p in params)
        if key != self._operands_key:
            with torch.no_grad():
                ops = []
                for m in convs:
                    ops.append(m.weight.detach().permute(2, 1, 0).contiguous())
                    bias = m.bias if m.bias is not None else torch.zeros(
                        m.weight.shape[0], device=m.weight.device)
                    ops.append(bias.detach().contiguous())
            kd, bd, k1, b1, ks, bs = ops
            self._operands = (kd, bd, self.dilation, k1, b1, ks, bs)
            self._operands_key = key
        return self._operands


def apply_residual_stacks(x: torch.Tensor, stacks: Sequence[ResidualStack]) -> torch.Tensor:
    """Run a stage's sequential ResidualStacks: one launch of the chain
    kernel on CUDA (forward only), the modules on the CPU."""
    if not x.is_cuda:
        for m in stacks:
            x = m(x)
        return x
    if torch.is_grad_enabled() and (
        x.requires_grad or any(p.requires_grad for m in stacks for p in m.parameters())
    ):
        raise NotImplementedError(
            "the residual-stack chain kernel is forward only (its backward is "
            "still to be ported, ROADMAP queue B): run inference under "
            "torch.inference_mode() or torch.no_grad()"
        )
    return fused_residual_stacks(x.contiguous(), [m.chain_operands() for m in stacks])


class BasisSignalLayer(nn.Module):
    """Frozen learned-basis decode (reference modules.py:255-267): weights
    (B, F, C) @ basis (L, C)^T, 50 %-overlap-added into (B, (F+1) * L/2)."""

    def __init__(self, L: int, in_features: int = 256):
        super().__init__()
        self.register_buffer("basis", torch.zeros(L, in_features))

    def forward(self, weight: torch.Tensor) -> torch.Tensor:
        return basis_decode(weight.contiguous(), self.basis)
