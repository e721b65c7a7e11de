"""Building blocks of the MelGAN and HiFiGAN families, channels last (B, T, C).

Counterpart of `fastvocoder_tpu/models/layers.py`, in the fused form only:
weight norm is folded into the weights when a checkpoint is loaded
(`fastvocoder_tpu_torch.checkpoint`), as the reference's
`remove_weight_norm()` does before synthesis.  Weights are in PyTorch's
layout; `ResidualStack.chain_operands`, `ResBlock1.mrf_operands` and the
convs' `tap_major` hand the CUDA kernels the (tap, c_in, c_out) layout they
read.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from fastvocoder_tpu_torch.ops._build import refuse_autograd
from fastvocoder_tpu_torch.ops.basis_decode import basis_decode
from fastvocoder_tpu_torch.ops.conv import conv1d, conv_transpose1d, reflect_pad1d
from fastvocoder_tpu_torch.ops.fused_mrf import LRELU_SLOPE as MRF_SLOPE
from fastvocoder_tpu_torch.ops.fused_mrf import fused_mrf_stage
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


def _cached(module: nn.Module, build):
    """`build()`, cached on `module` until one of its parameters is moved or
    written (keyed on each parameter's device, storage and version)."""
    key = tuple((p.device, p.data_ptr(), p._version) for p in module.parameters())
    if key != getattr(module, "_cache_key", None):
        with torch.no_grad():
            module._cache = build()
        module._cache_key = key
    return module._cache


def _bias_or_zeros(m: nn.Module, n: int) -> torch.Tensor:
    if m.bias is not None:
        return m.bias.detach().contiguous()
    return torch.zeros(n, dtype=m.weight.dtype, device=m.weight.device)


class Conv1d(nn.Module):
    """Fused `WNConv1d`: weight (Cout, Cin, K), optional bias, symmetric
    zero `padding`."""

    def __init__(self, cin: int, cout: int, kernel_size: int, dilation: int = 1,
                 bias: bool = True, padding: int = 0):
        super().__init__()
        self.dilation = dilation
        self.padding = padding
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel_size))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None
        fan_in = cin * kernel_size
        _uniform_(self.weight, fan_in)
        if self.bias is not None:
            _uniform_(self.bias, fan_in)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv1d(x, self.weight, self.bias, padding=self.padding, dilation=self.dilation)

    def tap_major(self):
        """(kernel (K, Cin, Cout), bias (Cout,), zeros without one): the
        layout the JAX package and the port's kernels take, detached and
        cached."""
        return _cached(self, lambda: (self.weight.detach().permute(2, 1, 0).contiguous(),
                                      _bias_or_zeros(self, self.weight.shape[0])))


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

    def tap_major(self):
        """(kernel (K, Cin, Cout), bias (Cout,), zeros without one),
        detached and cached."""
        return _cached(self, lambda: (self.weight.detach().permute(2, 0, 1).contiguous(),
                                      _bias_or_zeros(self, self.weight.shape[1])))


class UpsampleLayer(nn.Module):
    """Nearest-neighbour upsample, then a conv (`conv`): the transposed
    conv's alternative (reference modules.py:135-177)."""

    def __init__(self, cin: int, cout: int, upsample_rate: int, kernel_size: int,
                 bias: bool = True):
        super().__init__()
        self.upsample_rate = upsample_rate
        self.conv = Conv1d(cin, cout, kernel_size, bias=bias, padding=kernel_size // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x.repeat_interleave(self.upsample_rate, dim=1))


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
        return _cached(self, lambda: (*self.conv_dilated.tap_major(), self.dilation,
                                      *self.conv_1x1.tap_major(), *self.skip.tap_major()))


def apply_residual_stacks(x: torch.Tensor, stacks: Sequence[ResidualStack]) -> torch.Tensor:
    """Run a stage's sequential ResidualStacks: one launch of the chain
    kernel on CUDA (forward only), the modules on the CPU."""
    if not x.is_cuda:
        for m in stacks:
            x = m(x)
        return x
    refuse_autograd("fused_resstack", [x] + [p for m in stacks for p in m.parameters()])
    return fused_residual_stacks(x.contiguous(), [m.chain_operands() for m in stacks])


class ResBlock1(nn.Module):
    """HiFiGAN type-1 MRF block (reference modules.py:190-230): per dilation
    d_i, x += conv2_i(leaky(conv1_i(leaky(x)))), conv1_i dilated by d_i,
    leaky slope 0.1, zero "same" padding."""

    def __init__(self, channels: int, kernel_size: int = 3, dilations: Sequence[int] = (1, 3, 5),
                 bias: bool = True):
        super().__init__()
        self.dilations = tuple(dilations)
        self.convs1, self.convs2 = [], []
        for i, d in enumerate(self.dilations):
            c1 = Conv1d(channels, channels, kernel_size, dilation=d, bias=bias,
                        padding=(kernel_size * d - d) // 2)
            c2 = Conv1d(channels, channels, kernel_size, bias=bias,
                        padding=(kernel_size - 1) // 2)
            self.add_module(f"conv1_{i}", c1)
            self.add_module(f"conv2_{i}", c2)
            self.convs1.append(c1)
            self.convs2.append(c2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c1, c2 in zip(self.convs1, self.convs2):
            h = c2(leaky_relu(c1(leaky_relu(x, MRF_SLOPE)), MRF_SLOPE))
            x = x + h
        return x

    def mrf_operands(self):
        """[(k1 (K, C, C), b1, dilation, k2 (K, C, C), b2)] per pair: the form
        `ops.fused_mrf` takes, detached; each conv caches its own copy."""
        return [(*c1.tap_major(), d, *c2.tap_major())
                for c1, c2, d in zip(self.convs1, self.convs2, self.dilations)]


class ResBlock2(nn.Module):
    """HiFiGAN type-2 MRF block (reference modules.py:233-252): per dilation
    d_i, x += conv_i(leaky(x)).  No kernel covers it, in the JAX package
    neither; it runs as modules on every device."""

    def __init__(self, channels: int, kernel_size: int = 3, dilations: Sequence[int] = (1, 3),
                 bias: bool = True):
        super().__init__()
        self.convs = []
        for i, d in enumerate(dilations):
            c = Conv1d(channels, channels, kernel_size, dilation=d, bias=bias,
                       padding=(kernel_size * d - d) // 2)
            self.add_module(f"conv_{i}", c)
            self.convs.append(c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c in self.convs:
            x = x + c(leaky_relu(x, MRF_SLOPE))
        return x


def apply_mrf(x: torch.Tensor, blocks: Sequence[nn.Module]) -> torch.Tensor:
    """Run an MRF stage, the mean of its blocks: one call of the MRF kernel
    on CUDA for ResBlock1 stages (forward only), the modules otherwise."""
    if x.is_cuda and all(isinstance(b, ResBlock1) for b in blocks):
        refuse_autograd("fused_mrf", [x] + [p for b in blocks for p in b.parameters()])
        return fused_mrf_stage(x.contiguous(), [b.mrf_operands() for b in blocks])
    acc = None
    for b in blocks:
        out = b(x)
        acc = out if acc is None else acc + out
    return acc / len(blocks)


class BasisSignalLayer(nn.Module):
    """Frozen learned-basis decode (reference modules.py:255-267): weights
    (B, F, C) @ basis (L, C)^T, 50 %-overlap-added into (B, (F+1) * L/2)."""

    def __init__(self, L: int, in_features: int = 256):
        super().__init__()
        self.register_buffer("basis", torch.zeros(L, in_features))

    def forward(self, weight: torch.Tensor) -> torch.Tensor:
        return basis_decode(weight.contiguous(), self.basis)
