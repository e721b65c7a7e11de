"""Building blocks of the MelGAN and HiFiGAN families, channels last (B, T, C).

Counterpart of `fastvocoder_tpu/models/layers.py`.  Every conv comes in two
forms.  The fused form (`weight_norm=False`) holds the effective weight:
weight norm is folded in when a checkpoint is loaded
(`fastvocoder_tpu_torch.checkpoint`), as the reference's
`remove_weight_norm()` does before synthesis.  The training form
(`weight_norm=True`) holds the direction `weight` and the gain `g` (`gt` on
a transposed conv) and computes the effective weight `weight * g / |weight|`
in PyTorch on every call, so that autograd carries a kernel's dW back to
both.  Weights are in PyTorch's layout; `ResidualStack.chain_operands`,
`ResBlock1.mrf_operands` and the convs' `tap_major` hand the CUDA kernels
the (tap, c_in, c_out) layout they read: cached and detached where no
gradient is asked for, attached to the graph and built anew where one is.
`ResBlock1.mrf_swapped` hands the MRF kernels the same kernels as
(tap, c_out, c_in), the tensor cores' B operand of a forward conv, cached
the same way.

`compute_dtype` (None, or torch.bfloat16 for bf16 inference and bf16
mixed-precision training) is the JAX package's
(`fastvocoder_tpu/models/layers.py:66-72,174-177`): a conv casts its input,
kernel and bias to it and runs the library conv (cuDNN on the card) in that
type; parameters stay float32 (the cast copies are kept until a parameter
is written, and built on the graph while autograd follows the parameters,
so that their gradients reach the float32 parameters through the casts).
`apply_residual_stacks`, `apply_mrf` and `BasisSignalLayer` hand the
kernels' bf16 forms bf16 activations, as the JAX package casts before its
Pallas calls.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from fastvocoder_tpu_torch.ops.basis_decode import basis_decode
from fastvocoder_tpu_torch.ops.conv import conv1d, conv_transpose1d, reflect_pad1d
from fastvocoder_tpu_torch.ops.fused_mrf import LRELU_SLOPE as MRF_SLOPE
from fastvocoder_tpu_torch.ops.fused_mrf import StageTable, fused_mrf_stage
from fastvocoder_tpu_torch.ops.fused_resstack import (
    ChainTable,
    fused_residual_stacks,
    leaky_relu,
    stack_margin,
)
from fastvocoder_tpu_torch.ops.precision import check_compute_dtype


def _uniform_(t: torch.Tensor, fan_in: int) -> None:
    """torch.nn.Conv1d's default init: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        t.uniform_(-bound, bound)


def _cached(module: nn.Module, build, slot: str = "_cache"):
    """`build()` under no_grad, cached on `module` (in attribute `slot`)
    until one of its parameters is moved or written (keyed on each
    parameter's device, storage and version)."""
    key = tuple((p.device, p.data_ptr(), p._version) for p in module.parameters())
    if key != getattr(module, slot + "_key", None):
        with torch.no_grad():
            setattr(module, slot, build())
        setattr(module, slot + "_key", key)
    return getattr(module, slot)


def _operands(module: nn.Module, build, slot: str = "_cache"):
    """`build()` attached to the graph when autograd wants a gradient of one
    of `module`'s parameters (never cached: the weights move every step),
    else the cached, detached result."""
    if torch.is_grad_enabled() and any(p.requires_grad for p in module.parameters()):
        return build()
    return _cached(module, build, slot)


def _in_compute_dtype(module: nn.Module, weight_fn, x: torch.Tensor):
    """(x, weight, bias) for a conv module's call: cast to its
    `compute_dtype` where it has one (weight and bias kept, `_operands`),
    else as they are."""
    dt = module.compute_dtype
    if dt is None:
        return x, weight_fn(), module.bias
    bias = module.bias
    w, b = _operands(module, lambda: (weight_fn().to(dt), None if bias is None else bias.to(dt)),
                     slot="_cast")
    return x.to(dt), w, b


def _bias_or_zeros(m: nn.Module, n: int) -> torch.Tensor:
    if m.bias is not None:
        return m.bias.contiguous()
    return torch.zeros(n, dtype=m.weight.dtype, device=m.weight.device)


def _norm_except(v: torch.Tensor, dim: int) -> torch.Tensor:
    """|v| over every axis but `dim`, kept for broadcasting."""
    axes = tuple(i for i in range(v.dim()) if i != dim)
    return torch.sqrt(torch.sum(v * v, dim=axes, keepdim=True))


class Conv1d(nn.Module):
    """`WNConv1d`: weight (Cout, Cin // groups, K), optional bias, symmetric
    zero `padding`.  With `weight_norm`, `weight` is the direction and `g`
    (Cout,) the gain: each output channel is normalised over (Cin, K), and
    `g` starts at the norm, so the effective weight starts at `weight`."""

    def __init__(self, cin: int, cout: int, kernel_size: int, dilation: int = 1,
                 bias: bool = True, padding: int = 0, stride: int = 1, groups: int = 1,
                 weight_norm: bool = False, compute_dtype=None):
        super().__init__()
        self.compute_dtype = check_compute_dtype(compute_dtype)
        self.dilation = dilation
        self.padding = padding
        self.stride = stride
        self.groups = groups
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, kernel_size))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None
        fan_in = cin // groups * kernel_size
        _uniform_(self.weight, fan_in)
        if self.bias is not None:
            _uniform_(self.bias, fan_in)
        self.g = None
        if weight_norm:
            self.g = nn.Parameter(_norm_except(self.weight.detach(), 0).reshape(cout))

    def effective_weight(self) -> torch.Tensor:
        if self.g is None:
            return self.weight
        return self.weight * (self.g[:, None, None] / _norm_except(self.weight, 0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w, b = _in_compute_dtype(self, self.effective_weight, x)
        return conv1d(x, w, b, stride=self.stride, padding=self.padding,
                      dilation=self.dilation, groups=self.groups)

    def tap_major(self):
        """(kernel (K, Cin, Cout), bias (Cout,), zeros without one): the
        layout the JAX package and the port's kernels take (`_operands`)."""
        return _operands(self, lambda: (self.effective_weight().permute(2, 1, 0).contiguous(),
                                        _bias_or_zeros(self, self.weight.shape[0])))

    def tap_major_swapped(self) -> torch.Tensor:
        """The kernel as (K, Cout, Cin): `tap_major`'s with its channel axes
        swapped, values only (detached); cached until a parameter is written,
        built anew on every call while autograd follows the weights."""
        return _operands(
            self, lambda: self.effective_weight().detach().permute(2, 0, 1).contiguous(),
            slot="_swapped")


class ConvTranspose1d(nn.Module):
    """`WNConvTranspose1d`: weight (Cin, Cout, K), optional bias, torch
    padding semantics.  With `weight_norm`, the gain `gt` (Cin,) scales each
    *input* channel, normalised over (Cout, K), as torch's weight norm does
    on a transposed conv's weight."""

    def __init__(self, cin: int, cout: int, kernel_size: int, stride: int,
                 padding: int = 0, output_padding: int = 0, bias: bool = True,
                 weight_norm: bool = False, compute_dtype=None):
        super().__init__()
        self.compute_dtype = check_compute_dtype(compute_dtype)
        self.stride = stride
        self.padding = padding
        self.output_padding = output_padding
        self.weight = nn.Parameter(torch.empty(cin, cout, kernel_size))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None
        fan_in = cout * kernel_size  # torch's fan_in for a transposed conv
        _uniform_(self.weight, fan_in)
        if self.bias is not None:
            _uniform_(self.bias, fan_in)
        self.gt = None
        if weight_norm:
            self.gt = nn.Parameter(_norm_except(self.weight.detach(), 0).reshape(cin))

    def effective_weight(self) -> torch.Tensor:
        if self.gt is None:
            return self.weight
        return self.weight * (self.gt[:, None, None] / _norm_except(self.weight, 0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w, b = _in_compute_dtype(self, self.effective_weight, x)
        return conv_transpose1d(x, w, b, stride=self.stride, padding=self.padding,
                                output_padding=self.output_padding)

    def tap_major(self):
        """(kernel (K, Cin, Cout), bias (Cout,), zeros without one)
        (`_operands`)."""
        return _operands(self, lambda: (self.effective_weight().permute(2, 0, 1).contiguous(),
                                        _bias_or_zeros(self, self.weight.shape[1])))


class UpsampleLayer(nn.Module):
    """Nearest-neighbour upsample, then a conv (`conv`): the transposed
    conv's alternative (reference modules.py:135-177)."""

    def __init__(self, cin: int, cout: int, upsample_rate: int, kernel_size: int,
                 bias: bool = True, weight_norm: bool = False, compute_dtype=None):
        super().__init__()
        self.upsample_rate = upsample_rate
        self.conv = Conv1d(cin, cout, kernel_size, bias=bias, padding=kernel_size // 2,
                           weight_norm=weight_norm, compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x.repeat_interleave(self.upsample_rate, dim=1))


class LastLayer(nn.Module):
    """MelGAN's output layer (reference modules.py:76-89): leaky(0.2), a
    reflect pad of (K - 1) // 2, then the conv (the child `conv`)."""

    def __init__(self, cin: int, cout: int, kernel_size: int, bias: bool = True,
                 weight_norm: bool = False, compute_dtype=None):
        super().__init__()
        self.conv = Conv1d(cin, cout, kernel_size, bias=bias, weight_norm=weight_norm,
                           compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pad = (self.conv.weight.shape[-1] - 1) // 2
        return self.conv(reflect_pad1d(leaky_relu(x), pad))


class CausalConv1d(nn.Module):
    """`CausalWNConv1d` (reference modules.py:273-294): the input reflected
    by (K - 1) d rows at its left edge, then the dilated conv, so that
    output t reads rows t - (K - 1) d .. t only.  The JAX package pads
    both edges and keeps the first T outputs, which read no row of the
    right pad: the same function.  The conv is the child `conv`, as the JAX
    tree's `conv_dilated/conv/kernel`."""

    def __init__(self, cin: int, cout: int, kernel_size: int, dilation: int = 1,
                 bias: bool = True, weight_norm: bool = False, compute_dtype=None):
        super().__init__()
        self.pad = (kernel_size - 1) * dilation
        self.conv = Conv1d(cin, cout, kernel_size, dilation=dilation, bias=bias,
                           weight_norm=weight_norm, compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(reflect_pad1d(x, (self.pad, 0)))


class ResidualStack(nn.Module):
    """MelGAN residual stack (reference modules.py:320-382):
    leaky(0.2) -> reflect-pad -> dilated conv -> leaky(0.2) -> 1x1 conv,
    plus a 1x1 skip conv.  With `use_causal_conv` the dilated conv is a
    `CausalConv1d` (left-only reflect pad)."""

    def __init__(self, channels: int, kernel_size: int = 3, dilation: int = 1,
                 bias: bool = True, weight_norm: bool = False, use_causal_conv: bool = False,
                 compute_dtype=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.dilation = dilation
        self.causal = use_causal_conv
        self.compute_dtype = check_compute_dtype(compute_dtype)
        kw = dict(bias=bias, weight_norm=weight_norm, compute_dtype=compute_dtype)
        if use_causal_conv:
            self.conv_dilated = CausalConv1d(channels, channels, kernel_size, dilation=dilation,
                                             **kw)
        else:
            self.conv_dilated = Conv1d(channels, channels, kernel_size, dilation=dilation, **kw)
        self.conv_1x1 = Conv1d(channels, channels, 1, **kw)
        self.skip = Conv1d(channels, channels, 1, **kw)

    def forward(self, c: torch.Tensor) -> torch.Tensor:
        h = leaky_relu(c)
        if not self.causal:
            h = reflect_pad1d(h, stack_margin(self.kernel_size, self.dilation))
        h = self.conv_dilated(h)
        h = leaky_relu(h)
        return self.conv_1x1(h) + self.skip(c)

    def chain_operands(self):
        """(k_dilated (K, C, C), b_d, dilation, k_1x1 (1, C, C), b_1,
        k_skip (1, C, C), b_s): the weights laid out (tap, c_in, c_out) for
        `ops.fused_resstack` (`_operands`).  Non-causal stacks only."""
        return _operands(self, lambda: (*self.conv_dilated.tap_major(), self.dilation,
                                        *self.conv_1x1.tap_major(), *self.skip.tap_major()))


def apply_residual_stacks(x: torch.Tensor, stacks: Sequence[ResidualStack]) -> torch.Tensor:
    """Run a stage's sequential ResidualStacks: the chain kernels on CUDA
    (its backward kernel under autograd), the modules on the CPU.

    Causal stacks compute another function (a left-only reflect pad, which
    the chain kernels do not mirror), so they run as the modules, library
    convs, on every device, as the JAX package runs them as plain XLA convs
    (`use_fused_stacks` refuses them): decided from the stacks'
    configuration before any kernel is tried, never as a fallback from a
    kernel that failed.  Every non-causal width runs the kernels; a width
    outside `ops.fused_resstack.KERNEL_WIDTHS` raises there."""
    if not x.is_cuda or any(m.causal for m in stacks):
        for m in stacks:
            x = m(x)
        return x
    if stacks[0].compute_dtype is not None:  # the kernel's bf16 form
        x = x.to(stacks[0].compute_dtype)
    operands = [m.chain_operands() for m in stacks]
    if torch.is_grad_enabled() and any(p.requires_grad for m in stacks for p in m.parameters()):
        return fused_residual_stacks(x.contiguous(), operands)  # built anew: nothing is kept
    # a served model: the chain's checked and packed operands are kept on its
    # first stack until a stack's operands are rebuilt, one table a type
    key = (x.device, x.dtype, *(id(ops) for ops in operands))
    first = stacks[0]
    if key != getattr(first, "_chain_key", None):
        first._chain_table = ChainTable(operands, x.device, x.dtype)
        first._chain_key = key
    table = first._chain_table
    return fused_residual_stacks(x.contiguous(), table.keep, table)


class ResBlock1(nn.Module):
    """HiFiGAN type-1 MRF block (reference modules.py:190-230): per dilation
    d_i, x += conv2_i(leaky(conv1_i(leaky(x)))), conv1_i dilated by d_i,
    leaky slope 0.1, zero "same" padding."""

    def __init__(self, channels: int, kernel_size: int = 3, dilations: Sequence[int] = (1, 3, 5),
                 bias: bool = True, weight_norm: bool = False, compute_dtype=None):
        super().__init__()
        self.dilations = tuple(dilations)
        self.compute_dtype = check_compute_dtype(compute_dtype)
        self.convs1, self.convs2 = [], []
        for i, d in enumerate(self.dilations):
            c1 = Conv1d(channels, channels, kernel_size, dilation=d, bias=bias,
                        padding=(kernel_size * d - d) // 2, weight_norm=weight_norm,
                        compute_dtype=compute_dtype)
            c2 = Conv1d(channels, channels, kernel_size, bias=bias,
                        padding=(kernel_size - 1) // 2, weight_norm=weight_norm,
                        compute_dtype=compute_dtype)
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
        `ops.fused_mrf` takes; each conv caches its own copy (`_operands`)."""
        return [(*c1.tap_major(), d, *c2.tap_major())
                for c1, c2, d in zip(self.convs1, self.convs2, self.dilations)]

    def mrf_swapped(self):
        """[(k1 (K, Cout, Cin), k2 (K, Cout, Cin))] per pair: what
        `ops.fused_mrf.swap_channels(self.mrf_operands())` would build, kept
        by each conv (`Conv1d.tap_major_swapped`)."""
        return [(c1.tap_major_swapped(), c2.tap_major_swapped())
                for c1, c2 in zip(self.convs1, self.convs2)]

    def kernel_operands(self):
        """(`mrf_operands()`, `mrf_swapped()`) as `apply_mrf` hands them to
        the kernels.  Where no gradient is asked for, both are kept under one
        key over the block's parameters, so that a served model pays for one
        look at its 12 to 18 parameters a call and not for one per conv and
        layout.  Under autograd the operands are built anew and the swapped
        copies are left to the stage, which swaps the operands it is given:
        (operands, None)."""
        params = [p for c in self.convs1 + self.convs2 for p in c._parameters.values()
                  if p is not None]
        if torch.is_grad_enabled() and any(p.requires_grad for p in params):
            return self.mrf_operands(), None
        key = tuple((p.device, p.data_ptr(), p._version) for p in params)
        if key != getattr(self, "_kernel_key", None):
            self._kernel_operands = (self.mrf_operands(), self.mrf_swapped())
            self._kernel_key = key
        return self._kernel_operands


class ResBlock2(nn.Module):
    """HiFiGAN type-2 MRF block (reference modules.py:233-252): per dilation
    d_i, x += conv_i(leaky(x)).  No kernel covers it, in the JAX package
    neither; it runs as modules on every device."""

    def __init__(self, channels: int, kernel_size: int = 3, dilations: Sequence[int] = (1, 3),
                 bias: bool = True, weight_norm: bool = False, compute_dtype=None):
        super().__init__()
        self.convs = []
        for i, d in enumerate(dilations):
            c = Conv1d(channels, channels, kernel_size, dilation=d, bias=bias,
                       padding=(kernel_size * d - d) // 2, weight_norm=weight_norm,
                       compute_dtype=compute_dtype)
            self.add_module(f"conv_{i}", c)
            self.convs.append(c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c in self.convs:
            x = x + c(leaky_relu(x, MRF_SLOPE))
        return x


def apply_mrf(x: torch.Tensor, blocks: Sequence[nn.Module]) -> torch.Tensor:
    """Run an MRF stage, the mean of its blocks: the MRF kernel on CUDA for
    ResBlock1 stages (its backward kernel under autograd), the modules
    otherwise."""
    if x.is_cuda and all(isinstance(b, ResBlock1) for b in blocks):
        if blocks[0].compute_dtype is not None:  # the kernel's bf16 form
            x = x.to(blocks[0].compute_dtype)
        operands, swapped = zip(*(b.kernel_operands() for b in blocks))
        if any(sw is None for sw in swapped):  # autograd follows the weights: nothing is kept
            return fused_mrf_stage(x.contiguous(), list(operands))
        # a served model: the stage's checked table is kept on its first block
        # until a block's operands are rebuilt, one table a type
        key = (x.device, x.dtype, *(id(ops) for ops in operands))
        first = blocks[0]
        if key != getattr(first, "_stage_key", None):
            # (the bf16 form's pack swaps the kernels' channel axes itself)
            sw = list(swapped) if x.dtype == torch.float32 else None
            first._stage_table = StageTable(list(operands), sw, x.device, x.dtype)
            first._stage_key = key
        table = first._stage_table
        return fused_mrf_stage(x.contiguous(), *table.keep, table)
    acc = None
    for b in blocks:
        out = b(x)
        acc = out if acc is None else acc + out
    return acc / len(blocks)


class BasisSignalLayer(nn.Module):
    """Frozen learned-basis decode (reference modules.py:255-267): weights
    (B, F, C) @ basis (L, C)^T, 50 %-overlap-added into (B, (F+1) * L/2).
    `basis` is a parameter, as in the JAX package: no optimiser updates it,
    but in training its gradient counts in the clip norm
    (`train.trainer`)."""

    def __init__(self, L: int, in_features: int = 256):
        super().__init__()
        self.basis = nn.Parameter(torch.zeros(L, in_features))

    def forward(self, weight: torch.Tensor) -> torch.Tensor:
        """-> float32 waveform; bf16 weights (a bf16 model's) are decoded
        with the basis in bf16: a kept copy until the basis is written, or,
        while autograd follows the basis (training: its gradient counts in
        the clip norm), a cast on the graph (`_operands`)."""
        basis = self.basis
        if weight.dtype != basis.dtype:
            basis = _operands(self, lambda: self.basis.to(weight.dtype), slot="_cast")
        return basis_decode(weight.contiguous(), basis)
