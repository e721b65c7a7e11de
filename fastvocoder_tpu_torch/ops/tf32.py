"""A plain PyTorch model of the tensor-core kernels' arithmetic: 3xTF32.

The CUDA kernels of `csrc/fused_mrf.cu`, `csrc/fused_mrf_bwd.cu`,
`csrc/fused_resstack.cu` and `csrc/fused_resstack_bwd.cu` contract on the
tensor cores, whose TF32 operands keep 10 of float32's 23 mantissa
bits.  To keep float32 accuracy they split every operand `a = hi + lo`, both
TF32 (hi rounded to nearest; lo = a - hi as the tensor core reads it, its 13
low mantissa bits ignored), and sum `lo hi + hi lo + hi hi` in float32;
`lo lo`, 2^-22 of the product, is dropped (`csrc/mma_common.cuh`).  The
functions here do the same on any device with integer operations on the
floats' bits, so that the kernels' tolerance can be argued, and tested,
without a GPU (`tests/test_torch_tf32_split.py`,
`tests/test_torch_resstack_tf32.py`).  Nothing on a model's path
calls them.

The bf16 backward forms (kernels 3b and 5b) multiply float32 activations by
bf16 weights.  A bf16 value (8 mantissa bits) is a TF32 value, so the lo half
of the weight's split is zero and `hi lo` adds nothing: they sum the two
products `lo hi + hi hi` (`matmul_2xtf32`), the same sum bit for bit.  Their
weight gradients contract two float32 intermediates, whose lo halves are not
zero, and keep three (`tests/test_torch_bf16_bwd_split.py`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

TF32_DROPPED_BITS = 13  # float32 has 23 mantissa bits, TF32 keeps 10


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x (float32) rounded to TF32 as `cvt.rna.tf32.f32` does: to nearest,
    ties away from zero; the 13 low mantissa bits of the result are zero.
    Finite values only."""
    if x.dtype != torch.float32:
        raise ValueError(f"round_tf32: want float32, got {x.dtype}")
    bits = x.contiguous().view(torch.int32)
    # sign and magnitude: adding half a unit of the kept precision to the
    # bit pattern rounds the magnitude, whatever the sign
    half = 1 << (TF32_DROPPED_BITS - 1)
    mask = ~((1 << TF32_DROPPED_BITS) - 1)
    return ((bits + half) & mask).view(torch.float32)


def truncate_tf32(x: torch.Tensor) -> torch.Tensor:
    """x (float32) as a tensor core reads a TF32 operand that was not
    converted: the 13 low mantissa bits dropped."""
    if x.dtype != torch.float32:
        raise ValueError(f"truncate_tf32: want float32, got {x.dtype}")
    mask = ~((1 << TF32_DROPPED_BITS) - 1)
    return (x.contiguous().view(torch.int32) & mask).view(torch.float32)


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo), both TF32, with hi + lo = x up to 2^-21 |x|: hi is x to
    nearest, lo the exact rest x - hi cut to TF32, as the kernels split."""
    hi = round_tf32(x)
    return hi, truncate_tf32(x - hi)


def matmul_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with both operands rounded to TF32 and float32 sums: what one
    tensor-core product gives."""
    return round_tf32(a) @ round_tf32(b)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernels compute it: the two cross terms, then the main
    term, summed in float32."""
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def matmul_2xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the bf16 backward forms compute it against a bf16 weight b:
    `lo hi + hi hi` in float32, the split of b taken as its hi half alone.
    On a b whose values are TF32 (a bf16 weight widened) this is
    `matmul_3xtf32` bit for bit."""
    a_hi, a_lo = split_tf32(a)
    b_hi = round_tf32(b)
    return a_lo @ b_hi + a_hi @ b_hi


def matmul_3xtf32_units(a: torch.Tensor, b: torch.Tensor, unit: int,
                        acc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """acc + a @ b as a kernel's core sums it over a long depth: the depth in
    units of `unit` (the contracted channels of one tap a weight unit holds,
    or the rows of one batch of a weight gradient), each unit's 3xTF32
    product summed from zero and added to the float32 accumulator in order;
    acc starts at zero, or at the given bias or partial result."""
    return _units(matmul_3xtf32, a, b, unit, acc)


def matmul_2xtf32_units(a: torch.Tensor, b: torch.Tensor, unit: int,
                        acc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`matmul_3xtf32_units` with each unit's product `matmul_2xtf32`: a
    recompute or adjoint pass of the bf16 backward forms."""
    return _units(matmul_2xtf32, a, b, unit, acc)


def _units(product, a: torch.Tensor, b: torch.Tensor, unit: int,
           acc: Optional[torch.Tensor]) -> torch.Tensor:
    if acc is None:
        acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for k0 in range(0, a.shape[1], unit):
        acc = acc + product(a[:, k0:k0 + unit], b[k0:k0 + unit])
    return acc
