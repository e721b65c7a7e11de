"""The arithmetic of the bf16 backward kernels (3b, 5b) against a bf16
weight, modelled in plain PyTorch (`fastvocoder_tpu_torch/ops/tf32.py`), on
the CPU.

3b and 5b recompute their stage and run its adjoints in float32 against bf16
weights.  A bf16 value keeps 8 mantissa bits, so it is a TF32 value: the lo
half of its split is zero, and of the three products of 3xTF32 the one
against that half adds exact zeros.  These tests hold that the split of a
bf16 weight has a zero lo half, that the two remaining products,
`lo hi + hi hi`, give the three-product sum bit for bit at the kernels'
widths and tap counts (per unit and summed over units, as the kernels'
core sums them), and record why the weight gradients keep three: there both
operands are float32 intermediates, and two products are far from float32's
accuracy.  No JAX and no GPU are needed.
"""

import numpy as np
import pytest
import torch

from fastvocoder_tpu_torch.ops.tf32 import (
    matmul_2xtf32,
    matmul_2xtf32_units,
    matmul_3xtf32,
    matmul_3xtf32_units,
    split_tf32,
)

WIDTHS = (16, 32, 64, 128, 256)  # every width of the two backward kernels
TAPS = (3, 7, 11)


def _bf16_weight(rows, cols, seed):
    """A kernel at torch's default init scale, rounded to bf16 as training
    in bf16 casts it, widened back to float32."""
    rng = np.random.default_rng(seed)
    bound = 1.0 / np.sqrt(rows)
    w = torch.from_numpy(rng.uniform(-bound, bound, (rows, cols)).astype(np.float32))
    return w.to(torch.bfloat16).float()


def _activations(rows, depth, seed):
    """float32 intermediates as a backward pass holds them (0.3 sigma, every
    mantissa bit in use)."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy((0.3 * rng.standard_normal((rows, depth))).astype(np.float32))


@pytest.mark.parametrize("C", WIDTHS)
def test_a_bf16_weights_split_has_a_zero_lo_half(C):
    w = _bf16_weight(3 * C, C, C)
    hi, lo = split_tf32(w)
    assert torch.equal(hi, w)
    assert torch.equal(lo, torch.zeros_like(w))


@pytest.mark.parametrize("K", TAPS)
@pytest.mark.parametrize("C", WIDTHS)
def test_two_products_are_the_three_product_sum_bit_for_bit(C, K):
    """One unit of the core (the contracted channels of one tap, 16 or 32 of
    them: `Geo::kKC`) and a whole conv summed over its K C / kKC units from
    a bias, as `conv_core` sums them."""
    unit = 16 if C == 16 or C >= 256 else 32
    a = _activations(64, K * C, 100 * C + K)
    w = _bf16_weight(K * C, C, 10 * C + K)
    assert torch.equal(matmul_2xtf32(a[:, :unit], w[:unit]), matmul_3xtf32(a[:, :unit], w[:unit]))
    bias = _activations(1, C, K).expand(64, C).contiguous()
    assert torch.equal(matmul_2xtf32_units(a, w, unit, bias.clone()),
                       matmul_3xtf32_units(a, w, unit, bias.clone()))


# two products of two float32 operands must be at least this much further
# from float64 than the float32 product is (the dropped hi lo term is about
# 2^-11 of each product; of the order of 2^10 in theory)
TWO_PRODUCT_FACTOR = 64.0


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("rows,C", [(32, 256), (32, 64), (32, 16)])
def test_two_products_of_two_float32_operands_are_not_as_close_as_float32(rows, C, seed):
    """A weight gradient's unit, in^T dy over `rows` rows: both operands
    float32 intermediates.  Dropping hi lo there costs accuracy, so the
    weight gradients of 3b and 5b keep all three products."""
    a = _activations(C, rows, seed)       # in^T: (c_in, rows)
    dy = _activations(rows, C, seed + 7)  # dy: (rows, c_out)
    exact = a.double() @ dy.double()
    peak = exact.abs().max().item()
    err_f32 = ((a @ dy).double() - exact).abs().max().item() / peak
    err_2x = (matmul_2xtf32(a, dy).double() - exact).abs().max().item() / peak
    err_3x = (matmul_3xtf32(a, dy).double() - exact).abs().max().item() / peak
    assert err_2x >= TWO_PRODUCT_FACTOR * err_f32
    assert err_3x <= 2 * err_f32 + 2.0 ** -23


@pytest.mark.parametrize("K", TAPS)
@pytest.mark.parametrize("C", (16, 128, 256))
def test_two_products_against_a_bf16_weight_are_as_close_as_float32(C, K):
    """Against a bf16 weight the two products keep 3xTF32's accuracy: as
    close to float64 as the float32 product is."""
    a = _activations(64, K * C, C + K)
    w = _bf16_weight(K * C, C, C - K)
    exact = a.double() @ w.double()
    peak = exact.abs().max().item()
    err_f32 = ((a @ w).double() - exact).abs().max().item() / peak
    err_2x = (matmul_2xtf32(a, w).double() - exact).abs().max().item() / peak
    assert err_2x <= 2 * err_f32 + 2.0 ** -23
