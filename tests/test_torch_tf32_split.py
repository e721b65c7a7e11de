"""The arithmetic of the MRF kernels, 3xTF32, modelled in plain PyTorch
(`fastvocoder_tpu_torch/ops/tf32.py`), on the CPU.

The CUDA kernels contract on the tensor cores, whose TF32 operands keep 10
mantissa bits.  They split every operand into two TF32 halves and sum three
products in float32.  These tests hold the split itself, and record why it is
needed: on an MRF-shaped contraction (one conv of an MRF pair: taps x C
products a row) the 3xTF32 product is as close to a float64 result as a
float32 product is, while one TF32 product is hundreds of times further off,
far outside the 1e-5 a stage is held to.  No JAX and no GPU are needed.
"""

import numpy as np
import pytest
import torch

from fastvocoder_tpu_torch.ops.tf32 import (
    TF32_DROPPED_BITS,
    matmul_3xtf32,
    matmul_tf32,
    round_tf32,
    split_tf32,
)

LOW_BITS = (1 << TF32_DROPPED_BITS) - 1


def _values(seed, n=4096):
    """Seeded float32 values over 12 decades, both signs, and a few exact
    powers of two."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(n) * 10.0 ** rng.uniform(-6, 6, n)
    v[:8] = [1.0, -1.0, 0.5, 3.0, -2.0 ** -20, 2.0 ** 20, 0.0, -0.0]
    return torch.from_numpy(v.astype(np.float32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_halves_are_tf32(seed):
    x = _values(seed)
    hi, lo = split_tf32(x)
    assert hi.dtype == lo.dtype == torch.float32
    assert int((hi.view(torch.int32) & LOW_BITS).abs().max()) == 0
    assert int((lo.view(torch.int32) & LOW_BITS).abs().max()) == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_restores_the_value(seed):
    x = _values(seed)
    hi, lo = split_tf32(x)
    err = (hi.double() + lo.double() - x.double()).abs()
    assert bool(torch.all(err <= 2.0 ** -21 * x.double().abs()))
    # hi is x to nearest: within half a unit of TF32's 10 mantissa bits
    assert bool(torch.all((hi.double() - x.double()).abs() <= 2.0 ** -11 * x.double().abs()))


@pytest.mark.parametrize("seed", [0, 1])
def test_split_is_exact_on_tf32_values(seed):
    x = round_tf32(_values(seed))
    hi, lo = split_tf32(x)
    assert torch.equal(hi, x)
    assert torch.equal(lo, torch.zeros_like(x))


def test_rounding_is_to_nearest_ties_away_from_zero():
    one = np.float32(1.0)
    unit = np.float32(2.0 ** -10)  # TF32's spacing in [1, 2)
    x = torch.tensor([one + unit / 2, -(one + unit / 2), one + unit / 4, one + 3 * unit / 4,
                      one + unit + unit / 2], dtype=torch.float32)
    want = torch.tensor([one + unit, -(one + unit), one, one + unit, one + 2 * unit])
    assert torch.equal(round_tf32(x), want)


def test_rounding_refuses_other_types():
    with pytest.raises(ValueError, match="float32"):
        round_tf32(torch.zeros(3, dtype=torch.float64))


def _contraction(taps, C, seed, rows=64):
    """One conv of an MRF pair as a matrix product: activations (rows,
    taps * C) as the stage sees them (0.3 sigma) against a kernel at torch's
    default init scale."""
    rng = np.random.default_rng(seed)
    a = (0.3 * rng.standard_normal((rows, taps * C))).astype(np.float32)
    bound = 1.0 / np.sqrt(taps * C)
    w = rng.uniform(-bound, bound, (taps * C, C)).astype(np.float32)
    return torch.from_numpy(a), torch.from_numpy(w)


# epsilon: two float32 roundings of the result, for rows where the float32
# product happens to be exact to the last bit
EPS_3X = 2.0 ** -23
# one TF32 product must be at least this much further from float64 than the
# float32 product is (measured: 576 to 1657 on these cases; of the order of 2^10 in theory)
TF32_FACTOR = 256.0


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("taps,C", [(11, 256), (7, 64), (3, 16)])
def test_3xtf32_product_is_as_close_as_float32(taps, C, seed):
    a, w = _contraction(taps, C, seed)
    exact = a.double() @ w.double()
    peak = exact.abs().max().item()
    err_f32 = ((a @ w).double() - exact).abs().max().item() / peak
    err_3x = (matmul_3xtf32(a, w).double() - exact).abs().max().item() / peak
    assert err_3x <= 2 * err_f32 + EPS_3X


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("taps,C", [(11, 256), (7, 64), (3, 16)])
def test_one_tf32_product_is_not(taps, C, seed):
    a, w = _contraction(taps, C, seed)
    exact = a.double() @ w.double()
    peak = exact.abs().max().item()
    err_f32 = ((a @ w).double() - exact).abs().max().item() / peak
    err_1x = (matmul_tf32(a, w).double() - exact).abs().max().item() / peak
    assert err_1x >= TF32_FACTOR * err_f32
    assert err_1x > 1e-5  # outside what a stage's rows are held to
