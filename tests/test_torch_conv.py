"""The port's conv primitives (`fastvocoder_tpu_torch/ops/conv.py`) against
the JAX package's (`fastvocoder_tpu/ops/conv.py`), on the CPU.

Same seeded numpy inputs into both; JAX kernels (K, Cin, Cout) map to torch
weights by permute(2, 1, 0) for a conv and permute(1, 2, 0) for a
transposed conv.  Tolerance: float32 summation order over at most 48 terms
of unit-scale products, so 1e-5 absolute and relative; reflect padding is a
gather and must match exactly.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fastvocoder_tpu.ops import conv as jconv
from fastvocoder_tpu_torch.ops import conv as tconv


@pytest.mark.parametrize(
    "K,dilation,padding,stride",
    [(3, 1, 1, 1), (3, 3, 0, 1), (7, 1, (3, 3), 1), (5, 2, (1, 4), 1), (4, 1, 0, 2)],
)
def test_conv1d_matches_jax(K, dilation, padding, stride):
    rng = np.random.default_rng(K * 10 + dilation)
    x = rng.standard_normal((2, 37, 6)).astype(np.float32)
    k = rng.standard_normal((K, 6, 8)).astype(np.float32)
    b = rng.standard_normal((8,)).astype(np.float32)
    want = np.asarray(jconv.conv1d(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b),
                                   stride=stride, padding=padding, dilation=dilation))
    got = tconv.conv1d(torch.from_numpy(x), torch.from_numpy(k).permute(2, 1, 0),
                       torch.from_numpy(b), stride=stride, padding=padding,
                       dilation=dilation)
    assert got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("K,stride,padding,output_padding", [(8, 4, 2, 0), (4, 2, 1, 0), (3, 2, 1, 1)])
def test_conv_transpose1d_matches_jax(K, stride, padding, output_padding):
    rng = np.random.default_rng(K + stride)
    x = rng.standard_normal((2, 11, 6)).astype(np.float32)
    k = rng.standard_normal((K, 6, 5)).astype(np.float32)
    b = rng.standard_normal((5,)).astype(np.float32)
    want = np.asarray(jconv.conv_transpose1d(
        jnp.asarray(x), jnp.asarray(k), jnp.asarray(b), stride=stride,
        padding=padding, output_padding=output_padding))
    got = tconv.conv_transpose1d(
        torch.from_numpy(x), torch.from_numpy(k).permute(1, 2, 0), torch.from_numpy(b),
        stride=stride, padding=padding, output_padding=output_padding)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("T,pad", [(20, 3), (20, (1, 9)), (4, 9), (1, 3), (2, (5, 0))])
def test_reflect_pad1d_matches_jax(T, pad):
    """Pads of any size, including >= T, which torch's own reflect pad
    refuses and `jnp.pad` extends by repeated reflection."""
    x = np.random.default_rng(T).standard_normal((2, T, 3)).astype(np.float32)
    want = np.asarray(jconv.reflect_pad1d(jnp.asarray(x), pad))
    got = tconv.reflect_pad1d(torch.from_numpy(x), pad).numpy()
    np.testing.assert_array_equal(got, want)
