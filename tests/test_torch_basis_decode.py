"""The port's basis decode (`fastvocoder_tpu_torch/ops/basis_decode.py`)
against the JAX package's (`fastvocoder_tpu/ops/basis_decode.py`), on the
CPU: the plain version against `basis_decode_xla` and against the Pallas
kernel in interpret mode, and the kernel's backward (`basis_decode_vjp`)
against `jax.vjp(basis_decode_xla)`.

Tolerance: every output is a sum of n products; two float32 evaluations in
different orders differ by at most about 2 n eps sum|products|.  The bound
is computed elementwise by running the same bilinear function on absolute
values, so it scales with the output magnitude (a fixed 1e-5 does not hold
at C = 256, see ROADMAP C1).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fastvocoder_tpu.ops.basis_decode import basis_decode_pallas, basis_decode_xla
from fastvocoder_tpu_torch.ops.basis_decode import (
    basis_decode,
    basis_decode_plain,
    basis_decode_vjp,
)

EPS = float(np.finfo(np.float32).eps)
SHAPES = [(1, 50, 256, 30), (2, 48, 256, 30), (3, 7, 16, 6)]


def _inputs(B, F, C, L, seed=0):
    rng = np.random.default_rng(seed + F)
    w = np.maximum(rng.standard_normal((B, F, C)), 0).astype(np.float32)
    basis = (0.1 * rng.standard_normal((L, C))).astype(np.float32)
    return w, basis


def _bound(w, basis):
    C = w.shape[-1]
    mag = basis_decode_plain(torch.from_numpy(np.abs(w)), torch.from_numpy(np.abs(basis)))
    return 4 * C * EPS * mag.numpy()


@pytest.mark.parametrize("B,F,C,L", SHAPES)
def test_plain_matches_xla(B, F, C, L):
    w, basis = _inputs(B, F, C, L)
    want = np.asarray(basis_decode_xla(jnp.asarray(w), jnp.asarray(basis)))
    got = basis_decode_plain(torch.from_numpy(w), torch.from_numpy(basis)).numpy()
    assert got.shape == want.shape == (B, (F + 1) * (L // 2))
    assert np.all(np.abs(got - want) <= _bound(w, basis))


@pytest.mark.parametrize("B,F,C,L", SHAPES[:2])
def test_plain_matches_pallas_interpret(B, F, C, L):
    w, basis = _inputs(B, F, C, L, seed=1)
    want = np.asarray(basis_decode_pallas(jnp.asarray(w), jnp.asarray(basis), interpret=True))
    got = basis_decode(torch.from_numpy(w), torch.from_numpy(basis)).numpy()
    assert np.all(np.abs(got - want) <= _bound(w, basis))


@pytest.mark.parametrize("B,F,C,L", SHAPES)
def test_vjp_matches_jax(B, F, C, L):
    w, basis = _inputs(B, F, C, L, seed=2)
    rng = np.random.default_rng(3)
    g = rng.standard_normal((B, (F + 1) * (L // 2))).astype(np.float32)
    _, vjp = jax.vjp(basis_decode_xla, jnp.asarray(w), jnp.asarray(basis))
    want_w, want_b = (np.asarray(t) for t in vjp(jnp.asarray(g)))
    got_w, got_b = basis_decode_vjp(torch.from_numpy(w), torch.from_numpy(basis), torch.from_numpy(g))
    mag_w, mag_b = basis_decode_vjp(torch.from_numpy(np.abs(w)), torch.from_numpy(np.abs(basis)),
                                    torch.from_numpy(np.abs(g)))
    hop = L // 2
    assert np.all(np.abs(got_w.numpy() - want_w) <= 4 * 2 * hop * EPS * mag_w.numpy())
    n_rows = B * (F + 1)
    assert np.all(np.abs(got_b.numpy() - want_b) <= 4 * n_rows * EPS * mag_b.numpy())


def test_vjp_is_autograd_of_plain():
    w, basis = _inputs(2, 9, 16, 6, seed=4)
    tw = torch.from_numpy(w).requires_grad_()
    tb = torch.from_numpy(basis).requires_grad_()
    g = torch.randn(2, 10 * 3, generator=torch.Generator().manual_seed(0))
    want = torch.autograd.grad(basis_decode_plain(tw, tb), (tw, tb), g)
    got = basis_decode_vjp(tw.detach(), tb.detach(), g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_odd_basis_length_is_refused():
    with pytest.raises(ValueError, match="even"):
        basis_decode_plain(torch.zeros(1, 4, 8), torch.zeros(5, 8))
