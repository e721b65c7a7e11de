"""One residual stack as the chain kernels compute it, in 3xTF32
(`fastvocoder_tpu_torch/ops/tf32.py`), against float64 and against the
float32 plain version (`fused_residual_stacks_plain`,
`fused_residual_stacks_vjp_plain`), on the CPU.

The chain kernels (`csrc/fused_resstack.cu`, `csrc/fused_resstack_bwd.cu`)
contract on the tensor cores: every operand split into two TF32 halves,
three products, the products of one weight unit (16 contracted channels of
one tap at C = 256, 32 below) summed from zero and added to a float32
accumulator that starts at the bias.  The model here computes one stack in
the order the kernels do:

  * forward: u = leaky(bd + the dilated conv over leaky(h), mirrored at the
    edges), h' = (b1 + bs) + W1 u + Ws h;
  * backward: dt = (dh' W1^T) * leaky'(u); dh = conv_d^T(dt) over dt padded
    with zeros, times leaky'(h), plus dh' Ws^T; then the adjoint of the
    reflect pad as the fold pass computes it: the adjoint conv evaluated at
    the padded positions -j and 2 (T - 1) - j, masked by h's row j, added to
    row j, the left edge first; the weight gradients as row products in
    batches of 32 rows.

So the backward's decomposition of the reflect pad's adjoint is held
against autograd through the plain version's pad, down to lengths where the
two edges' rows overlap (T <= 2 m + 1).  Tolerance: the model's error
against float64, relative to the peak, is at most twice the float32 plain
version's plus two float32 roundings, the bound the MRF kernels' model meets
(`tests/test_torch_tf32_split.py`); against the float32 plain version it is
within 1e-5 of the peak (no seeded case puts a pre-activation on the other
side of the leaky-relu's kink).  No JAX and no GPU are needed.
"""

import numpy as np
import pytest
import torch

from fastvocoder_tpu_torch.ops.fused_resstack import (
    SLOPE,
    fused_residual_stacks_plain,
    fused_residual_stacks_vjp_plain,
    leaky_relu,
    stack_margin,
)
from fastvocoder_tpu_torch.ops.tf32 import matmul_3xtf32_units

EPS = 2.0 ** -23
WGRAD_ROWS = 32  # rows of one batch of the weight gradient's products


def _unit(C):
    """contracted channels of a weight unit (`Geo::kKC` in csrc/mma_common.cuh)"""
    return 16 if C >= 256 else 32


def _reflect(i, T):
    """numpy's "reflect" extension of [0, T) to the indices i"""
    if T == 1:
        return torch.zeros_like(i)
    p = 2 * (T - 1)
    i = i % p
    return torch.where(i >= T, p - i, i)


def _stack(C, d, seed, K=3):
    rng = np.random.default_rng(seed)
    out = []
    for taps in (K, 1, 1):
        bound = 1.0 / np.sqrt(C * taps)
        out += [torch.from_numpy(rng.uniform(-bound, bound, (taps, C, C)).astype(np.float32)),
                torch.from_numpy(rng.uniform(-bound, bound, (C,)).astype(np.float32))]
    kd, bd, k1, b1, ks, bs = out
    return kd, bd, d, k1, b1, ks, bs


def _inputs(T, C, seed):
    rng = np.random.default_rng(seed + 1)
    return (torch.from_numpy((0.3 * rng.standard_normal((T, C))).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((T, C)).astype(np.float32)))


def _mask(v):
    return torch.where(v >= 0, torch.ones_like(v), torch.full_like(v, SLOPE))


def _taps(rows, K, step, start, n):
    """(n, K C): for tap k the rows [start + k step, start + k step + n)"""
    return torch.cat([rows[start + k * step: start + k * step + n] for k in range(K)], dim=1)


def stack_3xtf32(x, stack):
    """(h', u) of one stack over x (T, C), as the forward kernel sums them."""
    kd, bd, d, k1, b1, ks, bs = stack
    K, C = kd.shape[0], kd.shape[1]
    T, m, unit = x.shape[0], stack_margin(K, d), _unit(C)
    a = leaky_relu(x)[_reflect(torch.arange(-m, T + m), T)]
    t = matmul_3xtf32_units(_taps(a, K, d, 0, T), kd.reshape(K * C, C), unit,
                            bd.expand(T, C).clone())
    u = leaky_relu(t)
    h = matmul_3xtf32_units(u, k1[0], unit, (b1 + bs).expand(T, C).clone())
    return matmul_3xtf32_units(x, ks[0], unit, h), u


def stack_vjp_3xtf32(x, stack, g):
    """(dx, (dk_dilated, db_d, dk_1x1, db_1, dk_skip, db_s)) of one stack, as
    the backward kernel's passes sum them."""
    kd, bd, d, k1, b1, ks, bs = stack
    K, C = kd.shape[0], kd.shape[1]
    T, m, unit = x.shape[0], stack_margin(K, d), _unit(C)
    half = (K - 1) // 2
    _, u = stack_3xtf32(x, stack)
    dt = matmul_3xtf32_units(g, k1[0].t().contiguous(), unit) * _mask(u)
    # the adjoint conv at the positions p in [-m, T + m) of the padded input:
    # tap k reads dt at p + (half - k) d, zero outside [0, T); row i is p = i - m
    zeros = torch.zeros(2 * m, C)
    dt_z = torch.cat([zeros, dt, zeros])
    w_adj = torch.cat([kd[k].t() for k in range(K)])
    A = matmul_3xtf32_units(_taps(dt_z, K, -d, m + half * d, T + 2 * m), w_adj, unit)
    dh = A[m: m + T] * _mask(x)
    dh = matmul_3xtf32_units(g, ks[0].t().contiguous(), unit, dh)
    # the fold pass: position -j was a copy of row j, 2 (T - 1) - j of row j
    left = torch.arange(1, m + 1)
    dh[left] = dh[left] + A[m - left] * _mask(x[left])
    right = torch.arange(T - 1 - m, T - 1)
    dh[right] = dh[right] + A[2 * (T - 1) - right + m] * _mask(x[right])
    a = leaky_relu(x)[_reflect(torch.arange(-m, T + m), T)]
    rows = lambda v: v.t().contiguous()
    dwd = torch.stack([matmul_3xtf32_units(rows(a[k * d: k * d + T]), dt, WGRAD_ROWS)
                       for k in range(K)])
    dw1 = matmul_3xtf32_units(rows(u), g, WGRAD_ROWS)[None]
    dws = matmul_3xtf32_units(rows(x), g, WGRAD_ROWS)[None]
    return dh, (dwd, dt.sum(0), dw1, g.sum(0), dws, g.sum(0))


def _f64(stack):
    return tuple(w.double() if isinstance(w, torch.Tensor) else w for w in stack)


def _rel(got, want):
    return ((got.double() - want).abs().max() / want.abs().max()).item()


# (C, T, d): both weight units; T = 1 and 5 below a 9-row pad (several folds)
@pytest.mark.parametrize("C,T,d", [(256, 64, 9), (256, 5, 9), (32, 1, 9), (32, 40, 3),
                                   (64, 2, 1), (128, 19, 9)])
def test_stack_forward_3xtf32_is_as_close_as_float32(C, T, d):
    stack = _stack(C, d, seed=C + T)
    x, _ = _inputs(T, C, seed=C + T)
    exact = fused_residual_stacks_plain(x.double()[None], [_f64(stack)])[0]
    plain = fused_residual_stacks_plain(x[None], [stack])[0]
    model, _ = stack_3xtf32(x, stack)
    assert model.shape == (T, C)
    assert _rel(model, exact) <= 2 * _rel(plain, exact) + 2 * EPS
    assert _rel(model, plain.double()) <= 1e-5


# the backward needs m <= T - 1; at T <= 2 m + 1 the two edges' rows overlap
@pytest.mark.parametrize("C,T,d", [(256, 64, 9), (256, 10, 9), (32, 19, 9), (32, 40, 3),
                                   (64, 2, 1), (128, 12, 3)])
def test_stack_backward_3xtf32_is_as_close_as_float32(C, T, d):
    stack = _stack(C, d, seed=C + T + 1)
    x, g = _inputs(T, C, seed=C + T + 1)
    dx64, grads64 = fused_residual_stacks_vjp_plain(x.double()[None], [_f64(stack)],
                                                    g.double()[None])
    dx32, grads32 = fused_residual_stacks_vjp_plain(x[None], [stack], g[None])
    dx, grads = stack_vjp_3xtf32(x, stack, g)
    assert _rel(dx, dx64[0]) <= 2 * _rel(dx32[0], dx64[0]) + 2 * EPS
    assert _rel(dx, dx32[0].double()) <= 1e-5
    for got, want, plain in zip(grads, grads64[0], grads32[0]):
        assert got.shape == want.shape
        assert _rel(got, want) <= 2 * _rel(plain, want) + 2 * EPS
        assert _rel(got, plain.double()) <= 1e-5


def test_the_fold_is_what_the_edges_need():
    """With the fold pass every row of the model's dx agrees with float64;
    the zero-padded adjoint alone is wrong on exactly the rows the pad
    copied: 1..m and T-1-m..T-2."""
    C, T, d = 32, 30, 3
    stack = _stack(C, d, seed=5)
    x, g = _inputs(T, C, seed=5)
    dx64, _ = fused_residual_stacks_vjp_plain(x.double()[None], [_f64(stack)], g.double()[None])
    peak = dx64.abs().max()
    folded = stack_vjp_3xtf32(x, stack, g)[0]
    assert not ((folded.double() - dx64[0]).abs().amax(dim=1) > 1e-4 * peak).any()
    kd, _, _, k1, _, ks, _ = stack
    m = stack_margin(3, d)
    _, u = stack_3xtf32(x, stack)
    dt = matmul_3xtf32_units(g, k1[0].t().contiguous(), 32) * _mask(u)
    zeros = torch.zeros(2 * m, C)
    dt_z = torch.cat([zeros, dt, zeros])
    w_adj = torch.cat([kd[k].t() for k in range(3)])
    A = matmul_3xtf32_units(_taps(dt_z, 3, -d, m + d, T + 2 * m), w_adj, 32)
    unfolded = A[m: m + T] * _mask(x) + matmul_3xtf32_units(g, ks[0].t().contiguous(), 32)
    off = (unfolded.double() - dx64[0]).abs().amax(dim=1) > 1e-4 * peak
    assert off.nonzero().flatten().tolist() == list(range(1, m + 1)) + list(range(T - 1 - m, T - 1))
