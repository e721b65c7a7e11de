"""The port's MRF-stage backward (`fused_mrf_stage_vjp_plain` in
`fastvocoder_tpu_torch/ops/fused_mrf.py`, the plain version of the CUDA
backward kernel) against the JAX package's gradients, on the CPU.

dx and every dW and db are held against `jax.grad` through the JAX fused
stage run as tests/test_fused_mrf.py runs it (`tile_q=16, interpret=True`:
its Pallas backward kernel in interpreter mode) at C = 32, and against
`jax.grad` of the JAX plain module path at the wider C = 128, where the
interpreter is too slow.  Tolerance: 1e-4 of each gradient's own peak
(float32 sums over up to B T rows of 11 C products, in different orders).
On the CPU `fused_mrf_stage` falls through to the plain version, which
autograd differentiates: the same numbers through `apply_mrf` and the
weight-norm modules.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fastvocoder_tpu.ops.conv import conv1d as jax_conv1d
from fastvocoder_tpu.ops.fused_mrf import fused_mrf_stage as jax_fused_mrf_stage
from fastvocoder_tpu_torch.models.layers import ResBlock1, apply_mrf
from fastvocoder_tpu_torch.ops.fused_mrf import (
    fused_mrf_stage,
    fused_mrf_stage_plain,
    fused_mrf_stage_vjp_plain,
)

KERNELS, DILATIONS = (3, 7, 11), (1, 3, 5)
REL_TOL = 1e-4


def _weights(C, seed):
    """Per branch per pair (k1, b1, k2, b2) as numpy, torch's init scale."""
    rng = np.random.default_rng(seed + C)
    out = []
    for rk in KERNELS:
        bound = 1.0 / np.sqrt(C * rk)
        out.append([tuple(rng.uniform(-bound, bound, shape).astype(np.float32)
                          for shape in ((rk, C, C), (C,), (rk, C, C), (C,)))
                    for _ in DILATIONS])
    return out


def _inputs(B, T, C):
    rng = np.random.default_rng(B * T + C)
    return ((0.3 * rng.standard_normal((B, T, C))).astype(np.float32),
            rng.standard_normal((B, T, C)).astype(np.float32))


def _rebuild(wd, conv):
    return [[(conv(k1), conv(b1), d, conv(k2), conv(b2))
             for (k1, b1, k2, b2), d in zip(pairs, DILATIONS)] for pairs in wd]


def _jax_plain_stage(x, wd):
    acc = None
    for pairs in _rebuild(wd, lambda a: a):
        h = x
        for k1, b1, d, k2, b2 in pairs:
            t = jnp.where(h >= 0, h, 0.1 * h)
            t = jax_conv1d(t, k1, b1, padding=(k1.shape[0] - 1) * d // 2, dilation=d)
            t = jnp.where(t >= 0, t, 0.1 * t)
            t = jax_conv1d(t, k2, b2, padding=(k2.shape[0] - 1) // 2)
            h = h + t
        acc = h if acc is None else acc + h
    return acc / len(wd)


def _jax_grads(stage, x, wd, cot):
    wd = jax.tree_util.tree_map(jnp.asarray, wd)
    gx, gw = jax.grad(lambda x, wd: jnp.sum(stage(x, wd) * cot), argnums=(0, 1))(
        jnp.asarray(x), wd)
    return np.asarray(gx), jax.tree_util.tree_map(np.asarray, gw)


def _assert_close(name, got, want):
    peak = np.abs(want).max()
    err = np.abs(np.asarray(got) - want).max()
    assert err <= REL_TOL * peak, f"{name}: max abs {err:.3e}, peak {peak:.3e}"


def _check(x, wd, cot, want_dx, want_gw):
    dx, grads = fused_mrf_stage_vjp_plain(
        torch.from_numpy(x), _rebuild(wd, lambda a: torch.from_numpy(a)), torch.from_numpy(cot))
    _assert_close("dx", dx, want_dx)
    for i, (got_b, want_b) in enumerate(zip(grads, want_gw)):
        for j, (got_p, want_p) in enumerate(zip(got_b, want_b)):
            for name, g, w in zip(("dk1", "db1", "dk2", "db2"), got_p, want_p):
                assert tuple(g.shape) == w.shape
                _assert_close(f"branch {i} pair {j} {name}", g, w)


@pytest.mark.parametrize("C,T", [(32, 120)])
def test_plain_vjp_matches_jax_grad_through_the_pallas_backward(C, T):
    x, cot = _inputs(2, T, C)
    wd = _weights(C, 0)
    stage = lambda x, wd: jax_fused_mrf_stage(x, _rebuild(wd, lambda a: a), tile_q=16,
                                              interpret=True)
    _check(x, wd, cot, *_jax_grads(stage, x, wd, cot))


@pytest.mark.parametrize("B,T,C", [(2, 150, 128), (1, 7, 16), (3, 50, 64)])
def test_plain_vjp_matches_jax_grad_of_the_module_path(B, T, C):
    """Also T below the halo of the k = 11 branch (zero padding on every
    conv's own input) and odd batch sizes."""
    x, cot = _inputs(B, T, C)
    wd = _weights(C, 1)
    _check(x, wd, cot, *_jax_grads(_jax_plain_stage, x, wd, cot))


def test_stage_on_the_cpu_differentiates_the_plain_version():
    x, cot = _inputs(2, 40, 16)
    wd = _weights(16, 2)
    blocks = _rebuild(wd, lambda a: torch.from_numpy(a).requires_grad_())
    xt = torch.from_numpy(x).requires_grad_()
    flat = [w for pairs in blocks for p in pairs for w in p if isinstance(w, torch.Tensor)]
    got = torch.autograd.grad(fused_mrf_stage(xt, blocks), [xt] + flat, torch.from_numpy(cot))
    dx, grads = fused_mrf_stage_vjp_plain(xt.detach(), blocks, torch.from_numpy(cot))
    want = [dx] + [t for br in grads for p in br for t in p]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_weight_norm_modules_carry_the_gradient_to_gain_and_direction():
    """`apply_mrf` over training-form blocks: d/dg and d/dv are the chain
    rule of the effective weight's gradient."""
    torch.manual_seed(0)
    blocks = [ResBlock1(16, kernel_size=k, weight_norm=True) for k in (3, 7)]
    x = torch.randn(2, 30, 16)
    cot = torch.randn(2, 30, 16)
    c1 = blocks[0].convs1[0]
    (apply_mrf(x, blocks) * cot).sum().backward()
    assert c1.g.grad is not None and c1.weight.grad is not None
    # against the fused form: same effective weights, plain stage
    eff = [b.mrf_operands() for b in blocks]
    eff = [[tuple(w.detach().requires_grad_() if isinstance(w, torch.Tensor) else w for w in p)
            for p in pairs] for pairs in eff]
    (fused_mrf_stage_plain(x, eff) * cot).sum().backward()
    dW = eff[0][0][0].grad.permute(2, 1, 0)  # (K, Cin, Cout) -> (Cout, Cin, K)
    v, g = c1.weight.detach(), c1.g.detach()
    norm = v.pow(2).sum(dim=(1, 2), keepdim=True).sqrt()
    dg = (dW * v / norm).sum(dim=(1, 2))
    dv = g[:, None, None] / norm * (dW - v * (dW * v).sum(dim=(1, 2), keepdim=True) / norm ** 2)
    torch.testing.assert_close(c1.g.grad, dg, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(c1.weight.grad, dv, rtol=1e-4, atol=1e-6)
