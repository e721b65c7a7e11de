"""The port's residual-stack chain backward
(`fused_residual_stacks_vjp_plain` in
`fastvocoder_tpu_torch/ops/fused_resstack.py`, the plain version of the CUDA
backward kernel) against the JAX package's gradients, on the CPU.

dx and every dW and db are held against `jax.grad` through the JAX fused
chain run as tests/test_fused_resstack.py runs it (`tile_q=32,
interpret=True`: its Pallas backward kernel in interpreter mode, the edges
stitched in XLA) at C = 32, T = 512, and against `jax.grad` of the JAX plain
chain (`_std_chain`) at the wider C = 128 and at lengths at and below the
JAX package's gate (T >= 16 M = 208), where the mirrored edges of the stacks
overlap.  Tolerance: 1e-4 of each gradient's own peak (float32 sums over up
to B T rows of 3 C products, in different orders).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fastvocoder_tpu.ops.fused_resstack import _std_chain
from fastvocoder_tpu.ops.fused_resstack import fused_residual_stacks as jax_fused_residual_stacks
from fastvocoder_tpu_torch.models.layers import ResidualStack, apply_residual_stacks
from fastvocoder_tpu_torch.ops.fused_resstack import (
    fused_residual_stacks,
    fused_residual_stacks_vjp_plain,
)

DILATIONS = (1, 3, 9)
REL_TOL = 1e-4
NAMES = ("dk_dilated", "db_d", "dk_1x1", "db_1", "dk_skip", "db_s")


def _weights(C, seed):
    """Per stack (kd, bd, k1, b1, ks, bs) as numpy, torch's init scale."""
    rng = np.random.default_rng(seed + C)
    out = []
    for _ in DILATIONS:
        stack = []
        for K in (3, 1, 1):
            bound = 1.0 / np.sqrt(C * K)
            stack += [rng.uniform(-bound, bound, (K, C, C)).astype(np.float32),
                      rng.uniform(-bound, bound, (C,)).astype(np.float32)]
        out.append(tuple(stack))
    return out


def _inputs(B, T, C):
    rng = np.random.default_rng(B * T + C)
    return ((0.3 * rng.standard_normal((B, T, C))).astype(np.float32),
            rng.standard_normal((B, T, C)).astype(np.float32))


def _rebuild(wd, conv):
    return [(conv(kd), conv(bd), d, conv(k1), conv(b1), conv(ks), conv(bs))
            for (kd, bd, k1, b1, ks, bs), d in zip(wd, DILATIONS)]


def _jax_grads(chain, x, wd, cot):
    wd = jax.tree_util.tree_map(jnp.asarray, wd)
    gx, gw = jax.grad(lambda x, wd: jnp.sum(chain(x, _rebuild(wd, lambda a: a)) * cot),
                      argnums=(0, 1))(jnp.asarray(x), wd)
    return np.asarray(gx), jax.tree_util.tree_map(np.asarray, gw)


def _assert_close(name, got, want):
    peak = np.abs(want).max()
    err = np.abs(np.asarray(got) - want).max()
    assert err <= REL_TOL * peak, f"{name}: max abs {err:.3e}, peak {peak:.3e}"


def _check(x, wd, cot, want_dx, want_gw):
    dx, grads = fused_residual_stacks_vjp_plain(
        torch.from_numpy(x), _rebuild(wd, lambda a: torch.from_numpy(a)), torch.from_numpy(cot))
    _assert_close("dx", dx, want_dx)
    for i, (got_s, want_s) in enumerate(zip(grads, want_gw)):
        for name, g, w in zip(NAMES, got_s, want_s):
            assert tuple(g.shape) == w.shape
            _assert_close(f"stack {i} {name}", g, w)


@pytest.mark.parametrize("C,T", [(32, 512)])
def test_plain_vjp_matches_jax_grad_through_the_pallas_backward(C, T):
    x, cot = _inputs(2, T, C)
    wd = _weights(C, 0)
    chain = lambda x, ws: jax_fused_residual_stacks(x, ws, tile_q=32, interpret=True)
    _check(x, wd, cot, *_jax_grads(chain, x, wd, cot))


@pytest.mark.parametrize("B,T,C", [(2, 200, 128), (1, 208, 32), (3, 10, 32), (2, 33, 64)])
def test_plain_vjp_matches_jax_grad_of_the_plain_chain(B, T, C):
    x, cot = _inputs(B, T, C)
    wd = _weights(C, 1)
    _check(x, wd, cot, *_jax_grads(_std_chain, x, wd, cot))


def test_chain_on_the_cpu_differentiates_the_plain_version():
    x, cot = _inputs(2, 40, 32)
    stacks = _rebuild(_weights(32, 2), lambda a: torch.from_numpy(a).requires_grad_())
    xt = torch.from_numpy(x).requires_grad_()
    flat = [w for s in stacks for w in s if isinstance(w, torch.Tensor)]
    got = torch.autograd.grad(fused_residual_stacks(xt, stacks), [xt] + flat,
                              torch.from_numpy(cot))
    dx, grads = fused_residual_stacks_vjp_plain(xt.detach(), stacks, torch.from_numpy(cot))
    for g, w in zip(got, [dx] + [t for s in grads for t in s]):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_weight_norm_stacks_train_through_apply_residual_stacks():
    """Training-form stacks: the gradient reaches every gain and direction,
    and `chain_operands` is attached to the graph and not cached."""
    torch.manual_seed(0)
    stacks = [ResidualStack(32, dilation=d, weight_norm=True) for d in DILATIONS]
    x = torch.randn(2, 30, 32)
    apply_residual_stacks(x, stacks).square().sum().backward()
    for m in stacks:
        for conv in (m.conv_dilated, m.conv_1x1, m.skip):
            assert conv.g.grad is not None and conv.weight.grad is not None
            assert torch.isfinite(conv.g.grad).all()
    ops = stacks[0].chain_operands()
    assert ops[0].requires_grad and not hasattr(stacks[0], "_cache")
    with torch.no_grad():
        assert not stacks[0].chain_operands()[0].requires_grad
