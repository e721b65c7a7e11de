"""The port's residual-stack chain (`fastvocoder_tpu_torch/ops/fused_resstack.py`
and `models/layers.py`) against the JAX package, on the CPU: the plain
chain against the JAX `ResidualStack` modules and against the JAX fused
chain `fused_residual_stacks(..., tile_q=32, interpret=True)`.

Tolerance, as in tests/test_fused_resstack.py: isolated rows may differ
where a pre-activation sits within float32-rounding distance of the
leaky-relu kink (the branch flips on a near-zero value), so the bound on
the whole tensor is 3e-4 of the output's magnitude, while at least 90 % of
rows must agree within 3e-6 of it (two conv implementations summing 768
products in different orders).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fastvocoder_tpu.models.layers import ResidualStack as JaxResidualStack
from fastvocoder_tpu.ops.fused_resstack import fused_residual_stacks as jax_fused
from fastvocoder_tpu_torch.checkpoint import state_dict_from_jax
from fastvocoder_tpu_torch.models.layers import ResidualStack, apply_residual_stacks
from fastvocoder_tpu_torch.ops.fused_resstack import (
    fused_residual_stacks,
    fused_residual_stacks_plain,
    stack_margin,
)

C = 256


def _jax_chain(x):
    """3 JAX ResidualStacks (d = 1, 3, 9), their params, their output."""
    mods, params = [], []
    for j in range(3):
        m = JaxResidualStack(channels=C, kernel_size=3, dilation=3 ** j, weight_norm=False)
        params.append(jax.jit(m.init)(jax.random.PRNGKey(j), x)["params"])
        mods.append(m)
    ref = x
    for m, p in zip(mods, params):
        ref = m.apply({"params": p}, ref)
    return params, np.asarray(ref)


def _stack_tuples(params, as_torch):
    conv = (lambda a: torch.from_numpy(np.array(a))) if as_torch else jnp.asarray
    return [
        (conv(p["conv_dilated"]["kernel"]), conv(p["conv_dilated"]["bias"]), 3 ** j,
         conv(p["conv_1x1"]["kernel"]), conv(p["conv_1x1"]["bias"]),
         conv(p["skip"]["kernel"]), conv(p["skip"]["bias"]))
        for j, p in enumerate(params)
    ]


def _assert_chain_close(got, want):
    scale = max(1.0, float(np.abs(want).max()))
    err = np.abs(got - want)
    assert err.max() <= 3e-4 * scale
    assert (err.max(axis=(0, 2)) <= 3e-6 * scale).mean() > 0.9


def _make_chain(T):
    x = (0.3 * np.random.default_rng(T).standard_normal((2, T, C))).astype(np.float32)
    params, ref = _jax_chain(jnp.asarray(x))
    return T, x, params, ref


@pytest.fixture(scope="module", params=[40, 97, 300])
def chain(request):
    return _make_chain(request.param)


def test_plain_matches_jax_modules(chain):
    T, x, params, ref = chain
    got = fused_residual_stacks_plain(torch.from_numpy(x), _stack_tuples(params, True))
    assert got.shape == (2, T, C)
    _assert_chain_close(got.numpy(), ref)


@pytest.mark.parametrize("T", [97, 300])  # the JAX fused chain needs T >= 4M = 52
def test_plain_matches_jax_fused_interpret(T):
    T, x, params, _ = _make_chain(T)
    want = np.asarray(jax_fused(jnp.asarray(x), _stack_tuples(params, False), tile_q=32, interpret=True))
    got = fused_residual_stacks(torch.from_numpy(x), _stack_tuples(params, True))
    _assert_chain_close(got.numpy(), want)


def test_module_path_matches_plain(chain):
    """apply_residual_stacks on the CPU (the modules, weights carried by
    state_dict_from_jax) computes what the plain chain does."""
    _, x, params, _ = chain
    mods = []
    for j, p in enumerate(params):
        m = ResidualStack(C, kernel_size=3, dilation=3 ** j)
        m.load_state_dict(state_dict_from_jax(p))
        mods.append(m)
        for a, b in zip(m.chain_operands(), _stack_tuples([p], True)[0]):
            if isinstance(a, torch.Tensor):
                torch.testing.assert_close(a, b, rtol=0, atol=0)
    with torch.inference_mode():
        got = apply_residual_stacks(torch.from_numpy(x), mods)
    want = fused_residual_stacks_plain(torch.from_numpy(x), _stack_tuples(params, True))
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_chain_operands_follow_weight_writes():
    # cached where no gradient is asked for, as `load_generator` leaves a
    # served model; under autograd they are built anew and attached
    m = ResidualStack(32, kernel_size=3, dilation=3).requires_grad_(False)
    first = m.chain_operands()
    assert m.chain_operands() is first
    with torch.no_grad():
        m.conv_1x1.weight.mul_(2)
    second = m.chain_operands()
    torch.testing.assert_close(second[3], 2 * first[3])


def test_stack_margin():
    assert stack_margin(3, 1) == 1
    assert stack_margin(3, 9) == 9
    assert stack_margin(7, 2) == 6
