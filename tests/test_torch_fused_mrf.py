"""The port's MRF stage (`fastvocoder_tpu_torch/ops/fused_mrf.py` and
`models/layers.py`) against the JAX package, on the CPU.

`fused_mrf_stage_plain` is held two ways, at C = 16, 32, 64 and 128:
against the JAX fused stage `fused_mrf_stage(..., tile_q=16,
interpret=True)` at a T it accepts (T % (128 // C) == 0), and against the
mean of the JAX `ResBlock1` modules at any T, including T below the 60-row
halo of the k = 11 branch and T the JAX fused stage refuses.  Tolerance, as
in tests/test_fused_mrf.py: atol 2e-6, rtol 1e-4 (float32 sums of up to
6 x 11 x C products in different orders).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fastvocoder_tpu.models.layers import ResBlock1 as JaxResBlock1
from fastvocoder_tpu.ops.fused_mrf import fused_mrf_stage as jax_fused_mrf_stage
from fastvocoder_tpu_torch.checkpoint import state_dict_from_jax
from fastvocoder_tpu_torch.models.layers import ResBlock1, apply_mrf
from fastvocoder_tpu_torch.ops.fused_mrf import (
    fused_mrf_stage,
    fused_mrf_stage_plain,
    swap_channels,
)

KERNELS, DILATIONS = (3, 7, 11), (1, 3, 5)


def _params(C, seed=0):
    """Seeded JAX ResBlock1 params of the 3 branches, at torch's default
    conv init scale."""
    rng = np.random.default_rng(seed + C)
    params = []
    for rk in KERNELS:
        bound = 1.0 / np.sqrt(C * rk)
        p = {}
        for i in range(len(DILATIONS)):
            for name in (f"conv1_{i}", f"conv2_{i}"):
                p[name] = {
                    "kernel": rng.uniform(-bound, bound, (rk, C, C)).astype(np.float32),
                    "bias": rng.uniform(-bound, bound, (C,)).astype(np.float32),
                }
        params.append(p)
    return params


def _input(C, T, B=2):
    return (0.3 * np.random.default_rng(T + C).standard_normal((B, T, C))).astype(np.float32)


def _jax_modules_mean(x, params):
    C = x.shape[-1]
    outs = [JaxResBlock1(channels=C, kernel_size=rk, dilations=DILATIONS, weight_norm=False)
            .apply({"params": p}, jnp.asarray(x)) for rk, p in zip(KERNELS, params)]
    return np.asarray(sum(outs) / len(outs))


def _branches(params, as_torch):
    conv = (lambda a: torch.from_numpy(np.array(a))) if as_torch else jnp.asarray
    return [[(conv(p[f"conv1_{i}"]["kernel"]), conv(p[f"conv1_{i}"]["bias"]), d,
              conv(p[f"conv2_{i}"]["kernel"]), conv(p[f"conv2_{i}"]["bias"]))
             for i, d in enumerate(DILATIONS)] for p in params]


@pytest.mark.parametrize("C", [16, 32, 64, 128])
def test_plain_matches_jax_fused_interpret(C):
    T = 3 * (128 // C) if C < 128 else 20  # a T the JAX kernel takes
    x, params = _input(C, T), _params(C)
    want = np.asarray(jax_fused_mrf_stage(jnp.asarray(x), _branches(params, False), tile_q=16,
                                          interpret=True))
    got = fused_mrf_stage_plain(torch.from_numpy(x), _branches(params, True)).numpy()
    assert got.shape == want.shape == (2, T, C)
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=1e-4)


@pytest.mark.parametrize("C", [16, 32, 64, 128])
@pytest.mark.parametrize("T", [1, 7, 13, 45])
def test_plain_matches_jax_modules(C, T):
    """Any T: below the halo (45 < 60), and not a multiple of 128 // C."""
    x, params = _input(C, T), _params(C)
    want = _jax_modules_mean(x, params)
    got = fused_mrf_stage(torch.from_numpy(x), _branches(params, True)).numpy()
    assert got.shape == (2, T, C)
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=1e-4)


def test_module_path_matches_plain():
    """apply_mrf on the CPU (ResBlock1 modules with weights carried by
    state_dict_from_jax) computes what the plain stage does, and the
    operands it would hand the kernel are the JAX kernels as they are."""
    x, params = _input(32, 30), _params(32)
    blocks = []
    for rk, p in zip(KERNELS, params):
        b = ResBlock1(32, kernel_size=rk, dilations=DILATIONS)
        b.load_state_dict(state_dict_from_jax(p))
        blocks.append(b)
    for b, want in zip(blocks, _branches(params, True)):
        for got_pair, want_pair in zip(b.mrf_operands(), want):
            for a, w in zip(got_pair, want_pair):
                if isinstance(a, torch.Tensor):
                    torch.testing.assert_close(a, w, rtol=0, atol=0)
                else:
                    assert a == w
    with torch.inference_mode():
        got = apply_mrf(torch.from_numpy(x), blocks)
    want = fused_mrf_stage_plain(torch.from_numpy(x), _branches(params, True))
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_mrf_operands_follow_weight_writes():
    # cached where no gradient is asked for, as `load_generator` leaves a
    # served model; under autograd they are built anew and attached
    b = ResBlock1(16, kernel_size=3, dilations=(1, 3)).requires_grad_(False)
    first = b.mrf_operands()
    assert b.mrf_operands()[0][0] is first[0][0]  # cached
    with torch.no_grad():
        b.conv2_1.weight.mul_(2)
    second = b.mrf_operands()
    torch.testing.assert_close(second[1][3], 2 * first[1][3])
    assert second[0][0] is first[0][0]  # the other convs keep their copies


@pytest.mark.parametrize("C,K", [(16, 3), (32, 7), (64, 11)])
def test_swapped_operands_are_the_transposed_kernels(C, K):
    """The (tap, c_out, c_in) copies the tensor-core kernels read as their B
    operand: `mrf_operands`' kernels with the channel axes swapped, bit for
    bit, contiguous, and what `swap_channels` builds from the operands."""
    torch.manual_seed(C + K)
    b = ResBlock1(C, kernel_size=K, dilations=(1, 3, 5)).requires_grad_(False)
    ops, swapped = b.mrf_operands(), b.mrf_swapped()
    assert len(swapped) == len(ops) == 3
    for (k1, _, _, k2, _), (k1t, k2t), built in zip(ops, swapped, swap_channels([ops])[0]):
        for k, kt, again in ((k1, k1t, built[0]), (k2, k2t, built[1])):
            assert kt.shape == (K, C, C) and kt.is_contiguous() and not kt.requires_grad
            assert torch.equal(kt, k.transpose(1, 2))
            assert torch.equal(kt, again)
    # and against the module's own weight: (c_out, c_in, tap) -> (tap, c_out, c_in)
    assert torch.equal(swapped[1][0], b.conv1_1.weight.permute(2, 0, 1))


def test_swapped_operands_are_cached_in_inference_and_follow_weight_writes():
    b = ResBlock1(16, kernel_size=3, dilations=(1, 3)).requires_grad_(False)
    first = b.mrf_swapped()
    again = b.mrf_swapped()
    assert all(a is f for pa, pf in zip(again, first) for a, f in zip(pa, pf))  # cached
    assert b.mrf_operands()[0][0] is b.mrf_operands()[0][0]  # beside the other cache
    version = b.conv2_1.weight._version
    with torch.no_grad():
        b.conv2_1.weight.mul_(2)  # what an optimiser step does: written in place
    assert b.conv2_1.weight._version != version
    second = b.mrf_swapped()
    torch.testing.assert_close(second[1][1], 2 * first[1][1])
    assert torch.equal(second[1][1], b.mrf_operands()[1][3].transpose(1, 2))
    assert second[0][0] is first[0][0]  # the other convs keep their copies


def test_swapped_operands_are_built_anew_under_autograd():
    """While autograd follows the weights (training, weight norm on), nothing
    is cached: the copies are values of this step's weights, detached."""
    b = ResBlock1(16, kernel_size=3, dilations=(1,), weight_norm=True)
    first, again = b.mrf_swapped(), b.mrf_swapped()
    assert first[0][0] is not again[0][0] and torch.equal(first[0][0], again[0][0])
    assert not first[0][0].requires_grad
    with torch.no_grad():
        b.conv1_0.g.mul_(3)
    torch.testing.assert_close(b.mrf_swapped()[0][0], 3 * first[0][0])
    assert torch.equal(b.mrf_swapped()[0][0], b.mrf_operands()[0][0].detach().transpose(1, 2))


def test_cuda_wrapper_refuses_cpu_tensors():
    from fastvocoder_tpu_torch.ops.fused_mrf import fused_mrf_stage_cuda

    with pytest.raises(ValueError, match="CUDA tensor"):
        fused_mrf_stage_cuda(torch.zeros(1, 4, 16), [])
