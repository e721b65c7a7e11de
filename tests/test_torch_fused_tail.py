"""The port's HiFiGAN tail (`fastvocoder_tpu_torch/ops/fused_tail.py`)
against the JAX package, on the CPU.

`fused_hifigan_tail_plain` is held against the JAX fused tail
`fused_hifigan_tail(..., tile_q=16, interpret=True)` for the two shapes it
takes (32 -> 16 as in HiFiGAN light, 64 -> 32 as in HiFiGAN large), and
against the JAX package's conv ops at lengths the JAX kernel refuses.  The
generator's `tail_operands` fed to the plain tail must reproduce its own
module path.  Tolerance, as in tests/test_fused_tail.py: atol 5e-5, rtol
1e-4 (after tanh).
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fastvocoder_tpu.ops.conv import conv1d as jax_conv1d
from fastvocoder_tpu.ops.conv import conv_transpose1d as jax_conv_transpose1d
from fastvocoder_tpu.ops.fused_tail import fused_hifigan_tail as jax_fused_tail
from fastvocoder_tpu_torch.hparams import load_model_config
from fastvocoder_tpu_torch.models.factory import build_generator
from fastvocoder_tpu_torch.ops.fused_resstack import leaky_relu
from fastvocoder_tpu_torch.ops.fused_tail import fused_hifigan_tail, fused_hifigan_tail_plain

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _operands(cin, cout, seed, bands=1):
    """Seeded tail operands in the JAX layouts, numpy: up (4, cin, cout),
    3 branches k = 3 / 7 / 11 of dilations 1 / 3 / 5, post (7, cout, bands)."""
    r = np.random.default_rng(seed)

    def w(*shape, scale=0.08):
        return (scale * r.standard_normal(shape)).astype(np.float32)

    blocks = [[(w(rk, cout, cout), w(cout, scale=0.05), d, w(rk, cout, cout), w(cout, scale=0.05))
               for d in (1, 3, 5)] for rk in (3, 7, 11)]
    return (w(4, cin, cout), w(cout, scale=0.1), 2, 1, blocks, w(7, cout, bands),
            w(bands, scale=0.1))


def _as(ops, conv):
    up_k, up_b, u, pad, blocks, post_k, post_b = ops
    return (conv(up_k), conv(up_b), u, pad,
            [[(conv(a), conv(b), d, conv(c), conv(e)) for a, b, d, c, e in pairs]
             for pairs in blocks], conv(post_k), conv(post_b))


def _torch(a):
    return torch.from_numpy(np.array(a))


def _jax_ops_tail(x, up_k, up_b, stride, pad, blocks, post_k, post_b):
    """The tail from the JAX package's conv ops (tests/test_fused_tail.py's
    reference)."""
    h = jnp.where(x >= 0, x, 0.1 * x)
    h = jax_conv_transpose1d(h, up_k, up_b, stride=stride, padding=pad)
    acc = None
    for pairs in blocks:
        hh = h
        for k1, b1, d, k2, b2 in pairs:
            t = jnp.where(hh >= 0, hh, 0.1 * hh)
            t = jax_conv1d(t, k1, b1, padding=(k1.shape[0] - 1) * d // 2, dilation=d)
            t = jnp.where(t >= 0, t, 0.1 * t)
            t = jax_conv1d(t, k2, b2, padding=(k2.shape[0] - 1) // 2)
            hh = hh + t
        acc = hh if acc is None else acc + hh
    h = acc / len(blocks)
    h = jnp.where(h >= 0, h, 0.01 * h)
    return jnp.tanh(jax_conv1d(h, post_k, post_b, padding=(post_k.shape[0] - 1) // 2))


@pytest.mark.parametrize("cin,cout", [(32, 16), (64, 32)])
def test_plain_matches_jax_fused_interpret(cin, cout):
    T_in = 3 * (128 // cin)  # the JAX kernel needs T_in % (128 // C_in) == 0
    x = (0.3 * np.random.default_rng(cin).standard_normal((2, T_in, cin))).astype(np.float32)
    ops = _operands(cin, cout, seed=cin)
    want = np.asarray(jax_fused_tail(jnp.asarray(x), *_as(ops, jnp.asarray), tile_q=16,
                                     interpret=True))
    got = fused_hifigan_tail_plain(torch.from_numpy(x), *_as(ops, _torch)).numpy()
    assert got.shape == want.shape == (2, 2 * T_in, 1)
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-4)


@pytest.mark.parametrize("T_in", [1, 5, 37])
@pytest.mark.parametrize("cin,cout,bands", [(32, 16, 1), (64, 32, 4)])
def test_plain_matches_jax_ops_any_length(T_in, cin, cout, bands):
    x = (0.3 * np.random.default_rng(T_in).standard_normal((1, T_in, cin))).astype(np.float32)
    ops = _operands(cin, cout, seed=T_in + cin, bands=bands)
    want = np.asarray(_jax_ops_tail(jnp.asarray(x), *_as(ops, jnp.asarray)))
    got = fused_hifigan_tail(torch.from_numpy(x), *_as(ops, _torch)).numpy()
    assert got.shape == want.shape == (1, 2 * T_in, bands)
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-4)


def test_generator_tail_operands_reproduce_its_module_path():
    """What HiFiGAN light hands the tail kernel on CUDA computes, through the
    plain tail, what its modules compute on the CPU: the last stage and the
    head of the release weights' layouts, with the 0.01 slope."""
    gen = build_generator(load_model_config("hifigan", os.path.join(ROOT, "conf", "hifigan",
                                                                    "light.yaml")))
    gen.eval()
    x = 0.3 * torch.randn(1, 21, 32, generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        got = fused_hifigan_tail_plain(x, *gen.tail_operands())
        h = gen.ups[-1](leaky_relu(x, 0.1))
        acc = sum(b(h) for b in gen.mrfs[-1]) / len(gen.mrfs[-1])
        want = torch.tanh(gen.conv_post(leaky_relu(acc, 0.01)))
    assert got.shape == (1, 42, 1)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_cuda_wrapper_refuses_cpu_tensors():
    from fastvocoder_tpu_torch.ops.fused_tail import fused_hifigan_tail_cuda

    with pytest.raises(ValueError, match="CUDA tensor"):
        fused_hifigan_tail_cuda(torch.zeros(1, 4, 32), *_as(_operands(32, 16, 0), _torch))
