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


# ---- the one-launch bf16 form's tiling, on the CPU ----

from fastvocoder_tpu.ops.fused_mrf import conv_margins as jax_conv_margins  # noqa: E402
from fastvocoder_tpu.ops.fused_tail import blocked_upconv_weight as jax_blocked_upconv  # noqa: E402
from fastvocoder_tpu_torch.ops.fused_mrf import tap_major_to_torch  # noqa: E402
from fastvocoder_tpu_torch.ops.fused_tail import (  # noqa: E402
    blocked_upsample,
    pack_blocked_upsample,
    tail_margins,
    tile_rows,
)
from fastvocoder_tpu_torch.ops.precision import fit  # noqa: E402


def _pair_sizes(blocks):
    return [[(k1.shape[0], int(d), k2.shape[0]) for k1, _, d, k2, _ in pairs] for pairs in blocks]


@pytest.mark.parametrize("conf", ["light", "large"])
def test_tail_plan_is_the_jax_reckoning(conf):
    """The tile plan's margins are the JAX package's (`fused_tail.py:242-250`)
    at sample granularity: each branch's sum of `conv_margins(K, d, 1)`, conv_post's,
    and the blocked upsample's taps and margins (`blocked_upconv_weight` at
    s_in = 1, s_out = u, whose weight `blocked_upsample` also gives); h0's
    halo covers the largest branch and conv_post in whole input rows."""
    gen = build_generator(load_model_config("hifigan", os.path.join(ROOT, "conf", "hifigan",
                                                                    f"{conf}.yaml")))
    up_k, _, u, pad, blocks, post_k, _ = gen.tail_operands()
    K, Kp = up_k.shape[0], post_k.shape[0]
    halo, branch, post, taps, up = tail_margins(K, u, pad, _pair_sizes(blocks), Kp)

    want_branch = []
    for pairs in blocks:
        sides = [jax_conv_margins(k1.shape[0], int(d), 1) for k1, _, d, _, _ in pairs]
        sides += [jax_conv_margins(k2.shape[0], 1, 1) for _, _, _, k2, _ in pairs]
        assert all(a == b for a, b in sides)  # "same" padding: both sides alike
        want_branch.append(sum(a for a, _ in sides))
    assert branch == tuple(want_branch) == (12, 36, 60)
    assert (post, post) == jax_conv_margins(Kp, 1, 1) == (3, 3)
    w_jax, off, right = jax_blocked_upconv(jnp.asarray(up_k.detach().numpy()), u, pad, 1, u)
    assert (taps, up) == (w_jax.shape[0], (off, right)) == (3, (1, 1))
    w, off_t, right_t = blocked_upsample(up_k.detach(), u, pad)
    assert (off_t, right_t) == (off, right)
    np.testing.assert_array_equal(w.numpy(), np.asarray(w_jax))
    # JAX's a_tot = off_up + max branch + off_p (`fused_tail.py:242-244`), in its units
    assert off + max(branch) + post == 64
    assert halo % u == 0 and 0 <= halo - (max(branch) + post) < u
    # HiFiGAN light at batch 1: two rounds of 132 blocks, evenly full
    rows = tile_rows(1, 140400, 132, 640)
    assert (rows, halo, -(-140400 // rows)) == (544, 64, 259)
    # and at batch 32 the largest tiles, 13 rounds
    rows = tile_rows(32, 33600, 132, 640)
    assert (rows, 32 * -(-33600 // rows)) == (640, 1696)


def test_pack_blocked_upsample_is_the_core_matrix_order():
    """Tap j's element (contracted k, produced n) lies in core matrix (k / 8,
    n / 8) of 8 x 8, row n % 8, column k % 8: `pack_kernel`'s unit at N = 32."""
    w = torch.arange(2 * 32 * 32, dtype=torch.float32).reshape(2, 32, 32) / 64
    packed = pack_blocked_upsample(w).float()
    for j, k, n in [(0, 0, 0), (0, 5, 17), (1, 31, 2), (1, 9, 30)]:
        at = j * 1024 + (k // 8 * 4 + n // 8) * 64 + n % 8 * 8 + k % 8
        assert packed[at].item() == fit(w[j, k, n], torch.bfloat16).item()


def _leaky(t, slope, dt):
    return fit(torch.where(t >= 0, t, t * slope), dt)


def _tiled_tail(x, up_k, up_b, u, pad, blocks, post_k, post_b, rows):
    """The one-launch kernel's dataflow in plain torch: for each tile of
    `rows` output rows, x's rows for it and h0's halo each side, the
    upsample as the blocked dense conv, each branch's pairs as valid convs
    on rows shrinking by their margins (starting where the last pair ends on
    the head's rows), every conv's rows outside [0, T) zeroed, the branches
    summed in order, the mean and the head; bf16 rounding where the kernel
    rounds for bf16 x."""
    dt = x.dtype
    xf = x.float()
    B, T_in, _ = x.shape
    T = u * T_in
    halo, branch, post, taps, (off, _) = tail_margins(up_k.shape[0], u, pad, _pair_sizes(blocks),
                                                      post_k.shape[0])
    w_up = blocked_upsample(fit(up_k, dt), u, pad)[0]
    C = up_k.shape[2]
    n = rows + 2 * halo
    y = torch.zeros(B, T, post_k.shape[2])
    for b in range(B):
        for t0 in range(0, T, rows):
            g0 = t0 - halo
            inside = ((torch.arange(n) + g0 >= 0) & (torch.arange(n) + g0 < T))[:, None]
            q0, nx = g0 // u - off, n // u + taps - 1
            q = torch.arange(q0, q0 + nx)
            xs = torch.where(((q >= 0) & (q < T_in))[:, None], xf[b, q.clamp(0, T_in - 1)], 0.0)
            xs = _leaky(xs, 0.1, dt)
            acc = sum(xs[j:j + n // u] @ w_up[j] for j in range(taps)) + fit(up_b, dt).repeat(u)
            h0 = torch.where(inside, fit(acc, dt).reshape(n, C), 0.0)
            total = None
            for br, pairs in enumerate(blocks):
                lo = halo - post - branch[br]
                hh = h0
                for k1, b1, d, k2, b2 in pairs:
                    m1, m2 = (k1.shape[0] - 1) * d // 2, (k2.shape[0] - 1) // 2
                    t = _leaky(hh[lo:n - lo], 0.1, dt)
                    t = torch.nn.functional.conv1d(t.T[None], tap_major_to_torch(fit(k1, dt)),
                                                   fit(b1, dt), dilation=d)[0].T
                    t = torch.where(inside[lo + m1:n - lo - m1], _leaky(fit(t, dt), 0.1, dt), 0.0)
                    t = torch.nn.functional.conv1d(t.T[None], tap_major_to_torch(fit(k2, dt)),
                                                   fit(b2, dt))[0].T
                    lo += m1 + m2
                    hh = hh.clone()
                    hh[lo:n - lo] = torch.where(inside[lo:n - lo],
                                                fit(hh[lo:n - lo] + fit(t, dt), dt), 0.0)
                part = hh[halo - post:halo + rows + post]
                total = part if total is None else fit(total + part, dt)
            m = _leaky(fit(total / len(blocks), dt), 0.01, dt)
            yt = torch.nn.functional.conv1d(m.T[None], tap_major_to_torch(fit(post_k, dt)),
                                            fit(post_b, dt))[0].T
            y[b, t0:t0 + rows] = torch.tanh(yt)[:T - t0]
    return y.to(dt)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T_in,rows", [(1, 1, 16), (2, 7, 16), (1, 8, 16), (1, 9, 16),
                                         (2, 17, 16), (1, 40, 32), (3, 33, 64)])
def test_tiled_dataflow_is_the_plain_tail(dt, B, T_in, rows):
    """Tile by tile from halo'd slices, masking rows outside [0, T), the
    tail is `fused_hifigan_tail_plain`'s at C_out 16 (the width the kernel
    takes), over lengths on both sides of one and two tiles: float32 within
    summation order (1e-6 after tanh), bf16 to the bit but for an element
    whose float32 sum lies within rounding of a bf16 boundary (at most one
    ulp apart on 1 % of the elements)."""
    ops = _as(_operands(32, 16, seed=T_in + rows), _torch)
    x = (0.3 * torch.from_numpy(np.random.default_rng(T_in).standard_normal((B, T_in, 32))
                                .astype(np.float32))).to(dt)
    got = _tiled_tail(x, *ops, rows).float()
    want = fused_hifigan_tail_plain(x, *ops).float()
    assert got.shape == want.shape == (B, 2 * T_in, 1)
    if dt == torch.float32:
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)
    else:
        ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(2.0 ** -126))) - 7)
        far = (got - want).abs() > 0
        assert torch.all((got - want).abs() <= ulp)
        assert far.float().mean().item() <= 0.01
