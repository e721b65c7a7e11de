"""The port's STFT and losses (`fastvocoder_tpu_torch/dsp/stft.py`,
`losses/`) against the JAX package's, on the CPU: values, and gradients with
respect to the estimate.

Inputs come from numpy.  Tolerances: the magnitude STFT within 1e-5 of its
peak (two float32 FFTs); every loss value rtol 1e-5; the gradient of a loss
within 2e-3 of its peak, because the log-magnitude term divides by
magnitudes down to its clamp and float32 makes that ill-conditioned (the
spectral-convergence term alone agrees to 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvocoder_tpu import losses as jl
from fastvocoder_tpu.dsp.stft import stft_mag as jax_stft_mag
from fastvocoder_tpu.ops.pqmf import PQMF as JaxPQMF
from fastvocoder_tpu_torch import losses as tl
from fastvocoder_tpu_torch.dsp.stft import stft_complex, stft_mag
from fastvocoder_tpu_torch.ops.pqmf import PQMF

VALUE_RTOL, GRAD_TOL = 1e-5, 2e-3


def _pair(B=2, T=2400, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(T, dtype=np.float32)
    y = np.stack([0.3 * np.sin(2 * np.pi * 220 * (i + 1) * t / 24000) for i in range(B)])
    y = (y + 0.01 * rng.standard_normal(y.shape)).astype(np.float32)
    x = (0.1 * rng.standard_normal((B, T))).astype(np.float32)
    return x, y


def _grad_close(got, want, tol=GRAD_TOL):
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("fft,hop,win", [(2048, 240, 1200), (1024, 120, 600), (512, 50, 240),
                                         (256, 64, 128)])
def test_stft_mag_matches_jax(fft, hop, win):
    x, _ = _pair()
    want = np.asarray(jax_stft_mag(jnp.asarray(x), fft, hop, win))
    got = stft_mag(torch.from_numpy(x), fft, hop, win).numpy()
    assert got.shape == want.shape == (2, 1 + 2400 // hop, fft // 2 + 1)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_stft_matches_torch_stft_and_keeps_float64():
    x, _ = _pair()
    xt = torch.from_numpy(x)
    want = torch.stft(xt, 1024, 120, 600, window=torch.hann_window(600), center=True,
                      pad_mode="reflect", return_complex=True).transpose(1, 2)
    torch.testing.assert_close(stft_complex(xt, 1024, 120, 600), want, rtol=1e-4, atol=1e-4)
    assert stft_complex(xt.double(), 1024, 120, 600).dtype == torch.complex128


@pytest.mark.parametrize("masked", [False, True])
def test_multi_resolution_stft_loss_matches_jax(masked):
    x, y = _pair()
    if masked:
        jfn = lambda a: sum(jl.multi_resolution_stft_loss_masked(a, jnp.asarray(y), np.int32(1700)))
        tfn = lambda a: sum(tl.multi_resolution_stft_loss_masked(a, torch.from_numpy(y), 1700))
    else:
        jfn = lambda a: sum(jl.multi_resolution_stft_loss(a, jnp.asarray(y)))
        tfn = lambda a: sum(tl.multi_resolution_stft_loss(a, torch.from_numpy(y)))
    want, want_grad = jax.value_and_grad(jfn)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = tfn(xt)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=VALUE_RTOL)
    _grad_close(xt.grad, want_grad)


def test_spectral_convergence_gradient_is_well_conditioned():
    x, y = _pair()
    want_grad = jax.grad(lambda a: jl.multi_resolution_stft_loss(a, jnp.asarray(y))[0])(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    tl.multi_resolution_stft_loss(xt, torch.from_numpy(y))[0].backward()
    _grad_close(xt.grad, want_grad, tol=1e-5)


def _disc_out(rng, scale=1.0):
    """A composite discriminator's output shape: 2 scales of 3 features."""
    return [[(scale * rng.standard_normal(s)).astype(np.float32)
             for s in ((2, 50, 4), (2, 13, 8), (2, 13, 1))] for _ in range(2)]


def test_gan_losses_match_jax():
    rng = np.random.default_rng(1)
    est, real = _disc_out(rng), _disc_out(rng)
    to_j = lambda p: [[jnp.asarray(f) for f in s] for s in p]
    to_t = lambda p: [[torch.from_numpy(f).requires_grad_() for f in s] for s in p]

    jest = to_j(est)
    want = {
        "adv": jax.value_and_grad(lambda p: jl.adversarial_loss(p))(jest),
        "fm": jax.value_and_grad(lambda p: jl.feature_map_loss(p, to_j(real)))(jest),
        "real": jax.value_and_grad(lambda p: jl.discriminator_loss(p, to_j(real))[0])(jest),
        "fake": jax.value_and_grad(lambda p: jl.discriminator_loss(to_j(real), p)[1])(jest),
    }
    fns = {
        "adv": lambda p: tl.adversarial_loss(p),
        "fm": lambda p: tl.feature_map_loss(p, to_t(real)),
        "real": lambda p: tl.discriminator_loss(p, to_t(real))[0],
        "fake": lambda p: tl.discriminator_loss(to_t(real), p)[1],
    }
    for name, fn in fns.items():
        test = to_t(est)
        got = fn(test)
        got.backward()
        value, grads = want[name]
        np.testing.assert_allclose(got.item(), float(value), rtol=VALUE_RTOL, err_msg=name)
        for s_t, s_j in zip(test, grads):
            for f_t, f_j in zip(s_t, s_j):
                g = torch.zeros_like(f_t) if f_t.grad is None else f_t.grad
                np.testing.assert_allclose(g.numpy(), np.asarray(f_j), rtol=1e-5, atol=1e-9,
                                           err_msg=name)


def test_feature_map_loss_has_no_gradient_to_the_real_features():
    rng = np.random.default_rng(2)
    est = [[torch.from_numpy(f).requires_grad_() for f in s] for s in _disc_out(rng)]
    real = [[torch.from_numpy(f).requires_grad_() for f in s] for s in _disc_out(rng)]
    tl.feature_map_loss(est, real).backward()
    assert all(f.grad is None for s in real for f in s)
    assert all(f.grad is not None for s in est for f in s[:-1])


def test_reconstruction_loss_full_band_and_weight_l1_match_jax():
    x, y = _pair()
    rng = np.random.default_rng(3)
    ew = rng.random((2, 160, 16)).astype(np.float32)
    w = rng.random((2, 160, 16)).astype(np.float32)

    def jfn(a, b):
        s, wl = jl.reconstruction_loss(a, jnp.asarray(y), est_weight=b, weight=jnp.asarray(w))
        return s + wl, (s, wl)

    (_, (ws, wwl)), (gx, gw) = jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(ew))
    xt, et = torch.from_numpy(x).requires_grad_(), torch.from_numpy(ew).requires_grad_()
    s, wl = tl.reconstruction_loss(xt, torch.from_numpy(y), est_weight=et,
                                   weight=torch.from_numpy(w))
    (s + wl).backward()
    np.testing.assert_allclose(s.item(), float(ws), rtol=VALUE_RTOL)
    np.testing.assert_allclose(wl.item(), float(wwl), rtol=VALUE_RTOL)
    _grad_close(xt.grad, gx)
    np.testing.assert_allclose(et.grad.numpy(), np.asarray(gw), rtol=1e-5, atol=1e-9)
    assert tl.reconstruction_loss(xt, torch.from_numpy(y))[1] is None


@pytest.mark.parametrize("masked", [False, True])
def test_reconstruction_loss_multiband_matches_jax(masked):
    _, y = _pair()
    sub = (0.1 * np.random.default_rng(4).standard_normal((2, 600, 4))).astype(np.float32)
    if masked:
        jfn = lambda a: jl.reconstruction_loss_masked(a, jnp.asarray(y), np.int32(1700),
                                                      pqmf=JaxPQMF())
        tfn = lambda a: tl.reconstruction_loss_masked(a, torch.from_numpy(y), 1700, pqmf=PQMF())
    else:
        jfn = lambda a: jl.reconstruction_loss(a, jnp.asarray(y), pqmf=JaxPQMF())[0]
        tfn = lambda a: tl.reconstruction_loss(a, torch.from_numpy(y), pqmf=PQMF())[0]
    want, want_grad = jax.value_and_grad(jfn)(jnp.asarray(sub))
    st = torch.from_numpy(sub).requires_grad_()
    got = tfn(st)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=VALUE_RTOL)
    _grad_close(st.grad, want_grad)
