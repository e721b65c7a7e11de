"""The port's Griffin-Lim (`fastvocoder_tpu_torch/dsp/griffin_lim.py`) on
the CPU against both of the JAX package's loops, from the same initial
phase: in float64 against the numpy loop (`dsp/audio.py::_griffin_lim`),
in float32 against the jitted one (`dsp/griffin_lim.py::griffin_lim`); and
the mel inversions' lengths and seeding."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvocoder_tpu.dsp import audio as jax_audio
from fastvocoder_tpu.dsp import griffin_lim as jax_gl
from fastvocoder_tpu_torch.dsp import audio, griffin_lim
from fastvocoder_tpu_torch.hparams import HP

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "mel_golden.npz")
FRAMES = 40


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs (pytest-xdist runs several
    test processes side by side), restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def magnitude():
    """The linear magnitude S ** power of the golden mel's first frames,
    as the numpy inversion computes it, (bins, frames) float64."""
    mel = np.load(GOLDEN)["mel"][:, :FRAMES].astype(np.float64)
    amp = jax_audio._db_to_amp(jax_audio._denormalize(mel) + HP.ref_level_db)
    return jax_audio._mel_to_linear(amp) ** HP.power


def _args(S):
    return dict(n_iters=HP.griffin_lim_iters, n_fft=HP.n_fft, hop=HP.hop_length,
                win=HP.win_length, length=HP.hop_length * (S.shape[1] - 1))


@pytest.mark.parametrize("seed", [0, 7])
def test_float64_is_the_numpy_loop(magnitude, seed):
    S = magnitude
    want = jax_audio._griffin_lim(S, HP, seed=seed)
    phase = 2 * np.pi * np.random.default_rng(seed).random(S.shape)
    got = griffin_lim.griffin_lim(torch.from_numpy(S.T.copy()), phase0=phase.T.copy(),
                                  **_args(S)).numpy()
    assert got.dtype == np.float64 and got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-9 * np.abs(want).max()


def test_float32_is_the_jitted_loop(magnitude):
    S = magnitude
    mag = jnp.asarray(S.T, jnp.float32)
    key = jax.random.PRNGKey(0)
    want = np.asarray(jax_gl.griffin_lim(mag, rng=key, **_args(S)))
    phase = np.array(jax.random.uniform(key, mag.shape, minval=0.0, maxval=2.0 * jnp.pi))
    got = griffin_lim.griffin_lim(torch.from_numpy(np.array(mag)), phase0=phase,
                                  **_args(S)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_mel_inversions_length_and_seed():
    mel = np.load(GOLDEN)["mel"][:, :FRAMES].astype(np.float32)
    hp = HP.replace(griffin_lim_iters=4)
    for invert in (griffin_lim.inv_mel_spectrogram, audio.inv_mel_spectrogram):
        a = invert(mel, hp, seed=1, device="cpu")
        assert a.shape == (HP.hop_length * (FRAMES - 1),) and np.isfinite(a).all()
        assert np.array_equal(a, invert(mel, hp, seed=1, device="cpu"))
        assert not np.array_equal(a, invert(mel, hp, seed=2, device="cpu"))
    # the JAX package's float32 inversion, the same length
    want = jax_gl.inv_mel_spectrogram_jax(mel, hp)
    assert want.shape == a.shape
    spec = np.clip(np.load(GOLDEN)["mel"][:1, :FRAMES], 0, 1).repeat(1025, 0)
    assert audio.inv_spectrogram(spec, hp, device="cpu").shape == a.shape
