"""The port's feature extraction (`fastvocoder_tpu_torch/dsp/{mel, audio,
stft}.py`) on the CPU against the JAX package's: the filterbank exactly,
the mel and linear spectrograms (torch float64 against numpy) within 1e-9
and the mel golden at the JAX test's atol, the resampler and wav loading
bit for bit (the same scipy filter), preemphasis round trips, `istft`
against the JAX `istft` in float32, and `frame_signal` with its gradient
where frames overrun the signal."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io.wavfile
import torch

from fastvocoder_tpu.dsp import audio as jax_audio
from fastvocoder_tpu.dsp import mel as jax_mel
from fastvocoder_tpu.dsp import stft as jax_stft
from fastvocoder_tpu_torch.dsp import audio, mel, stft
from fastvocoder_tpu_torch.hparams import HP

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs (pytest-xdist runs several
    test processes side by side), restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _speechlike(seed: int, n: int = 24000) -> np.ndarray:
    """Two harmonic tones under noise, float32 in [-1, 1]."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / HP.sample_rate
    y = 0.3 * np.sin(2 * np.pi * 180 * t) + 0.2 * np.sin(2 * np.pi * 1230 * t + 1.0)
    return (y + 0.05 * rng.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("sr,n_fft,n_mels,fmin", [(24000, 2048, 80, 40.0), (22050, 1024, 64, 0.0)])
def test_mel_filter_bank_is_jaxs(sr, n_fft, n_mels, fmin):
    for dtype in (np.float32, np.float64):
        got = mel.mel_filter_bank(sr, n_fft, n_mels, fmin, dtype=dtype)
        want = jax_mel.mel_filter_bank(sr, n_fft, n_mels, fmin, dtype=dtype)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    f = np.linspace(0, 12000, 97)
    assert np.array_equal(mel.hz_to_mel(f), jax_mel.hz_to_mel(f))
    assert np.array_equal(mel.mel_to_hz(mel.hz_to_mel(f)), jax_mel.mel_to_hz(jax_mel.hz_to_mel(f)))


@pytest.mark.parametrize("seed,n", [(0, 24000), (1, 17777)])
def test_melspectrogram_and_spectrogram_are_jaxs(seed, n):
    y = _speechlike(seed, n)
    got = audio.melspectrogram(y, device=CPU)
    want = jax_audio.melspectrogram(y)
    assert got.shape == want.shape == (80, 1 + n // HP.hop_size)
    assert got.dtype == want.dtype == np.float64
    assert np.abs(got - want).max() <= 1e-9
    got, want = audio.spectrogram(y, device=CPU), jax_audio.spectrogram(y)
    assert got.shape == want.shape == (1025, 1 + n // HP.hop_size)
    assert np.abs(got - want).max() <= 1e-9
    # a tensor in gives the same as the array
    assert np.array_equal(audio.melspectrogram(torch.from_numpy(y), device=CPU),
                          audio.melspectrogram(y, device=CPU))


def test_mel_golden():
    g = np.load(os.path.join(GOLDENS, "mel_golden.npz"))
    np.testing.assert_allclose(audio.melspectrogram(g["wav"], device=CPU), g["mel"], atol=1e-5)


@pytest.mark.parametrize("sr", [22050, 48000])
def test_resample_is_jaxs(sr):
    x = _speechlike(sr, sr // 2).astype(np.float64)
    got = audio.resample(x, sr, 24000)
    want = jax_audio.resample(x, sr, 24000)
    assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)
    assert np.array_equal(audio.resample(x, 24000, 24000), jax_audio.resample(x, 24000, 24000))


@pytest.mark.parametrize("sr", [24000, 22050])
def test_load_wav_is_jaxs(tmp_path, sr):
    y = _speechlike(sr, sr // 3)
    path = str(tmp_path / "a.wav")
    scipy.io.wavfile.write(path, sr, (y * 32000).astype(np.int16))
    for encode in (False, True):
        got = audio.load_wav(path, 24000, encode=encode)
        want = jax_audio.load_wav(path, 24000, encode=encode)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_save_wav_writes_what_jax_writes(tmp_path):
    y = _speechlike(5, 4000)
    audio.save_wav(y, str(tmp_path / "p.wav"), 24000, rescale_out=0.4)
    jax_audio.save_wav(y, str(tmp_path / "j.wav"), 24000, rescale_out=0.4)
    assert (tmp_path / "p.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()


def test_preemphasis_round_trip():
    y = _speechlike(3).astype(np.float64)
    assert np.abs(audio.inv_preemphasis(audio.preemphasis(y)) - y).max() <= 1e-10
    on_device = audio.preemphasis(torch.from_numpy(y)).numpy()
    assert np.array_equal(on_device, jax_audio.preemphasis(y))
    assert np.abs(audio.inv_preemphasis(on_device) - y).max() <= 1e-10


@pytest.mark.parametrize("fft,hop,win,T,length", [
    (1024, 256, 1024, 4096, 4096), (2048, 240, 1200, 9600, None), (512, 50, 240, 3001, 2900)])
def test_istft_is_jaxs(fft, hop, win, T, length):
    rng = np.random.default_rng(T)
    x = rng.standard_normal(T).astype(np.float32)
    z = np.array(jax_stft.stft_complex(jnp.asarray(x), fft, hop, win))
    want = np.asarray(jax_stft.istft(jnp.asarray(z), fft, hop, win, length=length))
    got = stft.istft(torch.from_numpy(z), fft, hop, win, length=length).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    # stft -> istft is the identity (float32) over the samples it returns
    back = stft.istft(stft.stft_complex(torch.from_numpy(x), fft, hop, win), fft, hop, win,
                      length=T).numpy()
    assert back.shape == (min(T, hop * (T // hop)),)
    np.testing.assert_allclose(back, x[: back.shape[0]], atol=1e-4)


def test_num_stft_frames_is_jaxs():
    for T, n_fft, hop, center in ((33600, 2048, 240, True), (100, 32, 16, False), (7, 4, 3, True)):
        assert stft.num_stft_frames(T, n_fft, hop, center) == \
            jax_stft.num_stft_frames(T, n_fft, hop, center)
    x = torch.zeros(1, 33600)
    assert stft.stft_mag(x, 2048, 240, 1200).shape[1] == stft.num_stft_frames(33600, 2048, 240)


def test_frame_signal_and_its_gradient_on_an_overrun_are_jaxs():
    """Frames that overrun the signal read x[T-1]; their cotangent goes to
    sample T-1 (mirrors tests/test_stft.py's custom-VJP case)."""
    rng = np.random.default_rng(4)
    T, n_fft, hop = 100, 32, 16
    num_frames = 1 + (T - 1) // hop
    assert (num_frames - 1) * hop + n_fft > T
    x = rng.standard_normal(T).astype(np.float32)
    w = rng.standard_normal((num_frames, n_fft)).astype(np.float32)

    f = lambda x: jnp.sum(jax_stft.frame_signal(x, num_frames, n_fft, hop) * w)
    want_frames = np.asarray(jax_stft.frame_signal(jnp.asarray(x), num_frames, n_fft, hop))
    want_grad = np.asarray(jax.grad(f)(jnp.asarray(x)))

    xt = torch.from_numpy(x).requires_grad_(True)
    frames = stft.frame_signal(xt, num_frames, n_fft, hop)
    (frames * torch.from_numpy(w)).sum().backward()
    assert np.array_equal(frames.detach().numpy(), want_frames)
    np.testing.assert_allclose(xt.grad.numpy(), want_grad, rtol=1e-5, atol=1e-5)
    assert xt.grad[T - 1] != 0
