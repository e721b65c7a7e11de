"""The port's streaming synthesis (`fastvocoder_tpu_torch/models/streaming.py`)
on the CPU, mirroring the five cases of tests/test_streaming.py on the
port's generators: the interior equal to the full pass (atol 1e-5), the
edges within 5e-2; short inputs and a chunk larger than the input; a
forward that is not length-preserving refused; Basis-MelGAN native through
`for_model` (`tail_samples = L // 2`, the pattern subtracted in place, a
short pattern refused).  On the same narrow weights the port's streamer is
held against the JAX package's."""

import jax
import numpy as np
import pytest
import torch

from fastvocoder_tpu import hparams as jhp
from fastvocoder_tpu.models.factory import build_generator as jax_build_generator
from fastvocoder_tpu.models.streaming import StreamingSynthesizer as JaxStreamer
from fastvocoder_tpu_torch import hparams as thp
from fastvocoder_tpu_torch.checkpoint import state_dict_from_jax
from fastvocoder_tpu_torch.models.factory import build_generator
from fastvocoder_tpu_torch.models.streaming import DEFAULT_HALO, StreamingSynthesizer

SPF = 240


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(name, seed, basis=None):
    """A narrow JAX generator with its parameters and the port's generator
    with the same weights."""
    if name == "melgan":
        make = lambda hp: hp.ModelConfig("melgan", hp.MelGANConfig(channels=(8, 8, 8, 8, 8)))
    else:
        make = lambda hp: hp.ModelConfig(
            "basis-melgan", hp.BasisMelGANConfig(out_channels=16, channels=(16, 16, 16)))
    kw = {} if basis is None else dict(basis_signal_weight=basis)
    jgen = jax_build_generator(make(jhp), **kw)
    params = jax.jit(jgen.init)(jax.random.PRNGKey(seed), np.zeros((1, 8, 80), np.float32))["params"]
    gen = build_generator(make(thp), **kw)
    gen.load_state_dict(state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return jgen, params, gen.eval().requires_grad_(False)


def _full(gen, mel):
    with torch.inference_mode():
        return gen.inference(torch.from_numpy(mel[None]))[0].numpy()


def test_streaming_matches_full_pass():
    rng = np.random.default_rng(0)
    jgen, params, gen = _pair("melgan", 0)
    T = 150  # not a multiple of the chunk: the tail path
    mel = rng.standard_normal((T, 80)).astype(np.float32)
    full = _full(gen, mel)
    s = StreamingSynthesizer(gen.inference, samples_per_frame=SPF, chunk_frames=64,
                             halo_frames=16, device="cpu")
    streamed = s(mel)
    assert streamed.shape == full.shape
    edge = 16 * SPF
    np.testing.assert_allclose(streamed[edge:-edge], full[edge:-edge], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(streamed, full, atol=5e-2)
    # the JAX streamer on the same weights
    fwd = lambda p, m: jgen.apply({"params": p}, m)
    want = JaxStreamer(fwd, params, samples_per_frame=SPF, chunk_frames=64, halo_frames=16)(mel)
    np.testing.assert_allclose(streamed, want, atol=1e-5 * max(1.0, np.abs(want).max()))


def test_streaming_single_chunk_short_input():
    _, _, gen = _pair("melgan", 1)
    s = StreamingSynthesizer(gen.inference, samples_per_frame=SPF, chunk_frames=64,
                             halo_frames=8, device="cpu")
    out = s(np.random.default_rng(1).standard_normal((20, 80)).astype(np.float32))
    assert out.shape == (20 * SPF,) and np.isfinite(out).all()


def test_streaming_very_short_input_large_chunk():
    """A pad larger than the piece: the reflect padding in rounds."""
    rng = np.random.default_rng(2)
    _, _, gen = _pair("melgan", 2)
    s = StreamingSynthesizer(gen.inference, samples_per_frame=SPF, chunk_frames=256,
                             halo_frames=DEFAULT_HALO, device="cpu")
    for T in (1, 3, 7):
        out = s(rng.standard_normal((T, 80)).astype(np.float32))
        assert out.shape == (T * SPF,) and np.isfinite(out).all()


def test_streaming_rejects_non_length_preserving():
    fwd = lambda m: torch.zeros(1, (m.shape[1] + 1) * SPF)
    s = StreamingSynthesizer(fwd, samples_per_frame=SPF, chunk_frames=32, halo_frames=4,
                             device="cpu")
    with pytest.raises(ValueError, match="forward emitted"):
        s(np.random.default_rng(3).standard_normal((16, 80)).astype(np.float32))


def test_streaming_basis_melgan_native():
    """`for_model` absorbs the raw decode's L/2 tail per chunk and subtracts
    the pattern position-aligned (reference bin/test.py:85-88)."""
    rng = np.random.default_rng(4)
    basis = rng.standard_normal((30, 16)).astype(np.float32)
    jgen, params, gen = _pair("basis-melgan", 2, basis)
    T = 150
    mel = rng.standard_normal((T, 80)).astype(np.float32)
    pattern = _full(gen, np.zeros((256, 80), np.float32))  # the published protocol
    full = _full(gen, mel)[: T * SPF] - pattern[: T * SPF]
    s = StreamingSynthesizer.for_model(gen, "basis-melgan", chunk_frames=64, halo_frames=16,
                                       pattern=pattern, device="cpu")
    assert s.tail == 15
    streamed = s(mel)
    assert streamed.shape == full.shape
    edge = 16 * SPF
    np.testing.assert_allclose(streamed[edge:-edge], full[edge:-edge], atol=1e-5, rtol=1e-5)
    want = JaxStreamer.for_model(jgen, params, "basis-melgan", chunk_frames=64, halo_frames=16,
                                 pattern=pattern)(mel)
    np.testing.assert_allclose(streamed, want, atol=1e-5 * max(1.0, np.abs(want).max()))

    short = StreamingSynthesizer.for_model(gen, "basis-melgan", chunk_frames=64, halo_frames=16,
                                           pattern=pattern[: 100 * SPF], device="cpu")
    with pytest.raises(ValueError, match="pattern covers"):
        short(mel)
