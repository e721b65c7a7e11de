"""The port's HiFiGAN and MultiBand-HiFiGAN generators against the JAX
package's, on the CPU, and their entry points with `device="cpu"`.

1. Narrow random-weight configurations in the weight-norm (training) form:
   the JAX parameters go through `state_dict_from_jax` (`g` and `gt`
   weight norm, the `trunk/` prefix), and the port's output must match the
   JAX generator's within 1e-5 of the peak.  Variants: ResBlock1 with
   transposed convs, ResBlock2, nearest-neighbour upsampling, and the
   4-band trunk with PQMF synthesis.
2. The release checkpoints at full width on a seeded 64-frame mel, within
   max abs 1e-4: HiFiGAN light against the JAX `apply` (measured 3.2e-6,
   peak 0.73) and MultiBand-HiFiGAN light against the JAX `synthesize`
   (measured 4.1e-6, peak 0.77), both float32 on this CPU.
3. PQMF against the JAX package's filterbank.
4. `Synthesizer`, the RTF protocol and `ServingModel` for the HiFiGAN
   families: waveforms of T * 240 samples, no pattern, no wavs written by
   the RTF protocol, each family's waveform method.
"""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fastvocoder_tpu.hparams import HiFiGANConfig as JaxConfig
from fastvocoder_tpu.hparams import load_model_config as jax_load_config
from fastvocoder_tpu.models.factory import build_generator as jax_build_generator
from fastvocoder_tpu.models.hifigan import HiFiGANGenerator as JaxHiFiGAN
from fastvocoder_tpu.models.multiband_hifigan import MultiBandHiFiGANGenerator as JaxMBHiFiGAN
from fastvocoder_tpu.ops.pqmf import PQMF as JaxPQMF
from fastvocoder_tpu.ops.pqmf import design_prototype_filter as jax_prototype
from fastvocoder_tpu.train.checkpoint import fuse_weight_norm
from fastvocoder_tpu_torch.bin.synthesize import Synthesizer
from fastvocoder_tpu_torch.bin.test import Synthesizer as RtfSynthesizer
from fastvocoder_tpu_torch.bin.test import run_test
from fastvocoder_tpu_torch.checkpoint import load_release_npz, state_dict_from_jax
from fastvocoder_tpu_torch.hparams import HiFiGANConfig, load_model_config
from fastvocoder_tpu_torch.models.factory import build_generator
from fastvocoder_tpu_torch.models.hifigan import HiFiGANGenerator
from fastvocoder_tpu_torch.models.multiband_hifigan import MultiBandHiFiGANGenerator
from fastvocoder_tpu_torch.ops.pqmf import PQMF, design_prototype_filter
from fastvocoder_tpu_torch.serving import ServingModel

ROOT = os.path.join(os.path.dirname(__file__), "..")
HIFI = (os.path.join(ROOT, "docs", "checkpoints", "hifigan_light_clean2.npz"),
        os.path.join(ROOT, "conf", "hifigan", "light.yaml"), "hifigan")
MB = (os.path.join(ROOT, "docs", "checkpoints", "mb_hifigan_light_clean.npz"),
      os.path.join(ROOT, "conf", "multiband-hifigan", "light.yaml"), "multiband-hifigan")
NARROW = dict(resblock_kernel_sizes=(3, 5), upsample_rates=(4, 2), upsample_initial_channel=32,
              upsample_kernel_sizes=(8, 4), resblock_dilation_sizes=((1, 3), (1, 3)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs, restored afterwards:
    pytest-xdist runs several test processes side by side, and torch's
    default of a thread a core in each made these small-op tests over 20x
    slower (six processes on eight cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mel(T, seed, B=1):
    rng = np.random.default_rng(seed)
    return np.clip(0.5 + 0.25 * rng.standard_normal((B, T, 80)), 0, 1).astype(np.float32)


def _unflatten(flat):
    tree = {}
    for key, v in flat.items():
        *parents, leaf = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _close(got, want, rel=1e-5):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * max(1.0, float(np.abs(want).max()))


@pytest.mark.parametrize("variant", [
    dict(),
    dict(resblock_type="2", resblock_dilation_sizes=((1, 3), (1, 3))),
    dict(transposedconv=False, upsample_kernel_sizes=(9, 5)),
    dict(out_bands=4),
], ids=["resblock1", "resblock2", "nearest-upsample", "multiband"])
def test_narrow_generator_matches_jax(variant):
    kw = {**NARROW, **variant}
    mel = _mel(10, 1, B=2)
    multiband = kw.get("out_bands", 1) == 4
    jgen = (JaxMBHiFiGAN if multiband else JaxHiFiGAN)(cfg=JaxConfig(**kw))
    params = jax.jit(jgen.init)(jax.random.PRNGKey(0), mel)["params"]
    tree = jax.tree_util.tree_map(np.asarray, params)
    assert "g" in str(jax.tree_util.tree_structure(tree))  # weight-norm form
    tgen = (MultiBandHiFiGANGenerator if multiband else HiFiGANGenerator)(HiFiGANConfig(**kw))
    tgen.load_state_dict(state_dict_from_jax(tree))
    with torch.inference_mode():
        got = tgen(torch.from_numpy(mel)).numpy()
        wav = tgen.inference(torch.from_numpy(mel)).numpy()
    want = np.asarray(jgen.apply({"params": params}, mel))
    _close(got, want)
    if multiband:
        assert got.shape == (2, 10 * 8, 4)
        want_wav = np.asarray(jgen.apply({"params": params}, mel, method=jgen.synthesize))
        _close(wav, want_wav)
        assert wav.shape == (2, 10 * 8 * 4)
    else:
        assert got.shape == (2, 10 * 8)
        np.testing.assert_array_equal(wav, got)


@pytest.mark.parametrize("ckpt", [HIFI, MB], ids=["hifigan", "multiband-hifigan"])
def test_release_checkpoint_matches_jax(ckpt):
    npz, conf, name = ckpt
    ckpt_port = load_release_npz(npz)
    assert ckpt_port["model_name"] == name and ckpt_port["pattern"] is None
    mel = _mel(64, 0)
    with np.load(npz) as z:
        flat = {k[len("param:"):]: z[k].astype(np.float32) for k in z.files
                if k.startswith("param:")}
        assert json.loads(str(z["meta"]))["model_name"] == name
    jgen = jax_build_generator(jax_load_config(name, conf), weight_norm=False)
    jparams = fuse_weight_norm(_unflatten(flat))
    if name == "hifigan":
        fn = lambda p, m: jgen.apply({"params": p}, m)
    else:
        fn = lambda p, m: jgen.apply({"params": p}, m, method=jgen.synthesize)
    want = np.asarray(jax.jit(fn)(jparams, jnp.asarray(mel)))

    tgen = build_generator(load_model_config(name, conf))
    tgen.load_state_dict(ckpt_port["state_dict"])  # strict: every key carried
    with torch.inference_mode():
        got = tgen.inference(torch.from_numpy(mel)).numpy()
    assert got.shape == want.shape == (1, 64 * 240)
    assert np.abs(got - want).max() <= 1e-4


def test_pqmf_matches_jax():
    np.testing.assert_allclose(design_prototype_filter(), jax_prototype(), rtol=0, atol=1e-15)
    x = np.random.default_rng(3).standard_normal((2, 37, 4)).astype(np.float32)
    port, ref = PQMF(), JaxPQMF()
    with torch.no_grad():
        syn = port.synthesis(torch.from_numpy(x)).numpy()
        sig = torch.from_numpy(syn)
        ana = port.analysis(sig).numpy()
    want_syn = np.asarray(ref.synthesis(jnp.asarray(x)))
    assert syn.shape == want_syn.shape == (2, 37 * 4, 1)
    np.testing.assert_allclose(syn, want_syn, atol=1e-5, rtol=1e-5)
    want_ana = np.asarray(ref.analysis(jnp.asarray(syn)))
    assert ana.shape == want_ana.shape == (2, 37, 4)
    np.testing.assert_allclose(ana, want_ana, atol=1e-5, rtol=1e-5)
    assert not list(port.state_dict())  # the filters are not checkpoint entries


@pytest.fixture(scope="module")
def hifigan_synth():
    return Synthesizer(*HIFI, device="cpu")


def test_synthesizer_trims_hifigan_to_frames_times_hop(hifigan_synth):
    mel = _mel(45, 5)[0]
    est, est_remove, bias = hifigan_synth.synthesize(mel)
    assert est.shape == est_remove.shape == bias.shape == (45 * 240,)
    np.testing.assert_array_equal(est - bias, est_remove)
    assert hifigan_synth.L is None and hifigan_synth.pattern is None
    bucketed = Synthesizer(*HIFI, bucket_frames=64, device="cpu")
    wav = bucketed._run(mel)
    assert wav.shape == (45 * 240,)
    with torch.inference_mode():
        padded = np.pad(mel, ((0, 19), (0, 0)))[None]
        want = hifigan_synth.generator(torch.from_numpy(padded))[0, : 45 * 240].numpy()
    np.testing.assert_array_equal(wav, want)


def test_rtf_protocol_writes_no_wavs_for_hifigan(tmp_path):
    np.save(tmp_path / "utt.npy", _mel(20, 6)[0].T)
    rtf = run_test(["--checkpoint_path", HIFI[0], "--file_path", str(tmp_path),
                    "--config", HIFI[1], "--model_name", "hifigan", "--device", "cpu"])
    assert np.isfinite(rtf) and rtf > 0
    assert not list(tmp_path.glob("*.wav"))
    with pytest.raises(ValueError, match="Basis-MelGAN"):
        RtfSynthesizer(*HIFI, device="cpu").synthesize(_mel(20, 6)[0])


@pytest.mark.parametrize("ckpt", [HIFI, MB], ids=["hifigan", "multiband-hifigan"])
def test_serving_model_uses_the_family_waveform(ckpt):
    model = ServingModel(*ckpt, bucket_frames=64, max_batch=4, device="cpu")
    mels = [_mel(T, 7 + T)[0] for T in (20, 45)]
    wavs = model(mels)
    gen = model.generator
    for mel, wav in zip(mels, wavs):
        assert wav.shape == (mel.shape[0] * 240,)
        padded = torch.from_numpy(np.pad(mel, ((0, 64 - mel.shape[0]), (0, 0)))[None])
        with torch.inference_mode():
            direct = gen(padded) if ckpt is HIFI else gen.synthesize(padded)
        # batch 2 against batch 1: float32 summation order only
        _close(wav, direct[0, : wav.shape[0]].numpy())
