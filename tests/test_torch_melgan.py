"""The port's MelGAN generator, and Basis-MelGAN's nearest-neighbour and
causal variants, against the JAX package's, on the CPU, and MelGAN's entry
points with `device="cpu"`.

1. Narrow random-weight generators in the weight-norm (training) form, the
   JAX parameters carried by `state_dict_from_jax(..., fuse=False)`: the
   port's output within 1e-5 of the JAX output's peak (measured 2.3e-7
   to 6.5e-7 of it), and the fused form loaded from the same tree alike.
   MelGAN non-causal (scales 10, 6, 2, 2, all even) and causal (scales 5,
   3, 4, 4: odd scales take an output padding); Basis-MelGAN with
   nearest-neighbour upsampling, and with causal stacks.
2. `docs/checkpoints/melgan_clean.npz` (step 5735) at full width on a
   seeded 64-frame mel: the port's `inference` within max abs 1e-4 of the
   JAX generator's (measured 1.8e-6, peak 0.73: float32 summation order).
3. `Synthesizer`, the RTF protocol and `ServingModel` for MelGAN:
   waveforms of T * 240 samples, no pattern, no wavs written.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvocoder_tpu import hparams as jhp
from fastvocoder_tpu.models.factory import build_generator as jax_build_generator
from fastvocoder_tpu.train.checkpoint import fuse_weight_norm
from fastvocoder_tpu_torch import hparams as thp
from fastvocoder_tpu_torch.bin.synthesize import Synthesizer
from fastvocoder_tpu_torch.bin.test import run_test
from fastvocoder_tpu_torch.checkpoint import load_release_npz, state_dict_from_jax
from fastvocoder_tpu_torch.models.factory import build_generator
from fastvocoder_tpu_torch.models.layers import apply_residual_stacks
from fastvocoder_tpu_torch.serving import ServingModel

ROOT = os.path.join(os.path.dirname(__file__), "..")
MELGAN = (os.path.join(ROOT, "docs", "checkpoints", "melgan_clean.npz"),
          os.path.join(ROOT, "conf", "melgan", "original.yaml"), "melgan")
NARROW_MELGAN = dict(channels=(32, 16, 16, 8, 8))
NARROW_BASIS = dict(out_channels=16, channels=(16, 16, 16))
VARIANTS = {
    "melgan": ("melgan", dict(NARROW_MELGAN)),
    "melgan-causal": ("melgan", dict(NARROW_MELGAN, upsample_scales=(5, 3, 4, 4),
                                     use_causal_conv=True)),
    "basis-melgan-nearest": ("basis-melgan", dict(NARROW_BASIS, transposedconv=False)),
    "basis-melgan-causal": ("basis-melgan", dict(NARROW_BASIS, use_causal_conv=True)),
}


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
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), f"max abs {err:.3e}, peak {np.abs(want).max():.3e}"


def _cfgs(name, arch):
    if name == "melgan":
        return (jhp.ModelConfig(name, jhp.MelGANConfig(**arch)),
                thp.ModelConfig(name, thp.MelGANConfig(**arch)))
    return (jhp.ModelConfig(name, jhp.BasisMelGANConfig(**arch)),
            thp.ModelConfig(name, thp.BasisMelGANConfig(**arch)))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_narrow_generator_matches_jax(variant):
    name, arch = VARIANTS[variant]
    jcfg, tcfg = _cfgs(name, arch)
    mel = _mel(12, 1, B=2)
    basis = None
    if name == "basis-melgan":
        basis = (0.1 * np.random.default_rng(2).standard_normal((30, 16))).astype(np.float32)
    jgen = jax_build_generator(jcfg, basis_signal_weight=basis)
    params = jax.jit(jgen.init)(jax.random.PRNGKey(0), mel)["params"]
    tree = jax.tree_util.tree_map(np.asarray, params)
    if arch.get("use_causal_conv"):
        assert "kernel" in tree["stack_0_0"]["conv_dilated"]["conv"]
    train_form = build_generator(tcfg, weight_norm=True, basis_signal_weight=basis)
    train_form.load_state_dict(state_dict_from_jax(tree, fuse=False))
    fused = build_generator(tcfg)
    fused.load_state_dict(state_dict_from_jax(tree))

    if name == "melgan":
        want = np.asarray(jgen.apply({"params": params}, mel))
        with torch.no_grad():
            got, folded = (g(torch.from_numpy(mel)).numpy() for g in (train_form, fused))
        scales = int(np.prod(arch.get("upsample_scales", (10, 6, 2, 2))))
        assert got.shape == (2, 12 * scales)
    else:
        want = np.asarray(jgen.apply({"params": params}, mel, method=jgen.inference))
        with torch.no_grad():
            got, folded = (g.inference(torch.from_numpy(mel)).numpy() for g in (train_form, fused))
    _close(got, want)
    _close(folded, want)


def test_causal_stacks_run_as_modules_everywhere():
    """A causal stage never reaches the chain kernel: on any device it is
    the modules' function (here on the CPU, where a non-causal stage is
    too)."""
    _, tcfg = _cfgs("melgan", VARIANTS["melgan-causal"][1])
    gen = build_generator(tcfg)
    x = torch.randn(1, 64, 16)
    want = x
    for m in gen.stacks[0]:
        want = m(want)
    torch.testing.assert_close(apply_residual_stacks(x, gen.stacks[0]), want, rtol=0, atol=0)
    # past the left edge's reflection (rows up to 2 + 6 + 18 = 26 for
    # dilations 1, 3, 9) an output reads no later row: a change from row 48
    # on leaves every row before it alone
    y = x.clone()
    y[:, 48:] += 1.0
    a, b = (apply_residual_stacks(v, gen.stacks[0]) for v in (x, y))
    torch.testing.assert_close(a[:, :48], b[:, :48], rtol=0, atol=0)
    assert (a[:, 48:] - b[:, 48:]).abs().max() > 1e-3


def test_release_checkpoint_matches_jax():
    npz, conf, name = MELGAN
    ckpt = load_release_npz(npz)
    assert ckpt["model_name"] == name and ckpt["pattern"] is None
    mel = _mel(64, 0)
    with np.load(npz) as z:
        flat = {k[len("param:"):]: z[k].astype(np.float32) for k in z.files
                if k.startswith("param:")}
        meta = json.loads(str(z["meta"]))
    assert meta["model_name"] == name and meta["step"] == 5735
    jgen = jax_build_generator(jhp.load_model_config(name, conf), weight_norm=False)
    want = np.asarray(jax.jit(lambda p, m: jgen.apply({"params": p}, m))(
        fuse_weight_norm(_unflatten(flat)), jnp.asarray(mel)))
    tgen = build_generator(thp.load_model_config(name, conf))
    tgen.load_state_dict(ckpt["state_dict"])  # strict: every key carried
    with torch.inference_mode():
        got = tgen.inference(torch.from_numpy(mel)).numpy()
    assert got.shape == want.shape == (1, 64 * 240)
    assert np.abs(got - want).max() <= 1e-4


@pytest.fixture(scope="module")
def melgan_synth():
    return Synthesizer(*MELGAN, device="cpu")


def test_synthesizer_trims_melgan_to_frames_times_hop(melgan_synth):
    mel = _mel(30, 5)[0]
    est, est_remove, bias = melgan_synth.synthesize(mel)
    assert est.shape == est_remove.shape == bias.shape == (30 * 240,)
    np.testing.assert_array_equal(est - bias, est_remove)
    assert melgan_synth.pattern is None and np.isfinite(est).all()
    with torch.inference_mode():
        want = melgan_synth.generator(torch.from_numpy(mel[None]))[0].numpy()
    np.testing.assert_array_equal(est, want)


def test_rtf_protocol_writes_no_wavs_for_melgan(tmp_path):
    np.save(tmp_path / "utt.npy", _mel(16, 6)[0].T)
    rtf = run_test(["--checkpoint_path", MELGAN[0], "--file_path", str(tmp_path),
                    "--config", MELGAN[1], "--model_name", "melgan", "--device", "cpu"])
    assert np.isfinite(rtf) and rtf > 0
    assert not list(tmp_path.glob("*.wav"))


def test_serving_model_serves_melgan(melgan_synth):
    model = ServingModel(*MELGAN, bucket_frames=32, max_batch=4, device="cpu")
    assert model.input_channels == 80 and model.pattern is None
    mels = [_mel(T, 7 + T)[0] for T in (12, 30)]
    for mel, wav in zip(mels, model(mels)):
        assert wav.shape == (mel.shape[0] * 240,)
        padded = torch.from_numpy(np.pad(mel, ((0, 32 - mel.shape[0]), (0, 0)))[None])
        with torch.inference_mode():
            direct = melgan_synth.generator(padded)[0, : wav.shape[0]].numpy()
        _close(wav, direct)  # batch 2 against batch 1: float32 summation order only
