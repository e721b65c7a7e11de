"""The port's Basis-MelGAN generator against the JAX package's, on the CPU.

1. A narrow random-weight configuration in the weight-norm (training) form:
   the JAX parameters go through `state_dict_from_jax`, and `inference`
   and `forward` (with its zero-input bias subtraction) must match the JAX
   `inference` and `__call__`.
2. The release checkpoint `docs/checkpoints/basis_melgan_clean2.npz` at full
   width on a seeded 64-frame mel: the port's `inference` must match the
   JAX `inference` within max abs 1e-4 (the waveform peaks near 3.4; the
   two sides differ only in float32 summation order).
"""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fastvocoder_tpu.hparams import BasisMelGANConfig as JaxConfig
from fastvocoder_tpu.hparams import load_model_config as jax_load_config
from fastvocoder_tpu.models.basis_melgan import BasisMelGANGenerator as JaxGenerator
from fastvocoder_tpu.models.factory import build_generator as jax_build_generator
from fastvocoder_tpu.train.checkpoint import fuse_weight_norm
from fastvocoder_tpu_torch.checkpoint import load_release_npz, state_dict_from_jax
from fastvocoder_tpu_torch.hparams import BasisMelGANConfig, ModelConfig, load_model_config
from fastvocoder_tpu_torch.models.basis_melgan import BasisMelGANGenerator
from fastvocoder_tpu_torch.models.factory import build_generator

ROOT = os.path.join(os.path.dirname(__file__), "..")
NPZ = os.path.join(ROOT, "docs", "checkpoints", "basis_melgan_clean2.npz")
CONF = os.path.join(ROOT, "conf", "basis-melgan", "light.yaml")
NARROW = dict(L=30, in_channels=80, out_channels=32, kernel_size=7,
              channels=(32, 32, 32), upsample_scales=(4, 4), stacks=3)


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


def _mel(T, seed):
    rng = np.random.default_rng(seed)
    return np.clip(0.5 + 0.25 * rng.standard_normal((1, T, 80)), 0, 1).astype(np.float32)


def _unflatten(flat):
    tree = {}
    for key, v in flat.items():
        *parents, leaf = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


@pytest.fixture(scope="module")
def narrow():
    mel = _mel(20, 1)
    basis = (0.1 * np.random.default_rng(2).standard_normal((30, 32))).astype(np.float32)
    jgen = JaxGenerator(cfg=JaxConfig(**NARROW), basis_init=basis)
    params = jax.jit(jgen.init)(jax.random.PRNGKey(0), mel)["params"]
    assert "g" in params["conv_pre"] and "gt" in params["up_0"]  # weight-norm form
    tgen = BasisMelGANGenerator(BasisMelGANConfig(**NARROW))
    tgen.load_state_dict(state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return mel, jgen, params, tgen


def _close(got, want, rel=1e-5):
    tol = rel * max(1.0, float(np.abs(want).max()))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol


def test_narrow_inference_matches_jax(narrow):
    mel, jgen, params, tgen = narrow
    want = np.asarray(jgen.apply({"params": params}, mel, method=jgen.inference))
    with torch.inference_mode():
        got = tgen.inference(torch.from_numpy(mel)).numpy()
    assert got.shape == (1, (20 * 16 + 1) * 15)
    _close(got, want)


def test_narrow_forward_matches_jax(narrow):
    mel, jgen, params, tgen = narrow
    want_src, want_w = (np.asarray(a) for a in jgen.apply({"params": params}, mel))
    with torch.no_grad():
        got_src, got_w = (a.numpy() for a in tgen(torch.from_numpy(mel)))
    _close(got_src, want_src)
    _close(got_w, want_w)


def test_flat_and_nested_trees_convert_alike(narrow):
    _, _, params, _ = narrow
    nested = jax.tree_util.tree_map(np.asarray, params)
    flat = {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    a, b = state_dict_from_jax(nested), state_dict_from_jax(flat)
    assert a.keys() == b.keys()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


def test_fused_tree_converts_like_weight_norm_tree(narrow):
    """A tree fused by the JAX package's fuse_weight_norm converts to the
    same weights as the weight-norm tree fused by the port."""
    _, _, params, _ = narrow
    tree = jax.tree_util.tree_map(np.asarray, params)
    a = state_dict_from_jax(tree)
    b = state_dict_from_jax(fuse_weight_norm(tree))
    assert a.keys() == b.keys()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=1e-6, atol=1e-7)


def test_release_checkpoint_matches_jax_inference():
    ckpt = load_release_npz(NPZ)
    assert ckpt["model_name"] == "basis-melgan"
    assert ckpt["pattern"].shape == (3000 * 240 + 15,)
    mel = _mel(64, 0)

    with np.load(NPZ) as z:
        flat = {k[len("param:"):]: z[k].astype(np.float32) for k in z.files if k.startswith("param:")}
        meta = json.loads(str(z["meta"]))
    assert meta["model_name"] == "basis-melgan"
    jgen = jax_build_generator(jax_load_config("basis-melgan", CONF), weight_norm=False)
    jparams = fuse_weight_norm(_unflatten(flat))
    want = np.asarray(jax.jit(lambda p, m: jgen.apply({"params": p}, m, method=jgen.inference))(
        jparams, jnp.asarray(mel)))

    tgen = build_generator(load_model_config("basis-melgan", CONF))
    tgen.load_state_dict(ckpt["state_dict"])
    with torch.inference_mode():
        got = tgen.inference(torch.from_numpy(mel)).numpy()
    assert got.shape == want.shape == (1, (64 * 16 + 1) * 15)
    assert np.abs(got - want).max() <= 1e-4


def test_other_families_are_not_ported_yet():
    """Every family is ported now: MelGAN and NHV build at full width in
    both forms (held against the JAX package in test_torch_melgan.py and
    test_torch_nhv.py), and so do Basis-MelGAN's other variants."""
    for name, conf in (("melgan", "melgan/original.yaml"), ("nhv", "nhv/default.yaml")):
        cfg = load_model_config(name, os.path.join(ROOT, "conf", conf))
        for weight_norm in (False, True):
            gen = build_generator(cfg, weight_norm=weight_norm)
            assert callable(gen.inference)
    for variant in (dict(transposedconv=False), dict(use_causal_conv=True)):
        build_generator(ModelConfig("basis-melgan", BasisMelGANConfig(**NARROW, **variant)))
