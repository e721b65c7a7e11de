"""Checkpoints that cross between the JAX package and the port, on the CPU:
a port checkpoint in the JAX package.  `tests/test_torch_reference_resume.py`
takes the other direction.

Both trainers write the reference's `.pth.tar` layout
(`fastvocoder_tpu_torch/train/checkpoint.py`,
`fastvocoder_tpu/train/checkpoint.py`).  A port checkpoint holds `model` and
`discriminator` under exactly the keys, in the order and with the values the
JAX package writes for the same weights, and loads in the JAX package's
`load_checkpoint` into trees of its modules' structure; the JAX generator
and discriminator then compute what the port's do, within 1e-4 of each
output's peak (HiFiGAN, Basis-MelGAN, MultiBand-HiFiGAN under its `trunk`
key map, MelGAN with the MPD, NHV in its flat layout).  It holds no `optimizer`: JAX starts a fresh one.

Narrow configurations and `TINY_DISC`, as the trainer tests use; the
helpers here serve both files.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvocoder_tpu import hparams as jhp
from fastvocoder_tpu.models import nhv as jnhv
from fastvocoder_tpu.train import checkpoint as jck
from fastvocoder_tpu.train import trainer as jtrainer
from fastvocoder_tpu_torch import hparams as thp
from fastvocoder_tpu_torch.checkpoint import checkpoint_format, state_dict_from_jax
from fastvocoder_tpu_torch.train import checkpoint as tck
from fastvocoder_tpu_torch.train import trainer as ttrainer

FIXED = 10
LOSS_RTOL, GRAD_TOL, STEP_TOL, SMALL_GRAD, SYNTH_TOL = 1e-4, 3e-3, 0.02, 1e-4, 1e-4
BASIS_GRAD_TOL, UPDATE_TOL = 1e-2, 1e-3  # see the module docstring
HIFI_ARCH = dict(resblock_kernel_sizes=(3, 5), upsample_rates=(8, 5, 3, 2),
                 upsample_initial_channel=32, upsample_kernel_sizes=(16, 10, 6, 4),
                 resblock_dilation_sizes=((1, 3), (1, 3)))
BASIS_ARCH = dict(out_channels=16, channels=(16, 16, 16))
MELGAN_ARCH = dict(channels=(16, 16, 8, 8, 8))
# MultiBand-HiFiGAN: 4 bands of 60 samples a frame (tests/test_torch_trainer.py's)
MB_ARCH = dict(resblock_kernel_sizes=(3, 5), upsample_rates=(10, 6),
               upsample_initial_channel=32, upsample_kernel_sizes=(20, 12),
               resblock_dilation_sizes=((1, 3), (1, 3)), out_bands=4)
NHV_ARCH = dict(channels=16, ccep_size=32, fir_taps=17, fft_size=512)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(name):
    """(JAX config, port config, discriminator use_mpd, basis or None)."""
    basis = None
    if name == "hifigan":
        make = lambda hp: hp.ModelConfig("hifigan", hp.HiFiGANConfig(**HIFI_ARCH), lambda_stft=5.0)
    elif name == "multiband-hifigan":
        make = lambda hp: hp.ModelConfig(name, hp.HiFiGANConfig(**MB_ARCH), lambda_stft=5.0,
                                         multiband=True)
    elif name == "basis-melgan":
        make = lambda hp: hp.ModelConfig(name, hp.BasisMelGANConfig(**BASIS_ARCH), lambda_stft=1.0)
        basis = (0.1 * np.random.default_rng(3).standard_normal((30, 16))).astype(np.float32)
    elif name == "melgan":
        make = lambda hp: hp.ModelConfig(name, hp.MelGANConfig(**MELGAN_ARCH), lambda_stft=1.0,
                                         use_mpd=True)
    else:
        make = lambda hp: hp.ModelConfig(name, hp.NHVConfig(**NHV_ARCH), lambda_stft=5.0)
    return make(jhp), make(thp), basis


def _jax_trainer(name, use_mpd=False):
    jcfg, _, basis = _cfgs(name)
    disc = dataclasses.replace(jhp.TINY_DISC, use_mpd=use_mpd)
    return jtrainer.make_trainer(jcfg, hp=jhp.HP.replace(fixed_length=FIXED),
                                 basis_signal_weight=basis, disc_cfg=disc)


def _batch(name, seed=7, B=2):
    rng = np.random.default_rng(seed)
    mel = rng.standard_normal((B, FIXED, 80)).astype(np.float32)
    t = np.arange(FIXED * 240, dtype=np.float32)
    wav = np.stack([0.3 * np.sin(2 * np.pi * 220 * (i + 1) * t / 24000) for i in range(B)])
    wav = (wav + 0.01 * rng.standard_normal(wav.shape)).astype(np.float32)
    weight = rng.random((B, FIXED * 16, 16)).astype(np.float32) if name == "basis-melgan" else None
    if name == "nhv":
        f0 = rng.uniform(150.0, 250.0, (B, FIXED)).astype(np.float32)
        f0[rng.random((B, FIXED)) < 0.2] = 0.0
        mel = np.concatenate([mel, f0[..., None]], axis=-1)
    return mel, wav, weight


def _jax_noise(jtr, jstate, mel):
    """The noise the JAX trainer's NHV draws at `jstate.step`."""
    shape = (mel.shape[0], mel.shape[1] * 240)
    draw = lambda module, cond: 0.3 * jax.random.normal(module.make_rng("noise"), shape,
                                                         jnp.float32)
    key = jax.random.fold_in(jax.random.PRNGKey(42), jstate.step)
    return np.array(jtr.generator.apply({"params": jstate.gen_params}, mel,
                                        rngs={"noise": key}, method=draw))


def _port_trainer(name, use_mpd=False, **kw):
    _, tcfg, basis = _cfgs(name)
    disc = dataclasses.replace(thp.TINY_DISC, use_mpd=use_mpd)
    return ttrainer.make_trainer(tcfg, hp=thp.HP.replace(fixed_length=FIXED),
                                 basis_signal_weight=basis, disc_cfg=disc, device="cpu", **kw)


def _as_state_dict(tree):
    return state_dict_from_jax(jax.tree_util.tree_map(np.asarray, tree), fuse=False)


def _jax_sources(cond):
    harm = jnhv.impulse_train(jnp.asarray(cond[..., 80]), 240, 24000)
    noise = 0.3 * jax.random.normal(jax.random.PRNGKey(0), harm.shape, jnp.float32)
    return torch.from_numpy(np.array(harm)), torch.from_numpy(np.array(noise))


def _close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    peak = np.abs(want).max()
    assert np.abs(got - want).max() <= tol * peak, f"{what}: {np.abs(got - want).max():.3e}"


@pytest.mark.parametrize("name", ["hifigan", "basis-melgan", "multiband-hifigan", "melgan", "nhv"])
def test_a_port_checkpoint_loads_in_jax_and_computes_the_same(tmp_path, name):
    use_mpd = name == "melgan"
    ttr = _port_trainer(name, use_mpd=use_mpd)
    state = ttr.init_state(0)
    mel, wav, weight = _batch(name)
    ttr.pre_adv_step(state, torch.from_numpy(mel), torch.from_numpy(wav),
                     None if weight is None else torch.from_numpy(weight))
    path = str(tmp_path / "checkpoint_1.pth.tar")
    tck.save_checkpoint(path, state, name)
    assert checkpoint_format(path) == "reference"

    jtr = _jax_trainer(name, use_mpd=use_mpd)
    init = jtr.init_state(jax.random.PRNGKey(1))
    ck = jck.load_checkpoint(path, jtr.cfg, disc_cfg=jtr.discriminator.cfg)
    assert ck["step"] == 1 and "optimizer" not in ck and "discriminator_optimizer" not in ck
    for got, want in ((ck["gen_params"], init.gen_params), (ck["disc_params"], init.disc_params)):
        assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(
            jax.tree_util.tree_map(np.asarray, want))  # every parameter, nothing more
        assert all(np.shape(a) == np.shape(b) for a, b in zip(jax.tree_util.tree_leaves(got),
                                                              jax.tree_util.tree_leaves(want)))
    # what the JAX package writes for these weights, key for key
    written = torch.load(path, weights_only=False)
    want_model = jck.flax_to_torch(ck["gen_params"], jck.generator_key_map(jtr.cfg)) \
        if name != "nhv" else jck._flatten_native(ck["gen_params"])
    assert list(written["model"]) == list(want_model)
    want_disc = jck.flax_to_torch(ck["disc_params"],
                                  jck.discriminator_key_map(disc_cfg=jtr.discriminator.cfg))
    assert list(written["discriminator"]) == list(want_disc) + list(jck.discriminator_buffers())

    gen = state.generator.eval()
    with torch.no_grad():
        if name == "nhv":
            got = gen(torch.from_numpy(mel), sources=_jax_sources(mel))
        else:
            got = gen(torch.from_numpy(mel))
        d_got = state.discriminator(torch.from_numpy(wav))
    want = jtr.generator.apply({"params": ck["gen_params"]}, jnp.asarray(mel))
    if name != "basis-melgan":
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        _close(g.numpy(), w, 1e-4, "generator")
    d_want = jtr.discriminator.apply({"params": ck["disc_params"]}, jnp.asarray(wav))
    assert len(d_got) == len(d_want)
    for gs, ws in zip(d_got, d_want):
        for g, w in zip(gs, ws):
            _close(g.numpy(), w, 1e-4, "discriminator")
