"""`state_dict_from_jax(..., fuse=False)` and the port's own training
checkpoints (`fastvocoder_tpu_torch/train/checkpoint.py`), on the CPU.

The training form loaded with the gains kept computes what the fused form
computes from the folded weights, and what the JAX generator computes from
the same tree, both within 1e-4 of the output's peak (the fold is done in
numpy on one side and in torch on the other, and Basis-MelGAN's output is
the difference of two trunk passes, which cancels most of the peak).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvocoder_tpu import hparams as jhp
from fastvocoder_tpu.models.factory import build_generator as jax_build_generator
from fastvocoder_tpu_torch import hparams as thp
from fastvocoder_tpu_torch.checkpoint import state_dict_from_jax
from fastvocoder_tpu_torch.models.factory import build_generator
from fastvocoder_tpu_torch.train.checkpoint import (
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from fastvocoder_tpu_torch.train.trainer import make_trainer

HIFI_ARCH = dict(resblock_kernel_sizes=(3, 5), upsample_rates=(8, 5, 3, 2),
                 upsample_initial_channel=32, upsample_kernel_sizes=(16, 10, 6, 4),
                 resblock_dilation_sizes=((1, 3), (1, 3)))
BASIS_ARCH = dict(out_channels=16, channels=(16, 16, 16))


def _cfgs(name):
    if name == "basis-melgan":
        return (jhp.ModelConfig(name, jhp.BasisMelGANConfig(**BASIS_ARCH)),
                thp.ModelConfig(name, thp.BasisMelGANConfig(**BASIS_ARCH)))
    bands = 4 if name == "multiband-hifigan" else 1
    return (jhp.ModelConfig(name, jhp.HiFiGANConfig(out_bands=bands, **HIFI_ARCH),
                            multiband=bands > 1),
            thp.ModelConfig(name, thp.HiFiGANConfig(out_bands=bands, **HIFI_ARCH),
                            multiband=bands > 1))


def _jax_params(name, mel):
    jcfg, _ = _cfgs(name)
    basis = None
    if name == "basis-melgan":
        basis = (0.1 * np.random.default_rng(5).standard_normal((30, 16))).astype(np.float32)
    gen = jax_build_generator(jcfg, basis_signal_weight=basis)
    params = jax.jit(gen.init)(jax.random.PRNGKey(1), jnp.asarray(mel))["params"]
    # move the gains off the norms, so that folding them is not a no-op
    rng = np.random.default_rng(6)
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: v * rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        if path[-1].key in ("g", "gt") else v, params)
    return gen, params


@pytest.mark.parametrize("name", ["hifigan", "multiband-hifigan", "basis-melgan"])
def test_unfused_state_matches_jax_and_the_fused_form(name):
    mel = np.random.default_rng(0).standard_normal((2, 12, 80)).astype(np.float32)
    jgen, params = _jax_params(name, mel)
    tree = jax.tree_util.tree_map(np.asarray, params)
    _, tcfg = _cfgs(name)

    unfused = state_dict_from_jax(tree, fuse=False)
    assert any(k.endswith(".g") for k in unfused) and any(k.endswith(".gt") for k in unfused)
    train_form = build_generator(tcfg, weight_norm=True)
    train_form.load_state_dict(unfused)  # strict: every key maps
    fused_form = build_generator(tcfg)
    fused_form.load_state_dict(state_dict_from_jax(tree))

    want = jgen.apply({"params": params}, jnp.asarray(mel))
    with torch.no_grad():
        got, folded = train_form(torch.from_numpy(mel)), fused_form(torch.from_numpy(mel))
    if name != "basis-melgan":
        got, folded, want = (got,), (folded,), (want,)
    for g, f, w in zip(got, folded, want):
        w = np.asarray(w)
        peak = np.abs(w).max()
        assert tuple(g.shape) == w.shape
        assert np.abs(g.numpy() - w).max() <= 1e-4 * peak
        assert (g - f).abs().max().item() <= 1e-4 * peak


def test_training_checkpoint_round_trip_and_latest(tmp_path):
    _, tcfg = _cfgs("hifigan")
    trainer = make_trainer(tcfg, hp=thp.HP.replace(fixed_length=10), disc_cfg=thp.TINY_DISC,
                           device="cpu")
    state = trainer.init_state(0)
    rng = np.random.default_rng(0)
    mel = torch.from_numpy(rng.standard_normal((2, 10, 80)).astype(np.float32))
    wav = torch.from_numpy((0.1 * rng.standard_normal((2, 2400))).astype(np.float32))
    trainer.gan_step(state, mel, wav)
    os_dir = tmp_path / "checkpoint" / "stamp"
    os_dir.mkdir(parents=True)
    save_checkpoint(str(os_dir / "checkpoint_1.pth.tar"), state, "hifigan")
    trainer.gan_step(state, mel, wav)
    save_checkpoint(str(os_dir / "checkpoint_2.pth.tar"), state, "hifigan")
    (os_dir / "checkpoint_x.pth.tar").write_text("not a step")
    assert latest_checkpoint(str(tmp_path)) == str(os_dir / "checkpoint_2.pth.tar")
    assert latest_checkpoint(str(tmp_path / "checkpoint" / "stamp" / "none")) is None

    fresh = trainer.init_state(1)
    load_checkpoint(str(os_dir / "checkpoint_2.pth.tar"), fresh, "hifigan")
    assert (fresh.step, fresh.gen_updates, fresh.disc_updates) == (2, 2, 2)
    for a, b in ((state.generator, fresh.generator), (state.discriminator, fresh.discriminator)):
        for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
            torch.testing.assert_close(w, v, rtol=0, atol=0, msg=k)
    # the optimiser's moments came too: the next step is the same step
    trainer.gan_step(state, mel, wav)
    trainer.gan_step(fresh, mel, wav)
    for v, w in zip(state.generator.parameters(), fresh.generator.parameters()):
        torch.testing.assert_close(w, v, rtol=0, atol=0)

    with pytest.raises(ValueError, match="not 'basis-melgan'"):
        load_checkpoint(str(os_dir / "checkpoint_2.pth.tar"), fresh, "basis-melgan")
