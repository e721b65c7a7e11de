"""`state_dict_from_jax(..., fuse=False)` and the port's own training
checkpoints (`fastvocoder_tpu_torch/train/checkpoint.py`), on the CPU.

The training form loaded with the gains kept computes what the fused form
computes from the folded weights, and what the JAX generator computes from
the same tree, both within 1e-4 of the output's peak (the fold is done in
numpy on one side and in torch on the other, and Basis-MelGAN's output is
the difference of two trunk passes, which cancels most of the peak).

The leaves that are not 1-D conv nodes carry across both ways: a leaf of
the tree's root (NHV's FIR `fir`, (taps, 1, 1)) keeps its name and layout,
and the MPD's 2-D kernels (kh, kw, Cin, Cout) become (Cout, Cin, kh, kw),
their gain normalising each output channel over (kh, kw, Cin), fused as the
JAX package's `fuse_weight_norm` fuses them (within 1e-6; measured: the
same bits) or kept.  Any
other leaf is refused by name.  Both new release checkpoints load.

A checkpoint loads the same with `compute_dtype=torch.bfloat16`: every
release checkpoint and a checkpoint of the port's trainer, the same
float32 parameters and a model that computes in bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvocoder_tpu import hparams as jhp
from fastvocoder_tpu.models.factory import build_generator as jax_build_generator
from fastvocoder_tpu.train.checkpoint import fuse_weight_norm
from fastvocoder_tpu_torch import hparams as thp
from fastvocoder_tpu_torch.checkpoint import (
    jax_tree_from_state_dict,
    load_release_npz,
    state_dict_from_jax,
)
from fastvocoder_tpu_torch.models.discriminator.mpd import Conv2d
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


def _root_and_2d_tree():
    rng = np.random.default_rng(11)
    f32 = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    return {
        "fir": f32(17, 1, 1),
        "mpd": {"disc_0": {"conv_0": {"kernel": f32(5, 1, 1, 4), "g": f32(4) ** 2,
                                      "bias": f32(4)},
                           "conv_1": {"kernel": f32(5, 1, 4, 8), "g": f32(8) ** 2,
                                      "bias": f32(8)}}},
        "filter_estimator": {"conv_0": {"kernel": f32(3, 80, 16), "g": f32(16) ** 2,
                                        "bias": f32(16)}},
    }


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def test_root_leaves_and_2d_kernels_round_trip():
    tree = _root_and_2d_tree()
    kept = state_dict_from_jax(tree, fuse=False)
    np.testing.assert_array_equal(kept["fir"].numpy(), tree["fir"])
    k = tree["mpd"]["disc_0"]["conv_1"]["kernel"]
    np.testing.assert_array_equal(kept["mpd.disc_0.conv_1.weight"].numpy(),
                                  k.transpose(3, 2, 0, 1))
    assert "mpd.disc_0.conv_1.g" in kept
    back = jax_tree_from_state_dict(kept)
    want = _flat(tree)
    assert back.keys() == want.keys()
    for key, v in want.items():
        np.testing.assert_array_equal(back[key], v, err_msg=key)

    fused = state_dict_from_jax(tree)
    assert not any(key.endswith((".g", ".gt")) for key in fused)
    jax_fused = _flat(fuse_weight_norm(tree))
    for key, v in jax_tree_from_state_dict(fused).items():
        np.testing.assert_allclose(v, jax_fused[key], rtol=1e-6, atol=1e-6, err_msg=key)


def test_a_2d_conv_computes_alike_fused_and_with_its_gain():
    torch.manual_seed(3)
    trained = Conv2d(4, 8, (5, 1), (3, 1), (2, 0))
    with torch.no_grad():
        trained.g.mul_(torch.rand(8) + 0.5)
    tree = jax_tree_from_state_dict({f"c.{k}": v for k, v in trained.state_dict().items()})
    assert tree["c/kernel"].shape == (5, 1, 4, 8)
    served = Conv2d(4, 8, (5, 1), (3, 1), (2, 0), weight_norm=False)
    served.load_state_dict({k[2:]: v for k, v in state_dict_from_jax(tree).items()})
    x = torch.randn(2, 4, 40, 3)
    with torch.no_grad():
        torch.testing.assert_close(served(x), trained(x), rtol=1e-5, atol=1e-6)


def test_unknown_leaves_are_refused_by_name():
    tree = _root_and_2d_tree()
    with pytest.raises(ValueError, match="'scale'"):
        state_dict_from_jax(dict(tree, scale=np.ones(3, np.float32)))
    tree["filter_estimator"]["conv_0"]["alpha"] = np.ones(3, np.float32)
    with pytest.raises(ValueError, match="filter_estimator/conv_0.*'alpha'"):
        state_dict_from_jax(tree)


@pytest.mark.parametrize("name,tensors", [("melgan", 84), ("nhv", 9)])
def test_release_checkpoints_of_melgan_and_nhv_load(name, tensors):
    import os

    root = os.path.join(os.path.dirname(__file__), "..")
    ckpt = load_release_npz(os.path.join(root, "docs", "checkpoints", f"{name}_clean.npz"))
    assert ckpt["model_name"] == name and ckpt["pattern"] is None
    gen = build_generator(thp.load_model_config(name, os.path.join(root, ckpt["config"])))
    gen.load_state_dict(ckpt["state_dict"])  # strict: every key carried, every key used
    assert len(ckpt["state_dict"]) == tensors  # weights and biases, gains folded; NHV's fir


@pytest.mark.parametrize("name,npz", [("basis-melgan", "basis_melgan_clean2"),
                                      ("hifigan", "hifigan_light_clean2"),
                                      ("multiband-hifigan", "mb_hifigan_light_clean"),
                                      ("melgan", "melgan_clean"), ("nhv", "nhv_clean")])
def test_release_checkpoints_load_to_compute_in_bf16(name, npz):
    """`load_generator(..., compute_dtype=bf16)`: the same float32 parameters,
    bit for bit, as the float32 load, in a model whose convs compute in
    bf16."""
    import os

    from fastvocoder_tpu_torch.models.factory import load_generator
    from fastvocoder_tpu_torch.models.layers import Conv1d

    root = os.path.join(os.path.dirname(__file__), "..")
    path = os.path.join(root, "docs", "checkpoints", f"{npz}.npz")
    cfg = thp.load_model_config(name, os.path.join(root, load_release_npz(path)["config"]))
    f32, _ = load_generator(path, cfg, torch.device("cpu"))
    bf16, _ = load_generator(path, cfg, torch.device("cpu"), compute_dtype=torch.bfloat16)
    a, b = f32.state_dict(), bf16.state_dict()
    assert a.keys() == b.keys()
    assert all(b[k].dtype == torch.float32 and torch.equal(a[k], b[k]) for k in a)
    convs = [m for m in bf16.modules() if isinstance(m, Conv1d)]
    assert convs and all(m.compute_dtype == torch.bfloat16 for m in convs)


def test_a_trained_checkpoint_loads_to_compute_in_bf16(tmp_path):
    """A checkpoint of the port's trainer loads with `compute_dtype` as a
    release checkpoint does: weight norm fused in float32, the model in
    bf16."""
    from fastvocoder_tpu_torch.checkpoint import TRAIN_FORMAT
    from fastvocoder_tpu_torch.models.factory import load_generator

    cfg = thp.ModelConfig("hifigan", thp.HiFiGANConfig(**HIFI_ARCH))
    torch.manual_seed(0)
    trained = build_generator(cfg, weight_norm=True)
    path = str(tmp_path / "checkpoint_1.pth.tar")
    torch.save({"format": TRAIN_FORMAT, "model_name": "hifigan",
                "generator": trained.state_dict()}, path)
    f32, _ = load_generator(path, cfg, torch.device("cpu"))
    bf16, _ = load_generator(path, cfg, torch.device("cpu"), compute_dtype=torch.bfloat16)
    mel = torch.rand(1, 10, 80)
    with torch.inference_mode():
        want, got = f32(mel), bf16(mel)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert (got - want).abs().max().item() <= max(2e-3, 0.01 * want.abs().max().item())
    assert all(p.dtype == torch.float32 for p in bf16.parameters())
