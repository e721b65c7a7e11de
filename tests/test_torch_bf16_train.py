"""bf16 mixed-precision training (`--mixprecision`) in the port against the
JAX package's, on the CPU: one `pre_adv_step` and one `gan_step` of the
port's trainer with `compute_dtype=torch.bfloat16` against the same steps of
`make_trainer(compute_dtype=jnp.bfloat16)` from equal weights on an equal
batch (10 frames, 2 crops, `TINY_DISC`): narrow HiFiGAN from a random init,
and Basis-MelGAN light and MelGAN from their release checkpoints
(`docs/checkpoints/`, which hold the weight-norm form).

Both packages run their module paths on the CPU (XLA's bf16 convs in JAX,
torch's in the port): bf16 convs with float32 sums rounded to bf16, float32
losses.  Two bf16 implementations that sum and round in other places land
on other bf16 neighbours, and the difference travels, so two bf16 steps are
not held to each other elementwise.  The rule, PR 8's for bf16 serving: the
port's bf16 step deviates from the port's float32 step by no more than
DEV_RATIO = 1.5 times as much as JAX's bf16 step deviates from JAX's
float32 step, for every loss (relative to the float32 value or 1e-2,
whichever is larger, with a floor of one bf16 rounding, 2^-8: deviations
below it are float32 noise of a bf16 discriminator's mean) and for the
generator's and the discriminator's gradients (relative RMS over all their
tensors).  The gradients and the parameters stay float32.

Measured here (port / JAX deviation from float32; worst loss, generator
gradients, discriminator gradients): HiFiGAN pre_adv 5.50e-2 / 6.74e-2,
0.292 / 0.341; gan 0.293 / 0.343 (generator), 9.2e-3 / 1.21e-2; MelGAN
pre_adv 2.93e-2 / 3.60e-2, 0.295 / 0.267; gan 0.296 / 0.266, 7.5e-3 /
1.34e-2; Basis-MelGAN light pre_adv 6.99e-4 / 2.54e-3, 0.339 / 0.289; gan
0.339 / 0.279, 8.7e-3 / 1.61e-2.  A bf16 step moves a
gradient by 0.27-0.34 of its norm in both packages: the log-magnitude STFT
loss divides by magnitudes down to its clamp, where a bf16 waveform's
rounding is a large share.  From a narrow random init Basis-MelGAN's is
worse: 0.71 of the norm in JAX and 1.23 in the port (the last stage's
gradients, of norm 0.02-0.4, move by 1-11 times their norm), whose bf16
module path rounds after every op where XLA keeps fused elementwise chains
in float32; its bf16 gradient there is rounding noise in both packages, so
Basis-MelGAN is held from its trained weights.

Also: `run_train([... "--mixprecision", "1", "--device", "cpu"])` takes 3
steps on the host input path and writes a checkpoint that `Synthesizer`
loads in float32 and in bf16; Basis-MelGAN's run on the device path (bf16
weight targets) writes one whose bf16 synthesis is held against the JAX
package's bf16 synthesis of the same file (DEV_RATIO, the rule above);
`make_trainer(compute_dtype=torch.bfloat16)` and `--mixprecision` raise
without a card unless given the CPU.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvocoder_tpu import hparams as jhp
from fastvocoder_tpu.train import trainer as jtrainer
from fastvocoder_tpu_torch import hparams as thp
from fastvocoder_tpu_torch.bin.synthesize import Synthesizer
from fastvocoder_tpu_torch.bin.train import run_train
from fastvocoder_tpu_torch.hparams import load_model_config
from fastvocoder_tpu_torch.models.factory import build_generator
from fastvocoder_tpu_torch.train import trainer as ttrainer
from fastvocoder_tpu_torch.train.checkpoint import latest_checkpoint
from tests.test_torch_train_driver import CONFS, _argv, corpus  # noqa: F401 (a fixture)
from tests.test_torch_trainer import (
    FIXED,
    MELGAN,
    _as_state_dict,
    _batch,
    _cfgs,
    _jax_loss_fns,
)

BF16 = torch.bfloat16
MODELS = ("hifigan", "basis-melgan", "melgan")
DEV_RATIO = 1.5  # the port's bf16 deviation from its float32 step, over JAX's
LOSS_FLOOR = 2.0 ** -8  # one bf16 rounding: a loss's deviation below it passes
ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs: the same float32 sums on
    every machine and worker count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BASIS = (os.path.join(ROOT, "docs", "checkpoints", "basis_melgan_clean2.npz"),
         os.path.join(ROOT, "conf", "basis-melgan", "light.yaml"))


def _cfg(name):
    if name == "basis-melgan":
        return tuple(hp.load_model_config(name, BASIS[1]) for hp in (jhp, thp))
    return _cfgs(name)


def _release_tree(path):
    """The weight-norm generator tree of a release checkpoint, as JAX arrays."""
    with np.load(path) as z:
        gen = {}
        for k in z.files:
            if k.startswith("param:"):
                *parents, leaf = k[len("param:"):].split("/")
                node = gen
                for p in parents:
                    node = node.setdefault(p, {})
                node[leaf] = jnp.asarray(z[k].astype(np.float32))
    return gen


def _state(name, tr):
    """The JAX train state a case starts from: a random init, or a release
    checkpoint's generator with a discriminator from PRNGKey(0), both
    optimisers fresh."""
    if name == "hifigan":
        return tr.init_state(jax.random.PRNGKey(0))
    gen = _release_tree(BASIS[0] if name == "basis-melgan" else MELGAN[0])
    disc = jax.jit(tr.discriminator.init)(jax.random.PRNGKey(0),
                                          jnp.zeros((1, FIXED * 240), jnp.float32))["params"]
    return jtrainer.TrainState(step=jnp.zeros((), jnp.int32), gen_params=gen, disc_params=disc,
                               gen_opt_state=tr.gen_tx.init(gen),
                               disc_opt_state=tr.disc_tx.init(disc))


def _args(name):
    if name != "basis-melgan":
        return _batch(name)
    mel, wav, _ = _batch("hifigan")
    weight = np.random.default_rng(8).random((2, FIXED * 16, 256)).astype(np.float32)
    return mel, wav, weight


@pytest.fixture(scope="module")
def runs():
    """Per model the JAX trainers in float32 and bf16 and their common
    initial state."""
    out = {}
    for name in MODELS:
        jcfg, _ = _cfg(name)
        trs = {dt: jtrainer.make_trainer(jcfg, hp=jhp.HP.replace(fixed_length=FIXED),
                                         disc_cfg=jhp.TINY_DISC, compute_dtype=dt)
               for dt in (None, jnp.bfloat16)}
        out[name] = (trs, _state(name, trs[None]))
    return out


def _rel_rms(got: dict, want: dict) -> float:
    """|got - want| / |want| over every tensor of both (by key)."""
    num = sum(float((got[k].double() - want[k].double()).pow(2).sum()) for k in want)
    den = sum(float(want[k].double().pow(2).sum()) for k in want)
    return float(np.sqrt(num / den))


def _jax_step(trs, state, step, args):
    """-> per compute type (metrics, {"generator": grads, "discriminator": grads}) of
    JAX's step, gradients as port state dicts."""
    mel, wav, weight = args
    out = {}
    for dt, tr in trs.items():
        pre_adv, gan_gen, gan_disc = _jax_loss_fns(tr, state, mel, wav, weight)
        if step == "pre_adv_step":
            _, metrics = jax.jit(tr.pre_adv_step)(state, mel, wav, weight)
            grads = {"generator": _as_state_dict(jax.jit(jax.grad(pre_adv))(state.gen_params))}
        else:
            new, metrics = jax.jit(tr.gan_step)(state, mel, wav)
            grads = {"generator": _as_state_dict(jax.jit(jax.grad(gan_gen))(state.gen_params)),
                     "discriminator": _as_state_dict(
                         jax.jit(jax.grad(gan_disc))(state.disc_params, new.gen_params))}
        out[dt] = ({k: float(v) for k, v in metrics.items()}, grads)
    return out[None], out[jnp.bfloat16]


def _port_step(name, jstate, jtr, step, args):
    """-> per compute type (metrics, gradients, state after the step) of the
    port's step from JAX's initial weights."""
    _, tcfg = _cfg(name)
    out = {}
    for dt in (None, BF16):
        tr = ttrainer.make_trainer(tcfg, hp=thp.HP.replace(fixed_length=FIXED),
                                   disc_cfg=thp.TINY_DISC, device="cpu", keep_grads=True,
                                   compute_dtype=dt)
        st = tr.init_state(0)
        st.generator.load_state_dict(_as_state_dict(jstate.gen_params))
        st.discriminator.load_state_dict(_as_state_dict(jstate.disc_params))
        tensors = [torch.from_numpy(a) if a is not None else None for a in args]
        _, metrics = getattr(tr, step)(st, *(tensors if step == "pre_adv_step" else tensors[:2]))
        out[dt] = ({k: float(v) for k, v in metrics.items()}, tr.last_grads, st)
    return out[None], out[BF16]


def _loss_dev(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-2)


@pytest.mark.parametrize("step", ["pre_adv_step", "gan_step"])
@pytest.mark.parametrize("name", MODELS)
def test_bf16_step_deviates_from_float32_as_jax_does(runs, name, step):
    trs, state = runs[name]
    args = _args(name)
    (jm32, jg32), (jm16, jg16) = _jax_step(trs, state, step, args)
    (tm32, tg32, _), (tm16, tg16, tstate) = _port_step(name, state, trs[None], step, args)
    assert set(tm16) == set(jm16) == set(tm32)
    for k in jm16:
        port_dev, jax_dev = _loss_dev(tm16[k], tm32[k]), _loss_dev(jm16[k], jm32[k])
        print(f"{name} {step} {k}: port {port_dev:.3e}, JAX {jax_dev:.3e}")
        assert np.isfinite(tm16[k]) and port_dev <= max(DEV_RATIO * jax_dev, LOSS_FLOOR), k
    assert set(tg16) == set(jg16)
    for who in tg16:
        port_dev, jax_dev = _rel_rms(tg16[who], tg32[who]), _rel_rms(jg16[who], jg32[who])
        print(f"{name} {step} {who} gradients: port {port_dev:.3e}, JAX {jax_dev:.3e}")
        assert all(g.dtype == torch.float32 for g in tg16[who].values())
        assert port_dev <= DEV_RATIO * jax_dev, who
    for module, opt in ((tstate.generator, tstate.gen_opt),
                        (tstate.discriminator, tstate.disc_opt)):
        assert all(p.dtype == torch.float32 for p in module.parameters())
        assert all(v.dtype == torch.float32 for st in opt.state.values() for v in st.values()
                   if isinstance(v, torch.Tensor) and v.dim() > 0)


@pytest.mark.parametrize("model", ["hifigan", "basis-melgan", "melgan", "nhv"])
def test_run_train_mixprecision_writes_a_checkpoint_synthesizer_loads_in_both_types(corpus,
                                                                                    model):
    """Three steps of `--mixprecision 1` across the GAN boundary; the
    checkpoint holds float32 weights and (NHV, whose conditioning carries
    f0, aside) loads in `Synthesizer` in float32 (the
    trained generator's waveform within 1e-5 of the peak, as a float32 run's
    checkpoint) and in bf16 (within the JAX package's bf16 gate of that
    waveform, max(2e-3, 1 % of its peak))."""
    run_dir = corpus / f"mixed_{model}"
    # the host input path, which this test ran before the corpus could sit
    # on the device: the device path's bf16 weight targets train Basis-MelGAN
    # to weights whose bf16 synthesis misses the gate below in the JAX
    # package too (ROADMAP.md C)
    state = run_train(_argv(corpus, model, run_dir, max_steps=3, save_step=3,
                            mixprecision=1, device_cache=0), disc_cfg=thp.TINY_DISC)
    assert [s for s, _ in state.history] == [1, 2, 3]
    assert all(np.isfinite(v) for _, m in state.history for v in m.values())
    assert "discriminator_loss" in dict(state.history)[3]
    assert all(p.dtype == torch.float32 for p in state.generator.parameters())
    path = latest_checkpoint(str(run_dir))
    assert path.endswith("checkpoint_3.pth.tar")
    payload = torch.load(path, map_location="cpu", weights_only=True)
    assert all(v.dtype == torch.float32
               for part in ("model", "discriminator") for v in payload[part].values()
               if v.is_floating_point())
    if model == "nhv":
        return
    mel = np.random.default_rng(5).random((23, 80)).astype(np.float32)
    conf = str(corpus / CONFS[model])
    # the trained weights in a float32 generator (the run's computes in bf16)
    f32 = build_generator(load_model_config(model, conf), weight_norm=True)
    f32.load_state_dict(state.generator.state_dict())
    with torch.no_grad():
        want = f32.eval().inference(torch.from_numpy(mel)[None])[0].numpy()
    peak = np.abs(want).max()
    got = Synthesizer(path, conf, model, device="cpu")._run(mel)
    assert got.shape == want.shape and np.abs(got - want).max() <= 1e-5 * peak
    synth = Synthesizer(path, conf, model, device="cpu", compute_dtype=BF16)
    got = synth._run(mel)
    assert got.dtype == np.float32 and got.shape == want.shape and np.all(np.isfinite(got))
    assert np.abs(got - want).max() <= max(2e-3, 1e-2 * peak)


def test_run_train_mixprecision_device_path_checkpoint_in_bf16_as_close_as_jaxs(corpus):
    """Basis-MelGAN through `--mixprecision 1 --device_cache 1` (bf16 weight
    targets on the device path): the checkpoint synthesizes in float32 as
    the JAX package's generator does on the same file (1e-5 of the peak),
    and in bf16 it deviates from float32 by no more than DEV_RATIO times the
    JAX package's own bf16 synthesis of that file does."""
    from fastvocoder_tpu.models.factory import build_generator as jax_build_generator
    from fastvocoder_tpu.train import checkpoint as jck

    model = "basis-melgan"
    run_dir = corpus / "mixed_device"
    run_train(_argv(corpus, model, run_dir, max_steps=3, save_step=3, mixprecision=1,
                    device_cache=1), disc_cfg=thp.TINY_DISC)
    path = latest_checkpoint(str(run_dir))
    conf = str(corpus / CONFS[model])
    mel = np.random.default_rng(5).random((23, 80)).astype(np.float32)
    f32 = Synthesizer(path, conf, model, device="cpu")._run(mel)
    bf16 = Synthesizer(path, conf, model, device="cpu", compute_dtype=BF16)._run(mel)
    jcfg = jhp.load_model_config(model, conf)
    params = jck.load_checkpoint(path, jcfg, with_discriminator=False)["gen_params"]
    jax_out = {}
    for dtype in (None, jnp.bfloat16):
        gen = jax_build_generator(jcfg, compute_dtype=dtype)
        out = gen.apply({"params": params}, jnp.asarray(mel)[None], method=gen.inference)
        jax_out[dtype] = np.asarray(out, np.float32)[0]
    peak = np.abs(jax_out[None]).max()
    assert f32.shape == jax_out[None].shape
    assert np.abs(f32 - jax_out[None]).max() <= 1e-5 * peak
    jax_dev = np.abs(jax_out[jnp.bfloat16] - jax_out[None]).max()
    assert np.abs(bf16 - f32).max() <= DEV_RATIO * jax_dev


def test_bf16_training_needs_a_card_unless_told_the_cpu(corpus):
    _, cfg = _cfgs("hifigan")
    tr = ttrainer.make_trainer(cfg, device="cpu", compute_dtype=BF16)
    assert tr.compute_dtype == BF16
    with pytest.raises(ValueError, match="compute_dtype"):
        ttrainer.make_trainer(cfg, device="cpu", compute_dtype=torch.float16)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrainer.make_trainer(cfg, compute_dtype=BF16)
    argv = [a for a in _argv(corpus, "hifigan", corpus / "run_m", max_steps=1, mixprecision=1)
            if not a.startswith("--device")]
    with pytest.raises(RuntimeError, match="--device cpu"):
        run_train(argv, disc_cfg=thp.TINY_DISC)


@pytest.mark.parametrize("name", ["hifigan", "basis-melgan", "multiband-hifigan", "melgan", "nhv"])
def test_every_generator_output_reaches_the_losses_in_float32(name):
    """With compute_dtype bf16 every family's training forward hands the
    MR-STFT loss float32 (as the JAX package's casts, e.g.
    `models/basis_melgan.py:123-135`), and the discriminator's features come
    out bf16 for the losses to upcast."""
    _, cfg = _cfgs(name)
    basis = None
    if name == "basis-melgan":
        basis = (0.1 * np.random.default_rng(3).standard_normal((30, 16))).astype(np.float32)
    tr = ttrainer.make_trainer(cfg, hp=thp.HP.replace(fixed_length=FIXED),
                               basis_signal_weight=basis, disc_cfg=thp.TINY_DISC, device="cpu",
                               compute_dtype=BF16)
    state = tr.init_state(0)
    mel = torch.from_numpy(_batch(name)[0])
    with torch.no_grad():
        est, est_weight = tr._gen_forward(state.generator, mel, tr._step_noise(state, mel))
        feats = state.discriminator(tr._to_fullband(est))
    assert est.dtype == torch.float32 and torch.isfinite(est).all()
    assert est_weight is None or est_weight.dtype == torch.float32
    assert all(f.dtype == BF16 for scale in feats for f in scale)
