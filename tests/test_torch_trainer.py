"""The training slice as a whole: one step of the port's trainer
(`fastvocoder_tpu_torch/train/trainer.py`) against the same step of the JAX
package's, from equal weights and an equal batch, on the CPU: the
pre-adversarial and the GAN step of narrow HiFiGAN, Basis-MelGAN,
MultiBand-HiFiGAN (4 bands) and NHV generators and of MelGAN, and a GAN
step of HiFiGAN against the composite with the multi-period discriminator.

MelGAN's cases start from `docs/checkpoints/melgan_clean.npz` (full width,
the weight-norm form it holds), not from a narrow random init: such a
MelGAN puts out a near-constant waveform (rms 0.0508, peak 0.0521) whose
STFT bins lie mostly at the magnitude clamp, where the log-magnitude
loss's float32 gradient is set by rounding: JAX's own float32 gradient is
7.5e-3 of its peak away from a float64 run of the same step there, the
port's 6.3e-3 (conv_pre's weight).  From the release weights both are
within 1.4e-3 of float64 and the port within 5.3e-4 of JAX.  A trained
MelGAN still leaves about 1 in 15 of the STFT bins at the clamp (deep
spectral valleys); bins just above it enter the log-magnitude gradient as
1 / |X| with |X| carrying the float32 FFT's absolute error (about 1e-6 of
a frame's energy), so the global gradient norm of one float32 run is
4.6e-4 (JAX) and 7.2e-4 (the port) away from float64: MelGAN's clip norm
is held to its gradients' 3e-3 (measured 2.7e-4 from JAX's), the other
families' to 1e-4.

NHV's batch carries f0 as mel channel 80 (150-250 Hz, a fifth of the frames
unvoiced), on which the port's impulse train is JAX's (checked); its noise
is JAX's own draw of the step (`fold_in(PRNGKey(42), step)` through the
generator's `noise` stream), handed to the port's trainer as its `noise`.

Measured on the new cases (worst of each step's losses, relative; worst
gradient of its peak, generator then discriminator): MelGAN 5.4e-7,
5.3e-4, 9.6e-7; NHV 2.3e-7, 6.7e-5, 1.1e-6; HiFiGAN with the MPD 4.5e-7,
2.7e-3, 4.0e-6 (the generator's log-magnitude gradient, as HiFiGAN's
without the MPD).

Weights are initialised on the JAX side and carried across with
`state_dict_from_jax(..., fuse=False)`; the batch comes from numpy.  Held:

  * every loss in the metrics, rtol 1e-4 (float32 sums in different orders
    through an STFT and a conv stack);
  * the generator's and the discriminator's gradients before the clip,
    within 3e-3 of each gradient's own peak.  The log-magnitude loss divides
    by magnitudes down to its clamp (3e-4), so its float32 gradient is
    ill-conditioned: against a float64 run of the same step the port's
    float32 gradients differ by up to 1.2e-3 of their peaks and the JAX
    package's by 5e-5, while the losses agree to 1e-4.  A gain's or a
    bias's gradient is a sum over its conv's weight gradient with
    cancellation, so it is held against the larger of its own peak and that
    weight gradient's;
  * the parameters after the step.  Adam's first step is lr g / (|g| +
    eps), so it has size lr wherever |g| is well above eps = 1e-6 and is
    ill-conditioned below: entries whose clipped gradient is below 1e-4 are
    left out, the others agree within 2 % of the learning rate;
  * Basis-MelGAN's basis is unchanged while its gradient entered the clip
    norm;
  * the cosine schedule matches the JAX package's `torch_cosine_annealing`.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fastvocoder_tpu import hparams as jhp
from fastvocoder_tpu.losses import (
    adversarial_loss,
    discriminator_loss,
    feature_map_loss,
    reconstruction_loss,
)
from fastvocoder_tpu.models import nhv as jnhv
from fastvocoder_tpu.train import trainer as jtrainer
from fastvocoder_tpu_torch import hparams as thp
from fastvocoder_tpu_torch.checkpoint import state_dict_from_jax
from fastvocoder_tpu_torch.models import nhv
from fastvocoder_tpu_torch.train import trainer as ttrainer

FIXED = 10  # frames of a crop: 2400 samples
LOSS_RTOL, GEN_GRAD_TOL, DISC_GRAD_TOL, STEP_TOL, SMALL_GRAD = 1e-4, 3e-3, 3e-3, 0.02, 1e-4

HIFI_ARCH = dict(resblock_kernel_sizes=(3, 5), upsample_rates=(8, 5, 3, 2),
                 upsample_initial_channel=32, upsample_kernel_sizes=(16, 10, 6, 4),
                 resblock_dilation_sizes=((1, 3), (1, 3)))
BASIS_ARCH = dict(out_channels=16, channels=(16, 16, 16))
# MultiBand-HiFiGAN: 4 bands of 60 samples a frame, PQMF-synthesised
MB_ARCH = dict(resblock_kernel_sizes=(3, 5), upsample_rates=(10, 6),
               upsample_initial_channel=32, upsample_kernel_sizes=(20, 12),
               resblock_dilation_sizes=((1, 3), (1, 3)), out_bands=4)
MELGAN = (os.path.join(os.path.dirname(__file__), "..", "docs", "checkpoints", "melgan_clean.npz"),
          os.path.join(os.path.dirname(__file__), "..", "conf", "melgan", "original.yaml"))
NHV_ARCH = dict(channels=16, ccep_size=32, fir_taps=17, fft_size=512)
MODELS = ("hifigan", "basis-melgan", "multiband-hifigan", "melgan", "nhv")


def _cfgs(name):
    if name in ("hifigan", "hifigan+mpd"):
        return (jhp.ModelConfig("hifigan", jhp.HiFiGANConfig(**HIFI_ARCH), lambda_stft=5.0),
                thp.ModelConfig("hifigan", thp.HiFiGANConfig(**HIFI_ARCH), lambda_stft=5.0))
    if name == "multiband-hifigan":
        return tuple(hp.ModelConfig(name, hp.HiFiGANConfig(**MB_ARCH), lambda_stft=5.0,
                                    multiband=True) for hp in (jhp, thp))
    if name == "melgan":
        return tuple(hp.load_model_config("melgan", MELGAN[1]) for hp in (jhp, thp))
    if name == "nhv":
        return tuple(hp.ModelConfig(name, hp.NHVConfig(**NHV_ARCH), lambda_stft=5.0)
                     for hp in (jhp, thp))
    return (jhp.ModelConfig("basis-melgan", jhp.BasisMelGANConfig(**BASIS_ARCH), lambda_stft=1.0),
            thp.ModelConfig("basis-melgan", thp.BasisMelGANConfig(**BASIS_ARCH), lambda_stft=1.0))


def _batch(name, B=2):
    rng = np.random.default_rng(7)
    mel = rng.standard_normal((B, FIXED, 80)).astype(np.float32)
    t = np.arange(FIXED * 240, dtype=np.float32)
    wav = np.stack([0.3 * np.sin(2 * np.pi * 220 * (i + 1) * t / 24000) for i in range(B)])
    wav = (wav + 0.01 * rng.standard_normal(wav.shape)).astype(np.float32)
    weight = None
    if name == "basis-melgan":
        weight = rng.random((B, FIXED * 16, 16)).astype(np.float32)
    if name == "nhv":
        f0 = rng.uniform(150.0, 250.0, (B, FIXED)).astype(np.float32)
        f0[rng.random((B, FIXED)) < 0.2] = 0.0
        mel = np.concatenate([mel, f0[..., None]], axis=-1)
    return mel, wav, weight


def _norm_rtol(name):
    """The generator's clip norm against JAX's: 1e-4, and for MelGAN the
    gradients' own 3e-3 (see the module docstring: both packages' float32
    norms are 4.6e-4 and 7.2e-4 away from float64 there)."""
    return GEN_GRAD_TOL if name == "melgan" else 1e-4


def _disc_cfg(name, hp):
    return dataclasses.replace(hp.TINY_DISC, use_mpd=True) if name == "hifigan+mpd" else hp.TINY_DISC


def _jax_noise(tr, state, mel):
    """The noise the JAX trainer's NHV draws at `state.step`: its
    generator's `noise` stream from fold_in(PRNGKey(42), step)."""
    shape = (mel.shape[0], mel.shape[1] * 240)
    draw = lambda module, cond: 0.3 * jax.random.normal(module.make_rng("noise"), shape,
                                                         jnp.float32)
    key = jax.random.fold_in(jax.random.PRNGKey(42), state.step)
    return np.array(tr.generator.apply({"params": state.gen_params}, mel, rngs={"noise": key},
                                       method=draw))


def _jax_loss_fns(tr, state, mel, wav, weight):
    """The step's losses written out with the JAX trainer's own pieces, to
    read the gradients the step itself does not return."""
    mel = jnp.asarray(mel)  # NHV indexes its f0 channel with traced indices

    def pre_adv(gen_params):
        est, est_w = tr._gen_forward(gen_params, mel, step=state.step)
        stft_l, weight_l = reconstruction_loss(est, wav, est_weight=est_w, weight=weight,
                                               pqmf=tr.pqmf)
        total = tr.cfg.lambda_stft * stft_l
        return total if weight_l is None else total + weight_l

    def gan_gen(gen_params):
        est, est_w = tr._gen_forward(gen_params, mel, step=state.step)
        stft_l, _ = reconstruction_loss(est, wav, est_weight=est_w, weight=weight, pqmf=tr.pqmf)
        est_p = tr.discriminator.apply({"params": state.disc_params}, tr._to_fullband(est))
        real_p = tr.discriminator.apply({"params": state.disc_params}, wav)
        return (tr.cfg.lambda_stft * stft_l + tr.hp.lambda_adv * adversarial_loss(est_p)
                + tr.hp.lambda_fm * feature_map_loss(est_p, real_p))

    def gan_disc(disc_params, new_gen_params):
        est, _ = tr._gen_forward(new_gen_params, mel, step=state.step)
        est = jax.lax.stop_gradient(tr._to_fullband(est))
        real_l, fake_l = discriminator_loss(tr.discriminator.apply({"params": disc_params}, wav),
                                            tr.discriminator.apply({"params": disc_params}, est))
        return real_l + fake_l

    return pre_adv, gan_gen, gan_disc


def _release_state(tr):
    """A JAX train state from MelGAN's release weights, the discriminator
    initialised from PRNGKey(0), both optimisers fresh."""
    with np.load(MELGAN[0]) as z:
        gen = {}
        for k in z.files:
            if k.startswith("param:"):
                *parents, leaf = k[len("param:"):].split("/")
                node = gen
                for p in parents:
                    node = node.setdefault(p, {})
                node[leaf] = jnp.asarray(z[k].astype(np.float32))
    wav = jnp.zeros((1, FIXED * 240), jnp.float32)
    disc = jax.jit(tr.discriminator.init)(jax.random.PRNGKey(0), wav)["params"]
    return jtrainer.TrainState(step=jnp.zeros((), jnp.int32), gen_params=gen, disc_params=disc,
                               gen_opt_state=tr.gen_tx.init(gen),
                               disc_opt_state=tr.disc_tx.init(disc))


@pytest.fixture(scope="module")
def runs():
    """One jitted JAX trainer per model, shared by the cases: (JAX trainer,
    its initial state, jitted steps and gradient functions)."""
    out = {}
    for name in MODELS + ("hifigan+mpd",):
        jcfg, _ = _cfgs(name)
        basis = None
        if name == "basis-melgan":
            basis = (0.1 * np.random.default_rng(3).standard_normal((30, 16))).astype(np.float32)
        tr = jtrainer.make_trainer(jcfg, hp=jhp.HP.replace(fixed_length=FIXED),
                                   basis_signal_weight=basis, disc_cfg=_disc_cfg(name, jhp))
        state = (_release_state(tr) if name == "melgan"
                 else tr.init_state(jax.random.PRNGKey(0)))
        out[name] = (tr, state, basis)
    return out


def _torch_trainer(name, jstate, basis, jtr=None, **kw):
    _, tcfg = _cfgs(name)
    if name == "nhv":
        mel = _batch(name)[0]
        noise = _jax_noise(jtr, jstate, mel)

        def jax_draw(step, shape):
            assert step == int(jstate.step) and tuple(shape) == noise.shape
            return torch.from_numpy(noise)

        kw["noise"] = jax_draw
        # the batch's impulse train is JAX's, so that the step is held exactly
        f0 = mel[..., 80]
        np.testing.assert_array_equal(
            nhv.impulse_train(torch.from_numpy(f0), 240, 24000).numpy(),
            np.asarray(jnhv.impulse_train(jnp.asarray(f0), 240, 24000)))
    tr = ttrainer.make_trainer(tcfg, hp=thp.HP.replace(fixed_length=FIXED),
                               basis_signal_weight=basis, disc_cfg=_disc_cfg(name, thp),
                               device="cpu", keep_grads=True, **kw)
    state = tr.init_state(0)
    state.generator.load_state_dict(state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate.gen_params), fuse=False))
    state.discriminator.load_state_dict(state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate.disc_params), fuse=False))
    return tr, state


def _as_state_dict(tree):
    return state_dict_from_jax(jax.tree_util.tree_map(np.asarray, tree), fuse=False)


def _assert_metrics(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=LOSS_RTOL, err_msg=k)


def _assert_grads(got, want_tree, tol):
    want = _as_state_dict(want_tree)
    assert set(got) == set(want)
    for k, w in want.items():
        peak = w.abs().max().item()
        sibling = k.rsplit(".", 1)[0] + ".weight"
        if sibling in want:
            peak = max(peak, want[sibling].abs().max().item())
        err = (got[k] - w).abs().max().item()
        assert err <= tol * max(peak, 1e-12), f"{k}: max abs {err:.3e}, peak {peak:.3e}"


def _assert_params(module, before, after_tree, grads_tree, clip_norm, lr):
    """Parameters after one Adam step, where the clipped gradient is not
    small against Adam's eps."""
    want = _as_state_dict(after_tree)
    grads = _as_state_dict(grads_tree)
    scale = 1.0 if clip_norm < 1.0 else 1.0 / clip_norm
    got = module.state_dict()
    checked = 0
    for k, w in want.items():
        keep = (grads[k] * scale).abs() >= SMALL_GRAD
        if k.startswith("basis_signal."):
            torch.testing.assert_close(got[k], before[k], rtol=0, atol=0)
            continue
        err = (got[k] - w).abs()[keep]
        checked += int(keep.sum())
        if err.numel():
            assert err.max().item() <= STEP_TOL * lr, f"{k}: {err.max().item():.3e}"
        moved = (got[k] - before[k]).abs()[keep]
        if moved.numel():
            assert moved.min().item() > 0.5 * lr, k
    assert checked > 100


@pytest.mark.parametrize("name", MODELS)
def test_pre_adv_step_matches_jax(runs, name):
    jtr, jstate, basis = runs[name]
    mel, wav, weight = _batch(name)
    pre_adv, _, _ = _jax_loss_fns(jtr, jstate, mel, wav, weight)
    jgrads = jax.jit(jax.grad(pre_adv))(jstate.gen_params)
    jnew, jmetrics = jax.jit(jtr.pre_adv_step)(jstate, mel, wav, weight)

    ttr, tstate = _torch_trainer(name, jstate, basis, jtr)
    before = {k: v.clone() for k, v in tstate.generator.state_dict().items()}
    args = [torch.from_numpy(a) if a is not None else None for a in (mel, wav, weight)]
    _, tmetrics = ttr.pre_adv_step(tstate, *args)

    _assert_metrics(tmetrics, jmetrics)
    if name == "basis-melgan":
        assert {"weight_loss", "weight_average_value"} <= set(tmetrics)
    _assert_grads(ttr.last_grads["generator"], jgrads, GEN_GRAD_TOL)
    norm = float(optax.global_norm(jgrads))
    np.testing.assert_allclose(float(ttr.last_norms["generator"]), norm, rtol=_norm_rtol(name))
    if name == "basis-melgan":
        # the frozen basis has a gradient, and the norm counts it
        basis_grad = ttr.last_grads["generator"]["basis_signal.basis"]
        without = np.sqrt(norm ** 2 - float(basis_grad.pow(2).sum()))
        assert basis_grad.abs().max() > 0 and without < norm * (1 - 1e-6)
    _assert_params(tstate.generator, before, jnew.gen_params, jgrads, norm, jhp.HP.learning_rate)
    assert tstate.step == 1 and tstate.gen_updates == 1 and tstate.disc_updates == 0


@pytest.mark.parametrize("name", MODELS + ("hifigan+mpd",))
def test_gan_step_matches_jax(runs, name):
    """`hifigan+mpd`: against MSD + MFD + MPD, the MPD's 2-D convs at
    `TINY_DISC`'s widths, every period's features in the feature-map loss."""
    jtr, jstate, basis = runs[name]
    mel, wav, weight = _batch(name)
    _, gan_gen, gan_disc = _jax_loss_fns(jtr, jstate, mel, wav, weight)
    jnew, jmetrics = jax.jit(jtr.gan_step)(jstate, mel, wav)
    jg = jax.jit(jax.grad(gan_gen))(jstate.gen_params)
    jd = jax.jit(jax.grad(gan_disc))(jstate.disc_params, jnew.gen_params)

    ttr, tstate = _torch_trainer(name, jstate, basis, jtr)
    g_before = {k: v.clone() for k, v in tstate.generator.state_dict().items()}
    d_before = {k: v.clone() for k, v in tstate.discriminator.state_dict().items()}
    _, tmetrics = ttr.gan_step(tstate, torch.from_numpy(mel), torch.from_numpy(wav))

    _assert_metrics(tmetrics, jmetrics)
    _assert_grads(ttr.last_grads["generator"], jg, GEN_GRAD_TOL)
    _assert_grads(ttr.last_grads["discriminator"], jd, DISC_GRAD_TOL)
    g_norm, d_norm = float(optax.global_norm(jg)), float(optax.global_norm(jd))
    np.testing.assert_allclose(float(ttr.last_norms["generator"]), g_norm, rtol=_norm_rtol(name))
    np.testing.assert_allclose(float(ttr.last_norms["discriminator"]), d_norm, rtol=1e-3)
    _assert_params(tstate.generator, g_before, jnew.gen_params, jg, g_norm, jhp.HP.learning_rate)
    _assert_params(tstate.discriminator, d_before, jnew.disc_params, jd, d_norm,
                   jhp.HP.learning_rate_discriminator)
    assert tstate.step == 1 and tstate.gen_updates == 1 and tstate.disc_updates == 1


def test_clip_follows_the_jax_rule():
    g = [torch.tensor([3.0, 0.0]), torch.tensor([[4.0]])]
    norm = ttrainer.clip_by_global_norm_(g, 1.0)
    assert float(norm) == 5.0
    torch.testing.assert_close(g[0], torch.tensor([0.6, 0.0]))
    small = [torch.tensor([0.3, 0.4])]
    ttrainer.clip_by_global_norm_(small, 1.0)
    torch.testing.assert_close(small[0], torch.tensor([0.3, 0.4]), rtol=0, atol=0)


@pytest.mark.parametrize("count", [0, 1, 1250, 2500, 4000])
def test_cosine_schedule_matches_jax(count):
    want = float(jtrainer.torch_cosine_annealing(1e-4)(count))
    assert ttrainer.torch_cosine_annealing(1e-4)(count) == pytest.approx(want, rel=1e-6)


def test_scheduler_is_evaluated_at_the_optimisers_own_count(runs):
    jtr, jstate, basis = runs["hifigan"]
    mel, wav, _ = _batch("hifigan")
    ttr, tstate = _torch_trainer("hifigan", jstate, basis, use_scheduler=True)
    seen = []
    for _ in range(2):
        ttr.pre_adv_step(tstate, torch.from_numpy(mel), torch.from_numpy(wav))
        seen.append(tstate.gen_opt.param_groups[0]["lr"])
    sched = ttrainer.torch_cosine_annealing(thp.HP.learning_rate)
    assert seen == [sched(0), sched(1)] and seen[0] == thp.HP.learning_rate


def test_trainer_raises_without_a_card_and_on_the_mpd():
    _, tcfg = _cfgs("hifigan")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ttrainer.make_trainer(tcfg)
    # the MPD is ported: asked for by the discriminator's or the model's
    # configuration, the trainer's discriminator has it
    for disc_cfg, cfg in ((dataclasses.replace(thp.TINY_DISC, use_mpd=True), tcfg),
                          (thp.TINY_DISC, dataclasses.replace(tcfg, use_mpd=True))):
        tr = ttrainer.make_trainer(cfg, device="cpu", disc_cfg=disc_cfg)
        assert tr.disc_cfg.use_mpd and tr.init_state(0).discriminator.mpd is not None
