"""Checkpoints that cross between the JAX package and the port, on the CPU:
a JAX-trained checkpoint in the port (`tests/test_torch_reference_checkpoint.py`
takes the other direction and holds the helpers both files use).

  * a checkpoint the JAX trainer wrote after 2 steps, optimiser included,
    resumes in the port (no JAX or optax needed to read it).  The update
    the port's optimiser makes from the loaded Adam state, given JAX's
    gradients, is the one optax makes from the file: every parameter within
    1e-3 of the learning rate plus two float32 ulps of its value.  The
    port's whole next step is JAX's next step from the same file, held as
    `tests/test_torch_trainer.py` holds one step: every loss within rtol
    1e-4; gradients before the clip within 3e-3 of their peaks; the parameters after the step within 2 % of the
    learning rate wherever the clipped gradient is at least 1e-4, more than
    half of them moved there.  Basis-MelGAN's whole step is held by its
    losses and by gradients within 1e-2 of their peaks: its narrow
    generator's estimate is near silent after two steps, many STFT bins lie
    near the log-magnitude loss's clamp, and the float32 rounding of the
    estimate alone moves the gradient by up to a few 1e-3 of its peak, the
    log-magnitude STFT loss's ill-conditioning that
    `tests/test_torch_trainer.py` describes, larger here than at
    initialisation (`ROADMAP.md` C); Adam's second-moment update passes it on
    to the parameters.  In float64 both packages take the same gradient
    (the last test).  MelGAN's narrow random-init generator is held the same
    way: its float32 loss gradient is 6e-3 to 8e-3 of its peak off float64
    in either package (`ROADMAP.md` C; tests/test_torch_trainer.py starts
    MelGAN from its release weights for that reason), so one of its gains'
    gradients comes 3.2e-3 of the peak off JAX's.  Cases: HiFiGAN's GAN step against MSD, MFD
    and the MPD (2-D kernels' moments), Basis-MelGAN's pre-adversarial step
    (optax's masked state of the frozen basis), NHV's (its flat layout and
    root `fir`), MultiBand-HiFiGAN's (its `trunk` key map) and MelGAN's GAN
    step against MSD, MFD and the MPD;
  * `load_generator` synthesizes such a file within 1e-4 of the peak of
    the JAX generator's output on the same weights.
"""

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
from fastvocoder_tpu.train import checkpoint as jck
from fastvocoder_tpu_torch.checkpoint import checkpoint_format
from fastvocoder_tpu_torch.models.factory import load_generator
from fastvocoder_tpu_torch.train import checkpoint as tck
from test_torch_reference_checkpoint import (  # noqa: F401 (a fixture)
    BASIS_GRAD_TOL,
    GRAD_TOL,
    LOSS_RTOL,
    SMALL_GRAD,
    STEP_TOL,
    SYNTH_TOL,
    UPDATE_TOL,
    _as_state_dict,
    _batch,
    _cfgs,
    _close,
    _jax_noise,
    _jax_sources,
    _jax_trainer,
    _port_trainer,
    one_torch_thread,
)


def _jax_grads(jtr, jstate, step, mel, wav, weight):
    """The gradients JAX's `step` takes from `jstate` (before the clip):
    {"generator": tree[, "discriminator": tree]}, and its result."""
    mel = jnp.asarray(mel)

    def pre_adv(gen_params):
        est, est_w = jtr._gen_forward(gen_params, mel, step=jstate.step)
        stft_l, weight_l = reconstruction_loss(est, wav, est_weight=est_w, weight=weight,
                                               pqmf=jtr.pqmf)
        total = jtr.cfg.lambda_stft * stft_l
        return total if weight_l is None else total + weight_l

    def gan_gen(gen_params):
        est, _ = jtr._gen_forward(gen_params, mel, step=jstate.step)
        stft_l, _ = reconstruction_loss(est, wav, pqmf=jtr.pqmf)
        d = lambda w: jtr.discriminator.apply({"params": jstate.disc_params}, w)
        est_p, real_p = d(jtr._to_fullband(est)), d(wav)
        return (jtr.cfg.lambda_stft * stft_l + jtr.hp.lambda_adv * adversarial_loss(est_p)
                + jtr.hp.lambda_fm * feature_map_loss(est_p, real_p))

    def gan_disc(disc_params, new_gen_params):
        est, _ = jtr._gen_forward(new_gen_params, mel, step=jstate.step)
        est = jax.lax.stop_gradient(jtr._to_fullband(est))
        d = lambda w: jtr.discriminator.apply({"params": disc_params}, w)
        real_l, fake_l = discriminator_loss(d(wav), d(est))
        return real_l + fake_l

    if step == "pre_adv_step":
        new, metrics = jax.jit(jtr.pre_adv_step)(jstate, mel, wav, weight)
        return {"generator": jax.jit(jax.grad(pre_adv))(jstate.gen_params)}, new, metrics
    new, metrics = jax.jit(jtr.gan_step)(jstate, mel, wav)
    return ({"generator": jax.jit(jax.grad(gan_gen))(jstate.gen_params),
             "discriminator": jax.jit(jax.grad(gan_disc))(jstate.disc_params, new.gen_params)},
            new, metrics)


def _assert_grads(got, want_tree, tol=GRAD_TOL):
    want = _as_state_dict(want_tree)
    assert set(got) == set(want)
    for k, w in want.items():
        peak = w.abs().max().item()
        sibling = k.rsplit(".", 1)[0] + ".weight"
        if sibling in want:
            peak = max(peak, want[sibling].abs().max().item())
        err = (got[k] - w).abs().max().item()
        assert err <= tol * max(peak, 1e-12), f"{k}: max abs {err:.3e}, peak {peak:.3e}"


def _assert_params(module, before, after_tree, grads_tree, lr):
    """Parameters after the step within STEP_TOL of the learning rate where
    the clipped gradient is at least SMALL_GRAD; more than half of them moved
    by at least a tenth of it there."""
    norm = float(optax.global_norm(grads_tree))
    scale = 1.0 if norm < 1.0 else 1.0 / norm
    want, grads = _as_state_dict(after_tree), _as_state_dict(grads_tree)
    got = module.state_dict()
    checked = moved = 0
    for k, w in want.items():
        if k.startswith("basis_signal."):
            torch.testing.assert_close(got[k], before[k], rtol=0, atol=0)
            continue
        keep = (grads[k] * scale).abs() >= SMALL_GRAD
        err = (got[k] - w).abs()[keep]
        if err.numel():
            assert err.max().item() <= STEP_TOL * lr, f"{k}: {err.max().item():.3e}"
        checked += int(keep.sum())
        moved += int(((got[k] - before[k]).abs()[keep] > 0.1 * lr).sum())
    assert checked > 100 and moved > checked // 2


RESUMED = {"hifigan": "gan_step", "basis-melgan": "pre_adv_step", "nhv": "pre_adv_step",
           "multiband-hifigan": "pre_adv_step", "melgan": "gan_step"}
WITH_MPD = ("hifigan", "melgan")  # trained against MSD, MFD and the MPD
# generators whose float32 gradient is ill-conditioned here (module
# docstring): held by the losses and by gradients within BASIS_GRAD_TOL
ILL_CONDITIONED = ("basis-melgan", "melgan")


@pytest.fixture(scope="module")
def jax_trained(tmp_path_factory):
    """name -> (path, JAX trainer): 2 JAX steps of `RESUMED[name]` (HiFiGAN
    and MelGAN against the MPD too), saved by the JAX package's trainer with both optax
    states; made once a module."""
    made = {}

    def get(name):
        if name not in made:
            step = RESUMED[name]
            jtr = _jax_trainer(name, use_mpd=name in WITH_MPD)
            jstate = jtr.init_state(jax.random.PRNGKey(0))
            for seed in (1, 2):
                mel, wav, weight = _batch(name, seed)
                if step == "pre_adv_step":
                    jstate, _ = jax.jit(jtr.pre_adv_step)(jstate, mel, wav, weight)
                else:
                    jstate, _ = jax.jit(jtr.gan_step)(jstate, mel, wav)
            path = str(tmp_path_factory.mktemp(name) / "checkpoint_2.pth.tar")
            jck.save_checkpoint(path, jtr.cfg, jstate.gen_params, jstate.disc_params,
                                jstate.gen_opt_state, jstate.disc_opt_state, step=2,
                                disc_cfg=jtr.discriminator.cfg)
            made[name] = path, jtr
        return made[name]

    return get


@pytest.mark.parametrize("name", sorted(RESUMED))
def test_a_jax_trained_checkpoint_resumes_in_the_port(jax_trained, name):
    step, use_mpd = RESUMED[name], name in WITH_MPD
    path, jtr = jax_trained(name)
    assert checkpoint_format(path) == "reference"

    # JAX's own next step from the file
    ck = jck.load_checkpoint(path, jtr.cfg, disc_cfg=jtr.discriminator.cfg)
    jstate = jtr.init_state(jax.random.PRNGKey(5)).replace(
        step=jnp.asarray(ck["step"], jnp.int32), gen_params=ck["gen_params"],
        disc_params=ck["disc_params"], gen_opt_state=ck["optimizer"],
        disc_opt_state=ck["discriminator_optimizer"])
    mel, wav, weight = _batch(name, 3)
    jgrads, jnew, jmetrics = _jax_grads(jtr, jstate, step, mel, wav, weight)

    # the update from the loaded Adam state, given JAX's own gradients
    who = ("generator", "discriminator") if step == "gan_step" else ("generator",)
    for w in who:
        _assert_update_from_file(path, name, use_mpd, w, jtr, jstate, jgrads[w])

    kw = {}
    if name == "nhv":
        noise = _jax_noise(jtr, jstate, mel)
        kw["noise"] = lambda s, shape: torch.from_numpy(noise)
    ttr = _port_trainer(name, use_mpd=use_mpd, keep_grads=True, **kw)
    state = ttr.init_state(9)  # other weights: all of them come from the file
    tck.load_checkpoint(path, state, name)
    assert (state.step, state.gen_updates) == (2, 2)
    assert state.disc_updates == (2 if step == "gan_step" else 0)
    gen_before = {k: v.clone() for k, v in state.generator.state_dict().items()}
    disc_before = {k: v.clone() for k, v in state.discriminator.state_dict().items()}
    _, metrics = getattr(ttr, step)(state, torch.from_numpy(mel), torch.from_numpy(wav),
                                    None if weight is None else torch.from_numpy(weight))
    assert set(metrics) == set(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=LOSS_RTOL,
                                   err_msg=k)
    if name in ILL_CONDITIONED:
        _assert_grads(ttr.last_grads["generator"], jgrads["generator"], BASIS_GRAD_TOL)
    else:
        _assert_grads(ttr.last_grads["generator"], jgrads["generator"])
        _assert_params(state.generator, gen_before, jnew.gen_params, jgrads["generator"],
                       jhp.HP.learning_rate)
    if step == "gan_step":
        _assert_grads(ttr.last_grads["discriminator"], jgrads["discriminator"])
        _assert_params(state.discriminator, disc_before, jnew.disc_params,
                       jgrads["discriminator"], jhp.HP.learning_rate_discriminator)
    assert (state.step, state.gen_updates) == (3, 3)


def _assert_update_from_file(path, name, use_mpd, who, jtr, jstate, jgrad_tree):
    """`who`'s optimiser loaded from `path` by the port and given JAX's
    gradients updates the parameters as optax does from the same file."""
    if who == "generator":
        tx, params, opt_state = jtr.gen_tx, jstate.gen_params, jstate.gen_opt_state
        lr = jhp.HP.learning_rate
    else:
        tx, params, opt_state = jtr.disc_tx, jstate.disc_params, jstate.disc_opt_state
        lr = jhp.HP.learning_rate_discriminator
    updates, _ = tx.update(jgrad_tree, opt_state, params)
    want = _as_state_dict(optax.apply_updates(params, updates))

    ttr = _port_trainer(name, use_mpd=use_mpd)
    state = ttr.init_state(9)
    tck.load_checkpoint(path, state, name)
    module = getattr(state, who)
    grads = _as_state_dict(jgrad_tree)
    named = [(n, p) for n, p in module.named_parameters()]
    trained = [(p, grads[n]) for n, p in named if not n.startswith("basis_signal.")]
    frozen = tuple(grads[n] for n, _ in named if n.startswith("basis_signal."))
    if who == "generator":
        opt, sched = state.gen_opt, ttr.gen_schedule(state.gen_updates)
    else:
        opt, sched = state.disc_opt, ttr.disc_schedule(state.disc_updates)
    ttr._update(who, [p for p, _ in trained], [g for _, g in trained], opt, sched, frozen)
    got = module.state_dict()
    eps = torch.finfo(torch.float32).eps
    for k, w in want.items():
        excess = ((got[k] - w).abs() - (UPDATE_TOL * lr + 2 * eps * w.abs())).max().item()
        assert excess <= 0, f"{who} {k}: {excess:.3e} beyond"


@pytest.mark.parametrize("name", sorted(RESUMED))
def test_load_generator_synthesizes_a_jax_trained_checkpoint(jax_trained, name):
    path, jtr = jax_trained(name)
    _, tcfg, _ = _cfgs(name)
    gen, pattern = load_generator(path, tcfg, torch.device("cpu"))
    assert pattern is None
    ck = jck.load_checkpoint(path, jtr.cfg, with_discriminator=False)
    mel = np.random.default_rng(5).standard_normal((1, 23, 80)).astype(np.float32)
    if name == "nhv":
        mel = np.concatenate([mel, np.full((1, 23, 1), 200.0, np.float32)], axis=-1)
        got = gen(torch.from_numpy(mel), sources=_jax_sources(mel))
    else:
        got = gen(torch.from_numpy(mel))
    want = jtr.generator.apply({"params": ck["gen_params"]}, jnp.asarray(mel))
    if name != "basis-melgan":
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        _close(g.numpy(), w, SYNTH_TOL, name)


def test_basis_melgan_resumed_gradient_in_float64_is_jaxs(jax_trained):
    """The resumed Basis-MelGAN step's gradient, both packages in float64 on
    the file's weights: within 1e-6 of each gradient's peak (measured
    2e-7).  The formulas are the same; the float32 distance the module
    docstring describes is rounding at a near-silent estimate."""
    from fastvocoder_tpu_torch.losses import reconstruction_loss as port_loss

    path, jtr = jax_trained("basis-melgan")
    ck = jck.load_checkpoint(path, jtr.cfg, disc_cfg=jtr.discriminator.cfg)
    mel, wav, weight = _batch("basis-melgan", 3)
    with jax.enable_x64(True):
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), jnp.float64),
                                        ck["gen_params"])
        jstate = jtr.init_state(jax.random.PRNGKey(5)).replace(
            step=jnp.asarray(2, jnp.int32), gen_params=params)
        jgrads, _, _ = _jax_grads(jtr, jstate, "pre_adv_step", *(
            a.astype(np.float64) for a in (mel, wav, weight)))
        want = _as_state_dict(jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                                     jgrads["generator"]))

    ttr = _port_trainer("basis-melgan")
    state = ttr.init_state(9)
    tck.load_checkpoint(path, state, "basis-melgan")
    gen = state.generator.double()
    est, est_w = gen(torch.from_numpy(mel).double())
    assert est.dtype == torch.float64
    stft_l, weight_l = port_loss(est, torch.from_numpy(wav).double(), est_weight=est_w,
                                 weight=torch.from_numpy(weight).double())
    (ttr.cfg.lambda_stft * stft_l + weight_l).backward()
    got = {k: p.grad for k, p in gen.named_parameters() if not k.startswith("basis_signal.")}
    assert set(got) == {k for k in want if not k.startswith("basis_signal.")}
    for k, g in got.items():
        peak = want[k].abs().max().item()
        assert (g - want[k]).abs().max().item() <= 1e-6 * peak, k
