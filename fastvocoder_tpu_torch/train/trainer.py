"""The GAN train steps: generator and discriminator updates.

Counterpart of `fastvocoder_tpu/train/trainer.py` (the reference's per-step
`trainer()`, bin/train.py:48-255).  The host picks one of two steps at the
`discriminator_train_start_steps` boundary:

  * `pre_adv_step`: generator only, MR-STFT loss plus Basis-MelGAN's
    unscaled weight L1 (reference bin/train.py:77-89);
  * `gan_step`: the generator update with the adversarial MSE-to-ones and
    the feature-map L1 against the real features without gradient, both
    under the discriminator's weights from before its update; then the
    generator runs again with its *updated* weights under `no_grad` ("which
    leads better quality", bin/train.py:148), and the discriminator updates
    on that estimate.  The discriminator's parameters are frozen
    (`requires_grad` off) from its forward on the estimate to the end of
    the generator's update: that backward passes through it for the
    generator's parameters, and so computes no weight gradient of it.

Both optimisers are Adam(b1 0.9, b2 0.999, eps 1e-6) behind a global-norm
clip at `grad_clip_thresh`, written by hand to the JAX package's rule
(unchanged below the threshold, g / norm * threshold above: torch's own
`clip_grad_norm_` divides by norm + 1e-6), with the optional torch-style
cosine annealing evaluated at each optimiser's own update count.
Basis-MelGAN's basis is frozen: no optimiser holds it, but its gradient
counts in the clip norm (the reference clips over `model.parameters()`,
bin/train.py:133).

PyTorch is eager and stateful: a `TrainState` holds the two modules and the
two optimisers, and a step updates them in place.  The generator is the
training form (`weight_norm=True`), whose MRF and residual-stack stages run
the port's CUDA kernels on the card, forward and backward.  With
`fused_train=False` (`--fused_train 0`, the JAX package's
`FASTVOCODER_FUSED_TRAIN=0`) the generator is built so that those stages
run as the modules' library convs (cuDNN on the card) in every pass of a
step: the one a gradient is taken through, `gan_step`'s re-run without a
gradient and validation.  Basis-MelGAN's decode runs its kernel either way,
as the JAX flag does not gate it.  On the CPU both values run the modules.

NHV's noise source is drawn once a step by `Trainer.noise(step, shape)`
(by default seeded from the run's seed and the step) and goes into every
generator forward of that step, as the JAX package's `fold_in(PRNGKey(42),
step)` does; its impulse train comes from the f0 channel of the batch.
The discriminator is the composite of `disc_cfg`, with the multi-period
discriminator when `disc_cfg.use_mpd` or the model configuration's
`use_mpd` asks for it.

`compute_dtype=torch.bfloat16` is mixed-precision training, the JAX
package's `make_trainer(compute_dtype=jnp.bfloat16)` (`--mixprecision`):
generator and discriminator compute in bf16 (their convs, and the kernels'
bf16 forms on the card, forward and backward), while the parameters, the
optimisers' state, the clip and the losses stay float32 (every generator
output reaches the MR-STFT loss as float32, the GAN losses upcast the
features).  No loss scaling: bf16 has float32's exponent range.

`remat=True` is the JAX package's `make_trainer(remat=True)` (`--remat`):
the generator forward that a gradient is taken through runs under
`torch.utils.checkpoint.checkpoint(use_reentrant=False)`, so its
activations are recomputed in the backward instead of being kept through
the losses and the discriminator; in `gan_step` the discriminator applied
to the estimate is wrapped too.  The recompute runs the same kernels on
the same weights (no parameter changes before the backward), NHV's noise
is the step's explicit draw, so the step computes what it computes
without remat, at one more generator pass a generator update.

`dp` (a `parallel.DataParallel`) is data parallelism, the JAX package's
mesh step (`parallel/mesh.py::compile_train_step`): each rank steps on its
rows of the global batch, and every generator and discriminator update
first averages the ranks' gradients in one flattened all-reduce a network,
the frozen basis's gradient included, so that every rank clips by the same
global norm and the replicas stay equal (`last_grads` and `last_norms` hold
the reduced values).  The losses are the global batch's
(`losses/stft_loss.py`, `losses/gan.py`); the metrics a step returns are
this rank's (`parallel.reduce_metrics` makes them global).  NHV's noise is
the global batch's draw of the step, of which each rank takes its rows, as
JAX draws it once for the whole mesh.

With the recorder on (`runtime/profiler.py`) a step is a `train.step` span
holding its phases, in order: `train.gen_forward`, `train.recon_loss`
(MR-STFT, the weight L1), in `gan_step` `train.disc` (the discriminator on
the estimate and the real audio, the adversarial and feature-map losses),
`train.gen_backward` (the gradient), `train.gen_update` (clip and Adam),
then `train.gen_rerun` (the estimate without a gradient),
`train.disc_forward_loss`, `train.disc_backward`, `train.disc_update`.
Every span of a step carries its number.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from fastvocoder_tpu_torch.hparams import DISC, HP, DiscriminatorConfig, Hparams, ModelConfig
from fastvocoder_tpu_torch.losses import (
    adversarial_loss,
    discriminator_loss,
    feature_map_loss,
    reconstruction_loss,
    reconstruction_loss_masked,
)
from fastvocoder_tpu_torch.models.factory import build_discriminator, build_generator
from fastvocoder_tpu_torch.models.nhv import NOISE_SCALE
from fastvocoder_tpu_torch.ops.pqmf import PQMF
from fastvocoder_tpu_torch.ops.precision import check_compute_dtype
from fastvocoder_tpu_torch.parallel.distributed import DataParallel
from fastvocoder_tpu_torch.runtime.profiler import annotate

Metrics = Dict[str, torch.Tensor]
Noise = Callable[[int, Sequence[int]], torch.Tensor]


def seeded_noise(seed: int, device: torch.device) -> Noise:
    """NHV's training noise: `noise(step, shape)` is 0.3 randn of `shape`
    on `device` from a generator seeded with (seed, step), one draw a step
    whatever the number of forwards."""

    def noise(step: int, shape: Sequence[int]) -> torch.Tensor:
        g = torch.Generator(device=device).manual_seed(seed * 2 ** 32 + step)
        return NOISE_SCALE * torch.randn(tuple(shape), generator=g, device=device)

    return noise


def torch_cosine_annealing(base_lr: float, t_max: int = 2500,
                           eta_min: Optional[float] = None) -> Callable[[int], float]:
    """`torch.optim.lr_scheduler.CosineAnnealingLR`'s closed form (reference
    bin/train.py:344-351: T_max 2500, eta_min lr / 10), as a function of the
    optimiser's update count."""
    if eta_min is None:
        eta_min = base_lr / 10.0

    def schedule(count: int) -> float:
        return eta_min + (base_lr - eta_min) * 0.5 * (1.0 + math.cos(math.pi * count / t_max))

    return schedule


def _adam(params: List[nn.Parameter], lr: float) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-6)


def trainable_generator_parameters(generator: nn.Module) -> List[nn.Parameter]:
    """Every generator parameter but the frozen basis (`basis_signal.*`)."""
    return [p for name, p in generator.named_parameters()
            if not name.startswith("basis_signal.")]


def make_generator_optimizer(generator: nn.Module, hp: Hparams = HP,
                             learning_rate: Optional[float] = None) -> torch.optim.Adam:
    lr = learning_rate if learning_rate is not None else hp.learning_rate
    return _adam(trainable_generator_parameters(generator), lr)


def make_discriminator_optimizer(discriminator: nn.Module, hp: Hparams = HP,
                                 learning_rate: Optional[float] = None) -> torch.optim.Adam:
    lr = learning_rate if learning_rate is not None else hp.learning_rate_discriminator
    return _adam(list(discriminator.parameters()), lr)


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale `grads` in place to a global norm of at most `max_norm`:
    unchanged below it, g / norm * max_norm above.  -> the norm before."""
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    below = norm < max_norm
    for g in grads:
        g.copy_(torch.where(below, g, g / norm * max_norm))
    return norm


@dataclasses.dataclass
class TrainState:
    """What a run carries from step to step and into a checkpoint."""

    step: int
    generator: nn.Module
    discriminator: nn.Module
    gen_opt: torch.optim.Adam
    disc_opt: torch.optim.Adam
    gen_updates: int = 0   # updates each optimiser has made: the schedule's count
    disc_updates: int = 0


@dataclasses.dataclass(frozen=True)
class Trainer:
    """The configuration of a run and its steps.  Construct with
    `make_trainer`; `init_state` builds the modules and optimisers."""

    cfg: ModelConfig
    hp: Hparams
    disc_cfg: DiscriminatorConfig
    device: torch.device
    gen_schedule: Callable[[int], float]
    disc_schedule: Callable[[int], float]
    pqmf: Optional[PQMF]
    noise: Noise  # NHV's noise source of a step: noise(step, (B, samples))
    basis_signal_weight: Optional[np.ndarray] = None
    # the clip norms of the last step, for tests and logs: "generator",
    # "discriminator"
    last_norms: dict = dataclasses.field(default_factory=dict, compare=False)
    # with keep_grads, the last step's gradients before the clip (with dp,
    # reduced over the ranks), by parameter name, under the same two keys
    # (for comparisons; costs a copy)
    keep_grads: bool = False
    last_grads: dict = dataclasses.field(default_factory=dict, compare=False)
    compute_dtype: Optional[torch.dtype] = None  # None (float32) or torch.bfloat16
    remat: bool = False  # recompute the generator forward in the backward
    dp: Optional[DataParallel] = None  # data parallelism: gradients reduced over the ranks
    fused_train: bool = True  # False: the generator's stages run as the modules

    def init_state(self, seed: int = 0) -> TrainState:
        """Fresh modules on the trainer's device, initialised from `seed`
        (torch's default conv init, gains at the weights' norms), computing
        in the trainer's `compute_dtype` with float32 parameters, its stages
        routed by `fused_train`."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            generator = build_generator(self.cfg, weight_norm=True,
                                        basis_signal_weight=self.basis_signal_weight,
                                        compute_dtype=self.compute_dtype,
                                        fused_train=self.fused_train)
            discriminator = build_discriminator(self.disc_cfg,
                                                compute_dtype=self.compute_dtype)
        generator.to(self.device).train()
        discriminator.to(self.device).train()
        return TrainState(
            step=0, generator=generator, discriminator=discriminator,
            gen_opt=make_generator_optimizer(generator, self.hp, self.gen_schedule(0)),
            disc_opt=make_discriminator_optimizer(discriminator, self.hp, self.disc_schedule(0)),
        )

    # ---- forward helpers ----

    def _step_noise(self, state: TrainState, mel: torch.Tensor) -> Optional[torch.Tensor]:
        """NHV's noise of this step (None for the other families); with `dp`,
        this rank's rows of the global batch's draw."""
        if self.cfg.model_name != "nhv":
            return None
        B, samples = mel.shape[0], mel.shape[1] * self.cfg.arch.hop_size
        if self.dp is None:
            return self.noise(state.step, (B, samples))
        return self.noise(state.step, (B * self.dp.world, samples))[self.dp.rows(B)]

    def _gen_forward(self, generator: nn.Module, mel: torch.Tensor,
                     noise: Optional[torch.Tensor] = None):
        """The generator's training forward; NHV's with the step's `noise`
        (its inference sources without one, as validation runs it); with
        `remat`, recomputed in the backward where a gradient is taken."""

        def forward(mel, noise):
            if noise is not None:
                f0 = mel[..., self.cfg.arch.in_channels]
                return generator(mel, sources=generator.sources(f0, noise))
            return generator(mel)

        if self.remat and torch.is_grad_enabled():
            out = checkpoint(forward, mel, noise, use_reentrant=False)
        else:
            out = forward(mel, noise)
        if self.cfg.model_name == "basis-melgan":
            return out  # (est_source, est_weight)
        return out, None

    def _to_fullband(self, est: torch.Tensor) -> torch.Tensor:
        if self.pqmf is not None:
            return self.pqmf.synthesis(est)[..., 0]
        return est

    def _reduced(self, grads: Sequence[torch.Tensor]) -> Sequence[torch.Tensor]:
        """The ranks' mean of a network's gradients (one all-reduce), or the
        gradients as they are without `dp`."""
        return grads if self.dp is None else self.dp.all_reduce_mean(grads)

    def _update(self, name: str, params: List[nn.Parameter], grads, opt: torch.optim.Adam,
                lr: float, clipped_with: Tuple[torch.Tensor, ...] = ()) -> None:
        """Clip `grads` (with `clipped_with` counted in the norm), then one
        Adam update of `params` at `lr`."""
        grads = [g.contiguous() for g in grads]
        self.last_norms[name] = clip_by_global_norm_(grads + list(clipped_with),
                                                     self.hp.grad_clip_thresh)
        for p, g in zip(params, grads):
            p.grad = g
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        opt.zero_grad(set_to_none=True)

    @staticmethod
    @contextlib.contextmanager
    def _frozen(module: nn.Module):
        """`module`'s parameters out of autograd for the block: a backward
        through it computes no gradient of them."""
        params = [p for p in module.parameters() if p.requires_grad]
        for p in params:
            p.requires_grad_(False)
        try:
            yield
        finally:
            for p in params:
                p.requires_grad_(True)

    def _update_generator(self, state: TrainState, total: torch.Tensor, step: int) -> None:
        named = [(n, p) for n, p in state.generator.named_parameters()]
        with annotate("train.gen_backward", step=step):
            grads = self._reduced(torch.autograd.grad(total, [p for _, p in named]))
        with annotate("train.gen_update", step=step):
            if self.keep_grads:
                self.last_grads["generator"] = {n: g.clone() for (n, _), g in zip(named, grads)}
            frozen = tuple(g.contiguous() for (n, _), g in zip(named, grads)
                           if n.startswith("basis_signal."))
            trained = [(p, g) for (n, p), g in zip(named, grads)
                       if not n.startswith("basis_signal.")]
            self._update("generator", [p for p, _ in trained], [g for _, g in trained],
                         state.gen_opt, self.gen_schedule(state.gen_updates), frozen)
        state.gen_updates += 1

    # ---- the two steps ----

    def pre_adv_step(self, state: TrainState, mel, wav, weight=None) -> Tuple[TrainState, Metrics]:
        """Generator-only phase (step <= discriminator_train_start_steps)."""
        n = state.step + 1
        with annotate("train.step", step=n):
            with annotate("train.gen_forward", step=n):
                est, est_weight = self._gen_forward(state.generator, mel,
                                                    self._step_noise(state, mel))
            with annotate("train.recon_loss", step=n):
                stft_l, weight_l = reconstruction_loss(est, wav, est_weight=est_weight,
                                                       weight=weight, pqmf=self.pqmf, dp=self.dp)
                total = self.cfg.lambda_stft * stft_l
                metrics = {"stft_loss": stft_l}
                if weight_l is not None:
                    total = total + weight_l  # unscaled (reference bin/train.py:89)
                    metrics["weight_loss"] = weight_l
                    metrics["weight_average_value"] = est_weight.mean()
                metrics["total_loss"] = total
            self._update_generator(state, total, n)
            state.step += 1
            return state, {k: v.detach() for k, v in metrics.items()}

    def gan_step(self, state: TrainState, mel, wav, weight=None) -> Tuple[TrainState, Metrics]:
        """Full GAN phase (step > discriminator_train_start_steps): the
        generator update (stft + adv + fm), then the discriminator update on
        the estimate of the updated generator.  The discriminator always
        sees full-band waveforms."""
        n = state.step + 1
        with annotate("train.step", step=n):
            return self._gan_step(state, mel, wav, weight, n)

    def _gan_step(self, state: TrainState, mel, wav, weight, n: int) -> Tuple[TrainState, Metrics]:
        disc = state.discriminator
        with annotate("train.gen_forward", step=n):
            noise = self._step_noise(state, mel)  # one draw for both generator forwards
            est, est_weight = self._gen_forward(state.generator, mel, noise)
        with annotate("train.recon_loss", step=n):
            stft_l, _ = reconstruction_loss(est, wav, est_weight=est_weight, weight=weight,
                                            pqmf=self.pqmf, dp=self.dp)
            total = self.cfg.lambda_stft * stft_l
            metrics = {"stft_loss": stft_l}
        with self._frozen(disc):
            with annotate("train.disc", step=n):
                if self.remat:  # the discriminator's features of the estimate, recomputed too
                    est_p = checkpoint(disc, self._to_fullband(est), use_reentrant=False)
                else:
                    est_p = disc(self._to_fullband(est))
                adv_l = adversarial_loss(est_p)
                total = total + self.hp.lambda_adv * adv_l
                metrics["adversarial_loss"] = adv_l
                if self.cfg.use_feature_map_loss:
                    with torch.no_grad():
                        real_p = disc(wav)
                    fm_l = feature_map_loss(est_p, real_p)
                    total = total + self.hp.lambda_fm * fm_l
                    metrics["feature_map_loss"] = fm_l
                metrics["total_loss"] = total
            self._update_generator(state, total, n)
        del est_p, est, est_weight

        with annotate("train.gen_rerun", step=n), torch.no_grad():
            est_for_d = self._to_fullband(self._gen_forward(state.generator, mel, noise)[0])
        with annotate("train.disc_forward_loss", step=n):
            real_l, fake_l = discriminator_loss(disc(wav), disc(est_for_d))
            d_loss = real_l + fake_l
        params = list(disc.parameters())
        with annotate("train.disc_backward", step=n):
            d_grads = self._reduced(torch.autograd.grad(d_loss, params))
        with annotate("train.disc_update", step=n):
            if self.keep_grads:
                self.last_grads["discriminator"] = {
                    k: g.clone() for (k, _), g in zip(disc.named_parameters(), d_grads)}
            self._update("discriminator", params, d_grads,
                         state.disc_opt, self.disc_schedule(state.disc_updates))
        state.disc_updates += 1
        metrics["discriminator_loss"] = d_loss
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    @torch.no_grad()
    def valid_step(self, state: TrainState, mel, wav) -> torch.Tensor:
        """Validation MR-STFT loss on a fixed-size crop batch."""
        est, _ = self._gen_forward(state.generator, mel)
        return reconstruction_loss(est, wav, pqmf=self.pqmf)[0]

    @torch.no_grad()
    def valid_step_full(self, generator: nn.Module, mel, wav, valid_samples) -> torch.Tensor:
        """Full-utterance validation loss (reference bin/train.py:451-471:
        batch 1, whole items) on inputs padded to a length bucket;
        `valid_samples` masks the padded tail out of the MR-STFT loss."""
        est, _ = self._gen_forward(generator, mel)
        return reconstruction_loss_masked(est, wav, valid_samples, pqmf=self.pqmf)


def make_trainer(
    cfg: ModelConfig,
    hp: Hparams = HP,
    basis_signal_weight: Optional[np.ndarray] = None,
    use_scheduler: bool = False,
    learning_rate: Optional[float] = None,
    learning_rate_discriminator: Optional[float] = None,
    disc_cfg: DiscriminatorConfig = DISC,
    device=None,
    keep_grads: bool = False,
    seed: int = 0,
    noise: Optional[Noise] = None,
    compute_dtype: Optional[torch.dtype] = None,
    remat: bool = False,
    dp: Optional[DataParallel] = None,
    fused_train: bool = True,
) -> Trainer:
    """The trainer of `cfg` on `device`: the CUDA device by default, and a
    RuntimeError without one unless `device="cpu"` is asked for.  `noise`
    replaces NHV's draw of a step (`seeded_noise(seed, device)`); the
    discriminator takes the MPD where `cfg.use_mpd` or `disc_cfg.use_mpd`
    says so.  `compute_dtype=torch.bfloat16` trains in bf16 mixed precision
    (the module docstring says what stays float32); `remat=True`
    recomputes the generator forward in the backward (module docstring);
    `dp` reduces the gradients over a process group's ranks;
    `fused_train=False` runs the generator's stages as the modules instead
    of the kernels (both: module docstring)."""
    compute_dtype = check_compute_dtype(compute_dtype)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: fastvocoder_tpu_torch trains on the GPU; pass "
                "device='cpu' (--device cpu) to run on the CPU"
            )
        device = "cuda"
    device = torch.device(device)
    if cfg.use_mpd and not disc_cfg.use_mpd:
        disc_cfg = dataclasses.replace(disc_cfg, use_mpd=True)
    hp = hp.replace(use_feature_map_loss=cfg.use_feature_map_loss)
    lr_g = learning_rate if learning_rate is not None else hp.learning_rate
    lr_d = (learning_rate_discriminator if learning_rate_discriminator is not None
            else hp.learning_rate_discriminator)
    return Trainer(
        cfg=cfg, hp=hp, disc_cfg=disc_cfg, device=device,
        gen_schedule=torch_cosine_annealing(lr_g) if use_scheduler else (lambda count: lr_g),
        disc_schedule=torch_cosine_annealing(lr_d) if use_scheduler else (lambda count: lr_d),
        pqmf=PQMF().to(device) if cfg.multiband else None,
        noise=noise if noise is not None else seeded_noise(seed, device),
        basis_signal_weight=basis_signal_weight, keep_grads=keep_grads,
        compute_dtype=compute_dtype, remat=remat, dp=dp, fused_train=fused_train,
    )
