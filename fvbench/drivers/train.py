"""Training steps: the program's `Trainer.gan_step` or `pre_adv_step` on
crops cut on the card by its `DeviceCorpus` from a seeded corpus.

Set-up builds one trainer and state from the seed's weights and drives it
through its first `check_steps` steps on the window's own call and feed,
keeping each step's losses, the first update's gradients as the optimisers
got them (each Adam's first moment after one step over 1 - b1) and the
parameters after the last of them.  The window then runs steps on the same
object until `--seconds` have passed on the host, and closes when the card
has finished the last: `step_ms` is the window's time over its steps.

After the window the reference repeats the checked steps on the same crops
from the same weights, and three numbers are compared (`compare`): the
worst relative gap of the first step's losses, and of a leaf's gradient
norm and of its parameters' change over the steps, by the worst leaf.

Mix keys: `step`; `batch`, `frames` (crops a step, frames a crop);
`corpus` {utterances, min_frames, max_frames}; `weight_target` (Basis-MelGAN's
pre-adversarial weight L1); `check_steps`.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from fastvocoder_tpu_torch.data.device_cache import DeviceCorpus
from fastvocoder_tpu_torch.hparams import HP
from fvbench import common, program, traffic, weights
from fvbench.reference.train import ReferenceTrainer

BETA1 = 0.9
WSTEP = 16  # weight-target rows a frame: hop / (L / 2)


def corpus(ctx):
    """The seeded corpus, as chip_smoke.py writes one: per utterance a
    sum of three sines plus noise, a uniform mel, and with a weight target
    a uniform (16 T, 256) target rounded to bf16 (the precision the corpus
    keeps it in)."""
    spec, hop = ctx.mix["corpus"], ctx.hop
    g = traffic.rng(ctx.seed, 6)
    items = []
    for _ in range(spec["utterances"]):
        T = int(g.integers(spec["min_frames"], spec["max_frames"] + 1))
        t = np.arange(T * hop, dtype=np.float32) / ctx.cell.config["sample_rate"]
        wav = sum(a * np.sin(2 * np.pi * f * t + p) for a, f, p in zip(
            g.uniform(0.05, 0.2, 3), g.uniform(100, 3000, 3), g.uniform(0, 6.28, 3)))
        item = {"mel": g.random((T, 80), dtype=np.float32),
                "wav": (wav + 0.01 * g.standard_normal(t.shape)).astype(np.float32)}
        if ctx.mix.get("weight_target"):
            w = torch.from_numpy(g.random((T * WSTEP, ctx.cell.config["out_channels"]),
                                          dtype=np.float32))
            item["weight"] = w.to(torch.bfloat16).float().numpy()
        items.append(item)
    return items


def crop(items, idx, starts, fixed: int, hop: int, device):
    """The reference's own cut of the crops: (mel, wav, weight or None)."""
    def stack(key, per):
        return torch.from_numpy(np.stack([items[i][key][s * per:(s + fixed) * per]
                                          for i, s in zip(idx, starts)])).to(device)
    weight = stack("weight", WSTEP) if "weight" in items[0] else None
    return stack("mel", 1), stack("wav", hop).reshape(len(idx), -1), weight


def _leaf_norms(named):
    return {n: float(torch.linalg.vector_norm(t)) for n, t in named}


def compare(prog: dict, ref: dict) -> dict:
    """first_loss_gap: the worst |L - L_ref| / |L_ref| over the first step's
    losses (the generator's, and in a GAN step the discriminator's, taken
    after the generator's first update).  The later steps' losses are not
    compared: Adam moves each weight whose gradient is rounding's size by a
    whole step of either sign, so their gaps swing from seed to seed; the
    gradient and change gaps hold the updates.  grad_gap: the worst leaf's
    |‖g‖ - ‖g_ref‖| / max(‖g_ref‖, the median leaf's ‖g_ref‖), first update.
    change_gap: the same of the parameters' change over the checked steps,
    over the leaves whose reference gradient is at least a thousandth of the
    median leaf's (the others move under Adam by round-off alone)."""
    first_loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"][0],
                                                             ref["losses"][0]))

    def gap(p: dict, r: dict, keys) -> float:
        med = float(np.median([r[k] for k in r]))
        return max((abs(p[k] - r[k]) / max(r[k], med) for k in keys), default=0.0)

    grad_gap, change_gap = 0.0, 0.0
    for net in ref["grads"]:
        g_ref = ref["grads"][net]
        grad_gap = max(grad_gap, gap(prog["grads"][net], g_ref, g_ref))
        med = float(np.median(list(g_ref.values())))
        moved = [k for k, v in g_ref.items() if v >= 1e-3 * med]
        change_gap = max(change_gap, gap(prog["change"][net], ref["change"][net], moved))
    return {"first_loss_gap": first_loss_gap, "grad_gap": grad_gap, "change_gap": change_gap}


def details(prog: dict, ref: dict) -> str:
    """For the log: each step's loss gaps, and the leaves that set the
    gradient and change gaps with their norms."""
    steps = [[f"{abs(p - r) / abs(r):.3g}" for p, r in zip(ps, rs)]
             for ps, rs in zip(prog["losses"], ref["losses"])]
    out = [f"loss gaps by step {steps}"]
    for what in ("grads", "change"):
        for net, r in ref[what].items():
            med = float(np.median(list(r.values())))
            k = max(r, key=lambda k: abs(prog[what][net][k] - r[k]) / max(r[k], med))
            out.append(f"{what} {net}: worst {k} {prog[what][net][k]:.6g} against "
                       f"{r[k]:.6g}, median leaf {med:.6g}")
    return "; ".join(out)


def pace(t0: float, sent) -> str:
    """For the log: the steps sent in each 5-s slice of the window, so that a
    host that stalls or slows shows where."""
    counts = np.bincount(((np.asarray(sent) - t0) // 5.0).astype(int))
    return f"steps sent a 5-s slice {counts.tolist()}"


def _losses(metrics: dict, gan: bool):
    keys = ("total_loss", "discriminator_loss") if gan else ("total_loss",)
    return [metrics[k] for k in keys]


def run(ctx):
    mix, cfg = ctx.mix, ctx.cell.config
    gan = mix["step"] == "gan_step"
    family, disc_family = ctx.family, ctx.disc_family
    items = corpus(ctx)
    dc = DeviceCorpus(items, hp=HP.replace(fixed_length=mix["frames"]), L=cfg.get("L"),
                      device=ctx.device, log=ctx.stderr)
    frames = np.array([it["mel"].shape[0] for it in items])
    stream = traffic.crops(ctx.seed, frames, mix["batch"], mix["frames"])
    ctx.phase("corpus")
    trainer, state = program.trainer_and_state(
        ctx.cell, weights.make_params(family, cfg, ctx.seed, ctx.device),
        weights.make_params(disc_family, cfg["discriminator"], ctx.seed, ctx.device), ctx.device)
    nets = {"generator": (state.generator, state.gen_opt)}
    if gan:
        nets["discriminator"] = (state.discriminator, state.disc_opt)
    weighted = bool(mix.get("weight_target"))
    ctx.phase("weights and program")

    def step():
        idx, starts = stream.next()
        b = dc.gather(idx, starts, with_weight=weighted)
        if gan:
            _, m = trainer.gan_step(state, b["mel"], b["wav"])
        else:
            _, m = trainer.pre_adv_step(state, b["mel"], b["wav"], weight=b.get("weight"))
        return (idx, starts), m

    checked, losses, first = [], [], {}
    for k in range(mix["check_steps"]):
        batch, m = step()
        checked.append(batch)
        losses.append(_losses(m, gan))
        if k == 0:
            first = {net: {n: torch.linalg.vector_norm(opt.state[p]["exp_avg"]) / (1 - BETA1)
                           for n, p in mod.named_parameters() if p in opt.state}
                     for net, (mod, opt) in nets.items()}
    after = {net: {n: p.detach().clone() for n, p in mod.named_parameters()}
             for net, (mod, _) in nets.items()}
    common.sync(ctx.device)
    ctx.phase(f"{mix['check_steps']} checked steps")

    n, sent = 0, []
    with ctx.window():
        t0 = ctx.t0 = time.perf_counter()
        while True:
            step()
            n += 1
            ctx.progress = n
            sent.append(time.perf_counter())
            if sent[-1] - t0 >= ctx.seconds:
                break
            ctx.tick()
        common.sync(ctx.device)
        t1 = time.perf_counter()
    ctx.window_done(attempted=n, failed=0)
    ctx.stderr(f"window: {pace(t0, sent)}; {ctx.gc_pauses()}")
    ctx.e2e["step_ms"] = (t1 - t0) / n * 1e3
    del trainer, state, nets, dc
    ctx.free()

    start = {"generator": weights.make_params(family, cfg, ctx.seed, ctx.device)}
    if gan:
        start["discriminator"] = weights.make_params(disc_family, cfg["discriminator"], ctx.seed,
                                                     ctx.device)
    prog = {"losses": [[float(v) for v in ls] for ls in losses],
            "grads": {net: {k: float(v) for k, v in g.items()} for net, g in first.items()},
            "change": {net: _leaf_norms((k, after[net][k] - start[net][k]) for k in first[net])
                       for net in first}}
    del after
    ref = reference_run(ctx, items, checked, gan, first)
    ctx.stderr(details(prog, ref))
    ctx.checks.update(compare(prog, ref))
    return ctx


def reference_run(ctx, items, checked, gan: bool, first) -> dict:
    """The reference's readings over the checked steps."""
    cfg, mix = ctx.cell.config, ctx.mix
    family, disc_family = ctx.family, ctx.disc_family
    ref = ReferenceTrainer(
        family=family, disc_family=disc_family, arch=cfg, disc_cfg=cfg["discriminator"],
        lambda_stft=cfg["lamda_stft"], use_feature_map_loss=cfg["use_feature_map_loss"],
        gen=weights.make_params(family, cfg, ctx.seed, ctx.device, grad=True),
        disc=(weights.make_params(disc_family, cfg["discriminator"], ctx.seed, ctx.device,
                                  grad=True) if gan else {}))
    start = {"generator": {k: v.detach().clone() for k, v in ref.gen.items()},
             "discriminator": {k: v.detach().clone() for k, v in ref.disc.items()}}
    losses = []
    for idx, starts in checked:
        mel, wav, weight = crop(items, idx, starts, mix["frames"], ctx.hop, ctx.device)
        out = ref.gan_step(mel, wav) if gan else ref.pre_adv_step(mel, wav, weight)
        losses.append([out["generator"], out["discriminator"]] if gan else [out["generator"]])
    params = {"generator": ref.gen, "discriminator": ref.disc}
    return {"losses": losses,
            "grads": {net: _leaf_norms((k, ref.first_grads[net][k]) for k in first[net])
                      for net in first},
            "change": {net: _leaf_norms((k, params[net][k].detach() - start[net][k])
                                        for k in first[net]) for net in first}}
