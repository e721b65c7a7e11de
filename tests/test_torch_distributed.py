"""Data parallelism of the port (`fastvocoder_tpu_torch/parallel/`) on the
CPU: two gloo processes against one process and against the JAX package's
step on a 2-device mesh, the counterpart of `tests/test_multihost.py`.

Four cases at the trainer tests' tiny widths, 2 steps each on global
batches of 4 rows whose halves differ in loudness (0.1x and 1x, so that a
spectral convergence computed shard by shard would show): MelGAN's and
NHV's `pre_adv_step`, Basis-MelGAN's with the weight target (its frozen
basis's gradient is reduced and counted in the clip norm) and HiFiGAN's
`gan_step` against `TINY_DISC`.  NHV's noise is the JAX step's own draw of
the global batch, handed to both packages; each rank takes its rows.
Every package starts from the same weights, initialised on the JAX side.

Held, the two ranks (`tests/_torch_dp_child.py`) against one process of
the port on the whole batch, in float32: the first step's losses within
1e-6 relative, its reduced gradients within 1e-5 of each tensor's peak,
its clip norms within 1e-5, the parameters after it within 1e-6; the
second step's losses within 1e-4 and the parameters after it within 1e-6
where both steps' clipped gradients are at least 1e-4; the two ranks'
parameters equal after every step.  Where more is allowed, float32
rounding, measured, needs it (`LOSS_RTOL`, `GRAD_TOL`, `_well_conditioned`:
Adam's first steps, lr g / (|g| + eps), turn rounding where |g| is near
eps into moves of up to lr, 3.8e-6 after two steps).  Basis-MelGAN also
runs in float64, where two ranks equal one process within 1e-10 of each
gradient's peak.  Against the JAX package's mesh step, the first step:
losses within 1e-4, gradients within 3e-3 of their peaks (MelGAN's narrow
random init 1e-2: its float32 gradient is ill-conditioned, 7.5e-3 of its
peak off float64 in JAX itself, `tests/test_torch_trainer.py`), the clip
norm and the parameters as `tests/test_torch_trainer.py` holds them;
Basis-MelGAN's gradients in float64, within 1e-6.

Then the input sharding (`batch_iterator`, `DeviceCorpus.batches` with
`shard_count=2`) against the JAX functions bit for bit, and
`bin/train.py::run_train` in two gloo ranks: rank 0 alone writes, both log
the same global metrics, and the deadline is rank 0's clock's, so that the
ranks stop at one step whichever clock runs ahead.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from _torch_dp_child import CASES, FIXED, N_STEPS, RUNS, WORLD, basis, global_batch, model_config
from _torch_dp_child import run_steps, spawn, step_kind
from test_torch_train_driver import _argv, corpus, one_torch_thread  # noqa: F401
from test_torch_trainer import _as_state_dict, _jax_loss_fns, _jax_noise

from fastvocoder_tpu import hparams as jhp
from fastvocoder_tpu import parallel as jpar
from fastvocoder_tpu.train import trainer as jtrainer
from fastvocoder_tpu_torch import hparams as thp
from fastvocoder_tpu_torch.data.dataset import BufferDataset, batch_iterator, num_batches_per_epoch
from fastvocoder_tpu_torch.data.device_cache import DeviceCorpus
from fastvocoder_tpu_torch.parallel import DataParallel
from fastvocoder_tpu_torch.train.trainer import make_trainer, seeded_noise

# two ranks against one process (float32): the losses of the first and the
# second step, the first step's gradients of their peaks (the narrow
# random-init MelGAN's and Basis-MelGAN's float32 gradients are set by
# rounding, 5.6e-3 and 3.7e-2 of their peaks off float64: two summation
# orders lie 1.4e-5 and 1.1e-5 apart there), the parameters
LOSS_RTOL, GRAD_TOL, PARAM_TOL = (1e-6, 1e-4), {"melgan": 3e-5, "basis-melgan": 3e-5}, 1e-6
JAX_LOSS_RTOL, STEP_TOL, SMALL_GRAD = 1e-4, 0.02, 1e-4  # against JAX, as the trainer tests
JAX_GRAD_TOL = {"melgan": 1e-2}  # else 3e-3


def _jax_case(case, work, dtype):
    """The JAX package's run of `case` in `dtype` on a 2-device mesh (float64
    under `jax.enable_x64`, from the float32 initial state cast); writes the
    children's spec (that state, the global batches, NHV's noise) to
    `work/<case>.<dtype>.npz`; -> (per step (metrics, gradients, clip norm
    of each network, parameters after it), the spec)."""
    import contextlib

    x64 = dtype == "float64"
    with jax.enable_x64(True) if x64 else contextlib.nullcontext():
        tr = jtrainer.make_trainer(model_config(jhp, case),
                                   hp=jhp.HP.replace(fixed_length=FIXED),
                                   basis_signal_weight=basis(case), disc_cfg=jhp.TINY_DISC)
        state = tr.init_state(jax.random.PRNGKey(0))
        spec = {f"init/gen.{k}": v.numpy() for k, v in _as_state_dict(state.gen_params).items()}
        spec.update({f"init/disc.{k}": v.numpy()
                     for k, v in _as_state_dict(state.disc_params).items()})
        if x64:
            wide = lambda tree: jax.tree_util.tree_map(  # noqa: E731
                lambda a: jnp.asarray(np.asarray(a), jnp.float64), tree)
            gen, disc = wide(state.gen_params), wide(state.disc_params)
            state = state.replace(gen_params=gen, disc_params=disc,
                                  gen_opt_state=tr.gen_tx.init(gen),
                                  disc_opt_state=tr.disc_tx.init(disc))
        mesh = jpar.make_mesh(jax.devices()[:WORLD])
        with_weight = case == "basis-melgan"
        compile_ = jpar.compile_train_step if with_weight else jpar.compile_train_step_no_weight
        step = compile_(getattr(tr, step_kind(case)), mesh, donate_state=False)
        state = jpar.replicate_state(state, mesh)
        steps = []
        for s in range(N_STEPS):
            mel, wav, weight = global_batch(case, s)
            spec.update({f"mel{s}": mel, f"wav{s}": wav})
            if weight is not None:
                spec[f"weight{s}"] = weight
            mel, wav, weight = (None if a is None else a.astype(dtype) for a in (mel, wav, weight))
            if case == "nhv":
                spec[f"noise{s}"] = _jax_noise(tr, jax.device_get(state), mel)
            pre_adv, gan_gen, gan_disc = _jax_loss_fns(tr, jax.device_get(state), mel, wav,
                                                       weight)
            batch = jpar.shard_batch({k: v for k, v in (("mel", mel), ("wav", wav),
                                                        ("weight", weight)) if v is not None},
                                     mesh)
            new, metrics = step(state, *batch.values())
            if case == "hifigan":
                grads = {"generator": jax.jit(jax.grad(gan_gen))(state.gen_params),
                         "discriminator": jax.jit(jax.grad(gan_disc))(state.disc_params,
                                                                      new.gen_params)}
            else:
                grads = {"generator": jax.jit(jax.grad(pre_adv))(state.gen_params)}
            steps.append(({k: float(v) for k, v in jax.device_get(metrics).items()},
                          {who: _np_state_dict(g) for who, g in grads.items()},
                          {who: float(optax.global_norm(g)) for who, g in grads.items()},
                          {"generator": _np_state_dict(new.gen_params),
                           "discriminator": _np_state_dict(new.disc_params)}))
            state = new
    np.savez(os.path.join(work, f"{case}.{dtype}.npz"), **spec)
    return steps, spec


def _np_state_dict(tree):
    """A JAX tree as the port's state dict of numpy arrays (float32: a
    float64 tree's values rounded once, 6e-8 of each value)."""
    return {k: v.numpy() for k, v in _as_state_dict(tree).items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every (case, type) of `RUNS`: the JAX mesh run, the port in one
    process on the whole batch, and the port's two gloo ranks (one pair of
    processes for all), on one intra-op thread, the count before it restored
    at teardown."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    work = str(tmp_path_factory.mktemp("dp"))
    out = {}
    for case, dtype in RUNS:
        jax_steps, spec = _jax_case(case, work, dtype)
        out[case, dtype] = {"jax": jax_steps, "init_basis": spec.get("init/gen.basis_signal.basis"),
                            "one": run_steps(case, spec, slice(None), dtype=dtype)}
    spawn("steps", work)
    for case, dtype in RUNS:
        for r in range(WORLD):
            with np.load(os.path.join(work, f"{case}.{dtype}.rank{r}.npz")) as z:
                out[case, dtype][f"rank{r}"] = dict(z)
    yield out
    torch.set_num_threads(threads)


def _by_prefix(res, prefix):
    return {k[len(prefix):]: v for k, v in res.items() if k.startswith(prefix)}


def _worst(got, want):
    """The largest |got - want| over each tensor's peak (a gain's or bias's
    against its conv weight's peak, if larger), and where."""
    worst, where = 0.0, ""
    for k, w in want.items():
        w = np.asarray(w, np.float64)
        peak = np.abs(w).max()
        sibling = k.rsplit(".", 1)[0] + ".weight"
        if sibling in want:
            peak = max(peak, np.abs(np.asarray(want[sibling])).max())
        err = np.abs(np.asarray(got[k], np.float64) - w).max() / max(peak, 1e-30)
        if err > worst:
            worst, where = err, k
    return worst, where


def _well_conditioned(res, prefix, steps):
    """The parameters' entries whose clipped gradient was at least
    SMALL_GRAD in every one of `steps`: elsewhere Adam's first steps, lr g /
    (|g| + eps), turn rounding into moves of up to lr."""
    who = "generator" if prefix == "gen." else "discriminator"
    masks = {}
    for k, v in _by_prefix(res, f"p0/{prefix}").items():
        keep = np.ones(v.shape, bool)
        for s in steps:
            g = res.get(f"g{s}/{who}/{k}")
            scale = min(1.0, 1.0 / float(res.get(f"n{s}/{who}", 1.0)))
            keep &= g is not None and np.abs(g * scale) >= SMALL_GRAD
        masks[k] = keep
    return masks


@pytest.mark.parametrize("case", CASES)
def test_two_ranks_equal_one_process(runs, case):
    one, r0, r1 = (runs[case, "float32"][k] for k in ("one", "rank0", "rank1"))
    for s in range(N_STEPS):
        for k, want in _by_prefix(one, f"m{s}/").items():
            for r in (r0, r1):
                np.testing.assert_allclose(r[f"m{s}/{k}"], want, rtol=LOSS_RTOL[s], err_msg=k)
        for prefix in ("gen.", "disc."):
            for k in _by_prefix(one, f"p{s}/{prefix}"):
                np.testing.assert_array_equal(r1[f"p{s}/{prefix}{k}"], r0[f"p{s}/{prefix}{k}"],
                                              err_msg=f"the replicas differ: {k}")
    assert set(_by_prefix(r0, "m0/")) == set(_by_prefix(one, "m0/"))
    for k, want in _by_prefix(one, "n0/").items():  # float32 sums of squares
        np.testing.assert_allclose(r0[f"n0/{k}"], want, rtol=1e-5, err_msg=k)
    for who in ("generator", "discriminator"):
        want = _by_prefix(one, f"g0/{who}/")
        if want:
            worst, where = _worst(_by_prefix(r0, f"g0/{who}/"), want)
            tol = GRAD_TOL.get(case, 1e-5)
            assert worst <= tol, f"{who} {where}: {worst:.2e} of its peak"
    for k, want in _by_prefix(one, "p0/").items():
        np.testing.assert_allclose(r0[f"p0/{k}"], want, rtol=0, atol=PARAM_TOL, err_msg=k)
    last = N_STEPS - 1
    for prefix in ("gen.", "disc."):
        for k, keep in _well_conditioned(one, prefix, range(N_STEPS)).items():
            err = np.abs(r0[f"p{last}/{prefix}{k}"] - one[f"p{last}/{prefix}{k}"])[keep]
            tol = PARAM_TOL * (3 if case == "melgan" else 1)
            assert err.size == 0 or err.max() <= tol, f"{prefix}{k}: {err.max():.2e}"


def test_the_reduction_is_exact_in_float64(runs):
    """Basis-MelGAN in float64 (its weight L1 sums in float32): the two ranks'
    gradients are the one process's to rounding, so the construction of the
    global spectral convergence and the reduced frozen basis are exact."""
    one, r0 = runs["basis-melgan", "float64"]["one"], runs["basis-melgan", "float64"]["rank0"]
    for s in range(N_STEPS):
        worst, where = _worst(_by_prefix(r0, f"g{s}/generator/"),
                              _by_prefix(one, f"g{s}/generator/"))
        assert worst <= 1e-10, f"step {s + 1} {where}: {worst:.2e}"
        for k, want in _by_prefix(one, f"m{s}/").items():
            np.testing.assert_allclose(r0[f"m{s}/{k}"], want, rtol=1e-6, err_msg=k)
        for k, want in _by_prefix(one, f"p{s}/").items():
            np.testing.assert_allclose(r0[f"p{s}/{k}"], want, rtol=0, atol=1e-12, err_msg=k)


@pytest.mark.parametrize("case,dtype", RUNS)
def test_two_ranks_equal_the_jax_mesh_step(runs, case, dtype):
    """The first step against the JAX package's mesh step (the trainer
    tests' rules); Basis-MelGAN's float32 gradient at its near-silent
    random-init estimate is set by rounding (3.7e-2 of its peak off float64
    in the port, 2.2e-4 in JAX), so its gradients and parameters are held
    in float64, within 1e-6 of their peaks."""
    r0, jax_steps = runs[case, dtype]["rank0"], runs[case, dtype]["jax"]
    metrics, grads, norms, params = jax_steps[0]
    assert set(_by_prefix(r0, "m0/")) == set(metrics)
    for k, want in metrics.items():
        np.testing.assert_allclose(r0[f"m0/{k}"], want, rtol=JAX_LOSS_RTOL, err_msg=k)
    if (case, dtype) == ("basis-melgan", "float32"):
        return
    x64 = dtype == "float64"
    tol = 1e-6 if x64 else JAX_GRAD_TOL.get(case, 3e-3)
    for who, want in grads.items():
        worst, where = _worst(_by_prefix(r0, f"g0/{who}/"), want)
        assert worst <= tol, f"{who} {where}: {worst:.2e} of its peak against JAX"
        np.testing.assert_allclose(r0[f"n0/{who}"], norms[who],
                                   rtol=1e-6 if x64 else 1e-2 if case == "melgan" else 1e-3)
        lr = jhp.HP.learning_rate if who == "generator" else jhp.HP.learning_rate_discriminator
        scale = min(1.0, 1.0 / norms[who])
        prefix = "gen." if who == "generator" else "disc."
        checked = 0
        for k, w in params[who].items():
            if k.startswith("basis_signal."):
                continue
            keep = np.abs(want[k] * scale) >= SMALL_GRAD
            err = np.abs(r0[f"p0/{prefix}{k}"] - w)[keep]
            checked += int(keep.sum())
            assert err.size == 0 or err.max() <= STEP_TOL * lr, f"{who} {k}: {err.max():.3e}"
        assert checked > 100


def test_basis_is_frozen_and_counted_in_the_clip_norm(runs):
    r0 = runs["basis-melgan", "float32"]["rank0"]
    basis_grad = r0["g0/generator/basis_signal.basis"]
    grads = _by_prefix(r0, "g0/generator/")
    norm = float(r0["n0/generator"])
    np.testing.assert_allclose(np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2))
                                           for g in grads.values())), norm, rtol=1e-5)
    without = np.sqrt(norm ** 2 - float(np.sum(basis_grad.astype(np.float64) ** 2)))
    assert np.abs(basis_grad).max() > 0 and without < norm * (1 - 1e-6)
    for s in range(N_STEPS):  # no optimiser holds it
        np.testing.assert_array_equal(r0[f"p{s}/gen.basis_signal.basis"],
                                      runs["basis-melgan", "float32"]["init_basis"])


def test_a_rank_draws_the_global_noise_and_takes_its_rows():
    """NHV under data parallelism: each rank's noise is its rows of the
    global batch's draw of the step, so that two ranks equal one process."""
    cfg = model_config(thp, "nhv")
    noise = seeded_noise(5, torch.device("cpu"))
    mel = torch.zeros(2, FIXED, 81)
    want = noise(3, (4, FIXED * 240))
    for rank in range(2):
        tr = make_trainer(cfg, device="cpu", seed=5, dp=DataParallel(rank, 2))
        state = tr.init_state(0)
        state.step = 3
        torch.testing.assert_close(tr._step_noise(state, mel), want[2 * rank: 2 * rank + 2],
                                   rtol=0, atol=0)


def test_dp_reduces_through_one_all_reduce_a_network(monkeypatch):
    """One collective a network an update: the generator's gradients (the
    frozen basis's included) in one flattened buffer, not one a parameter."""
    import torch.distributed as dist

    calls = []
    monkeypatch.setattr(dist, "all_reduce", lambda t, group=None: calls.append(t.numel()))
    dp = DataParallel(0, 2)
    grads = [torch.ones(3, 4), torch.ones(5), torch.ones(2, 2, 2)]
    out = dp.all_reduce_mean(grads)
    assert calls == [25]
    assert [tuple(o.shape) for o in out] == [(3, 4), (5,), (2, 2, 2)]
    torch.testing.assert_close(out[0], torch.full((3, 4), 0.5))


@pytest.fixture
def buffer():
    rng = np.random.default_rng(0)
    return [{"mel": rng.standard_normal((12 + i, 80)).astype(np.float32),
             "wav": rng.standard_normal(((12 + i) * 240,)).astype(np.float32)}
            for i in range(11)]


def test_batch_iterator_shards_as_jax(buffer):
    """Each shard takes its contiguous slice of the common shuffled epoch:
    the same crops as the JAX package's `batch_iterator`, bit for bit."""
    from fastvocoder_tpu.data.dataset import BufferDataset as JaxBufferDataset
    from fastvocoder_tpu.data.dataset import batch_iterator as jax_batch_iterator
    from fastvocoder_tpu.data.dataset import num_batches_per_epoch as jax_num_batches

    hp = thp.HP.replace(fixed_length=10, batch_size=2, batch_expand_size=2)
    jhp_ = jhp.HP.replace(fixed_length=10, batch_size=2, batch_expand_size=2)
    for shard in range(2):
        got = list(batch_iterator(BufferDataset(buffer, hp), hp, seed=3, epoch=1,
                                  shard_index=shard, shard_count=2, batch_size=1))
        want = list(jax_batch_iterator(JaxBufferDataset(buffer, jhp_), jhp_, seed=3, epoch=1,
                                       shard_index=shard, shard_count=2, batch_size=1))
        assert len(got) == len(want) == num_batches_per_epoch(11, hp, 2, 1) == jax_num_batches(
            11, jhp_, 2, 1) == 4
        for g, w in zip(got, want):
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    a, b = (next(batch_iterator(BufferDataset(buffer, hp), hp, seed=3, shard_index=i,
                                shard_count=2, batch_size=1)) for i in range(2))
    assert not np.array_equal(a["wav"], b["wav"])


def test_device_corpus_shards_as_jax(buffer):
    from fastvocoder_tpu.data.dataset import BufferDataset as JaxBufferDataset
    from fastvocoder_tpu.data.device_cache import DeviceCorpus as JaxDeviceCorpus

    hp = thp.HP.replace(fixed_length=10, batch_size=2, batch_expand_size=2, epochs=2)
    jhp_ = jhp.HP.replace(fixed_length=10, batch_size=2, batch_expand_size=2, epochs=2)
    tcorpus = DeviceCorpus(BufferDataset(buffer, hp), hp=hp, device="cpu", log=lambda m: None)
    jcorpus = JaxDeviceCorpus(JaxBufferDataset(buffer, jhp_), hp=jhp_, log=lambda m: None)
    for shard in range(2):
        got = list(tcorpus.batches(seed=7, batch_size=1, shard_index=shard, shard_count=2))
        want = list(jcorpus.batches(seed=7, batch_size=1, shard_index=shard, shard_count=2))
        assert len(got) == len(want) == 2 * tcorpus.steps_per_epoch(1, 2) == 8
        for g, w in zip(got, want):
            for k in w:
                np.testing.assert_array_equal(g[k].numpy(), np.asarray(jax.device_get(w[k])),
                                              err_msg=k)


def _train(corpus, work, steps, env_by_rank=None, **kw):  # noqa: F811
    run_dir = work / "run"
    argv = _argv(corpus, "hifigan", run_dir, max_steps=steps, batch_size=2, save_step=2,
                 valid_step=2, stall_exit_s=0, **kw)
    (work / "argv.json").write_text(json.dumps(argv))
    spawn("train", str(work), env_by_rank)
    return run_dir, [json.loads((work / f"train.rank{r}.json").read_text()) for r in range(WORLD)]


def test_run_train_rank_zero_writes_and_both_log_global_metrics(corpus, tmp_path):  # noqa: F811
    run_dir, ranks = _train(corpus, tmp_path, 3)
    assert [r["step"] for r in ranks] == [3, 3]
    assert ranks[0]["history"] == ranks[1]["history"]  # the global batch's, on both
    assert [s for s, _ in ranks[0]["history"]] == [1, 2, 3]
    (ckpt_dir,) = os.listdir(run_dir / "checkpoint")
    assert sorted(os.listdir(run_dir / "checkpoint" / ckpt_dir)) == [
        "checkpoint_2.pth.tar", "checkpoint_3.pth.tar"]
    (log_dir,) = os.listdir(run_dir / "logger")
    lines = (run_dir / "logger" / log_dir / "total_loss.txt").read_text().splitlines()
    assert [float(x) for x in lines] == pytest.approx(
        [m["total_loss"] for _, m in ranks[0]["history"]], rel=1e-6)


@pytest.mark.parametrize("ahead", [0, 1])
def test_deadline_is_rank_zeros_clock(corpus, tmp_path, ahead):  # noqa: F811
    """One rank's clock runs an hour ahead, past the deadline, the other's
    not: rank 0's decides, so both stop at step 1 (rank 0 ahead) or both
    run on to `max_steps` (rank 1 ahead); a rank that stopped alone would
    leave the other in the next step's all-reduce, and the run would hang
    past `spawn`'s timeout."""
    import time

    env = {r: {"TRAIN_DEADLINE_EPOCH": str(time.time() + 1800)} for r in range(WORLD)}
    env[ahead]["CLOCK_AHEAD_S"] = "3600"
    _, ranks = _train(corpus, tmp_path, 3, env)
    want = 1 if ahead == 0 else 3
    assert [r["step"] for r in ranks] == [want, want]
