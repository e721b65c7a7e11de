"""The training entry point's runtime on the CPU (`fastvocoder_tpu_torch/bin/train.py`):
the input paths (`--device_cache`), `--remat`, `--fused_train`,
`--restore_step`, the stall watchdog (`--stall_exit_s`), the wall-clock
deadline (`TRAIN_DEADLINE_EPOCH`), TensorBoard, the asynchronous
checkpoint writer, the weight target's precision, and the checkpoint files
`run_train` reads: the earlier `train/1` payloads and, refused by name, a
file that names a foreign global.

The watchdog and deadline cases mirror `tests/test_stall_watchdog.py` and
`tests/test_train_driver.py`'s; the runs use the corpus and tiny
configurations of `tests/test_torch_train_driver.py`.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch
from test_torch_train_driver import _argv, _only_dir, corpus, one_torch_thread  # noqa: F401

from fastvocoder_tpu_torch.bin import train as train_mod
from fastvocoder_tpu_torch.bin.train import _start_stall_watchdog, run_train
from fastvocoder_tpu_torch.checkpoint import TRAIN_FORMAT, checkpoint_format
from fastvocoder_tpu_torch.hparams import TINY_DISC
from fastvocoder_tpu_torch.train import trainer as ttrainer
from fastvocoder_tpu_torch.train.checkpoint import (
    AsyncCheckpointWriter,
    latest_checkpoint,
    load_checkpoint,
)


class _Stop(Exception):
    pass


@pytest.fixture
def quiet_thread_excepthook(monkeypatch):
    """The watchdog cases stop its thread by raising _Stop from the injected
    sleep and exit; keep those exits out of stderr."""
    orig = threading.excepthook
    monkeypatch.setattr(threading, "excepthook",
                        lambda args: None if issubclass(args.exc_type, _Stop) else orig(args))


def _drive(heartbeat, stall_exit_s, tmp_path, ticks=4, tick=None):
    """The watchdog with injected sleep and exit; `tick(i)` may move the
    heartbeat each iteration.  -> the exit code it asked for, or None."""
    n, exited = [0], []

    def fake_sleep(_):
        if tick:
            tick(n[0])
        n[0] += 1
        if n[0] > ticks:
            raise _Stop

    def fake_exit(code):
        exited.append(code)
        raise _Stop

    th = _start_stall_watchdog(heartbeat, stall_exit_s, str(tmp_path), exit_fn=fake_exit,
                               sleep_fn=fake_sleep)
    th.join(timeout=10)
    assert not th.is_alive()
    return exited[0] if exited else None


def test_watchdog_fires_on_a_stalled_heartbeat(tmp_path, quiet_thread_excepthook):
    assert _drive([time.monotonic() - 100.0], 10.0, tmp_path) == 17
    assert "stall watchdog" in (tmp_path / "logger.txt").read_text()


def test_watchdog_holds_while_the_heartbeat_advances(tmp_path, quiet_thread_excepthook):
    hb = [time.monotonic()]
    assert _drive(hb, 10.0, tmp_path, ticks=5,
                  tick=lambda _: hb.__setitem__(0, time.monotonic())) is None


def test_watchdog_holds_inside_its_grace(tmp_path, quiet_thread_excepthook):
    assert _drive([time.monotonic() - 5.0], 10.0, tmp_path) is None


def test_watchdog_ends_when_the_run_does(tmp_path):
    """`stop` (set as `run` returns) ends the thread: a finished run's
    watchdog never exits the process that called it."""
    stop = threading.Event()
    exited = []
    th = _start_stall_watchdog([time.monotonic() - 100.0], 10.0, str(tmp_path),
                               exit_fn=exited.append, sleep_fn=lambda _: stop.set(), stop=stop)
    th.join(timeout=10)
    assert not th.is_alive() and exited == []


def test_stall_exit_s_defaults_to_900():
    args = train_mod.build_parser().parse_args(["--model_name", "hifigan", "--config", "x"])
    assert (args.stall_exit_s, args.device_cache, args.fused_train, args.remat,
            args.restore_step) == (900, -1, -1, 0, 0)


@pytest.mark.parametrize("var", ["TRAIN_DEADLINE_EPOCH", "DEADLINE_EPOCH"])
def test_wall_deadline_stops_at_the_first_step_boundary_with_a_tail_checkpoint(
        corpus, monkeypatch, var):
    monkeypatch.delenv("TRAIN_DEADLINE_EPOCH", raising=False)
    monkeypatch.setenv(var, str(time.time() - 10))
    run_dir = corpus / f"deadline_{var}"
    state = run_train(_argv(corpus, "hifigan", run_dir, max_steps=6), disc_cfg=TINY_DISC)
    assert state.step == 1  # one step, then the check at its boundary
    assert os.listdir(_only_dir(run_dir / "checkpoint")) == ["checkpoint_1.pth.tar"]


def test_a_malformed_deadline_is_ignored(corpus, monkeypatch, caplog):
    monkeypatch.setenv("TRAIN_DEADLINE_EPOCH", "not-a-number")
    with caplog.at_level("WARNING"):
        state = run_train(_argv(corpus, "hifigan", corpus / "bad_deadline", max_steps=2),
                          disc_cfg=TINY_DISC)
    assert state.step == 2
    assert "ignoring malformed TRAIN_DEADLINE_EPOCH" in caplog.text


def test_restore_step_takes_precedence_over_the_checkpoint(corpus):
    """As the JAX script: `--restore_step` over the checkpoint's own step;
    the run goes on from it with the batches the unbroken run has there."""
    first = corpus / "first"
    run_train(_argv(corpus, "hifigan", first, max_steps=2), disc_cfg=TINY_DISC)
    resumed = run_train(_argv(corpus, "hifigan", corpus / "second", max_steps=5,
                              checkpoint_path=first / "checkpoint", restore_step=3),
                        disc_cfg=TINY_DISC)
    assert [s for s, _ in resumed.history] == [4, 5]
    assert (resumed.gen_updates, resumed.disc_updates) == (4, 2)  # the file's counts, on
    fresh = run_train(_argv(corpus, "hifigan", corpus / "third", max_steps=4, restore_step=3),
                      disc_cfg=TINY_DISC)
    assert [s for s, _ in fresh.history] == [4]  # no checkpoint: from step 3, fresh weights
    assert (fresh.gen_updates, fresh.disc_updates) == (1, 1)


@pytest.mark.parametrize("cache", [0, 1])
def test_the_weight_target_reaches_the_trainer_as_sent(corpus, monkeypatch, cache):
    """The host path sends Basis-MelGAN's weight target as float16 (the JAX
    script's host path), the device path stores it in bf16 (its device
    cache): the trainer receives values of that type, the float32 target
    rounded once."""
    seen = []
    pre_adv = ttrainer.Trainer.pre_adv_step

    def spy(self, state, mel, wav, weight=None):
        seen.append(weight)
        return pre_adv(self, state, mel, wav, weight)

    monkeypatch.setattr(ttrainer.Trainer, "pre_adv_step", spy)
    state = run_train(_argv(corpus, "basis-melgan", corpus / f"w{cache}", max_steps=2,
                            device_cache=cache), disc_cfg=TINY_DISC)
    assert len(seen) == 2 and "weight_loss" in dict(state.history)[2]
    want = torch.float16 if cache == 0 else torch.bfloat16
    for w in seen:
        assert w.dtype == want and tuple(w.shape) == (2, 160, 16)
        assert torch.equal(w.float().to(want).float(), w.float())
        assert w.float().abs().max() > 0


@pytest.mark.parametrize("flags", [
    {"device_cache": 0}, {"device_cache": 1}, {"remat": 1}, {"fused_train": 1},
    {"fused_train": -1, "remat": 1, "device_cache": 1, "mixprecision": 1},
], ids=["host_prefetch", "device_cache", "remat", "fused_train", "all_in_bf16"])
def test_run_train_with_the_runtime_flags(corpus, flags, caplog):
    """Each runs 5 steps across the discriminator boundary, logs its input
    path, writes TensorBoard events, the scalars' JSON and an `eta`."""
    run_dir = corpus / ("run_" + "_".join(f"{k}{v}" for k, v in flags.items()))
    with caplog.at_level("INFO"):
        state = run_train(_argv(corpus, "hifigan", run_dir, max_steps=5, **flags),
                          disc_cfg=TINY_DISC)
    assert state.step == 5 and [s for s, _ in state.history] == [1, 2, 3, 4, 5]
    assert all(np.isfinite(v) for _, m in state.history for v in m.values())
    path = "device" if flags.get("device_cache", -1) else "host"
    assert {"device": "the corpus on the device", "host": "prefetched"}[path] in caplog.text
    logdir = _only_dir(run_dir / "logger")
    assert " eta=" in (logdir / "logger.txt").read_text()
    assert "total_loss" in json.loads((logdir / "all_scalars.json").read_text())
    assert any(f.startswith("events.") for f in os.listdir(_only_dir(run_dir / "tensorboard")))


def test_device_cache_auto_takes_the_jax_rule(corpus, caplog):
    with caplog.at_level("INFO"):
        run_train(_argv(corpus, "hifigan", corpus / "auto", max_steps=1), disc_cfg=TINY_DISC)
    assert "within the 6 GB rule: the device path" in caplog.text


@pytest.mark.parametrize("flags", [{"device_cache": 1}, {"device_cache": 0}, {"remat": 1},
                                   {"fused_train": 1}, {"fused_train": 0}, {"restore_step": 2}])
def test_the_runtime_flags_need_a_card_unless_told_the_cpu(corpus, flags):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    argv = [a for a in _argv(corpus, "hifigan", corpus / "run_c", max_steps=1, **flags)
            if not a.startswith("--device=")]
    with pytest.raises(RuntimeError, match="--device cpu"):
        run_train(argv, disc_cfg=TINY_DISC)


def test_the_async_writer_reraises_a_failure(tmp_path):
    from fastvocoder_tpu_torch import hparams as thp

    cfg = thp.ModelConfig("hifigan", thp.HiFiGANConfig(
        resblock_kernel_sizes=(3,), upsample_rates=(8, 5, 3, 2), upsample_initial_channel=16,
        upsample_kernel_sizes=(16, 10, 6, 4), resblock_dilation_sizes=((1,),)))
    state = ttrainer.make_trainer(cfg, disc_cfg=TINY_DISC, device="cpu").init_state(0)
    w = AsyncCheckpointWriter()
    w.submit(str(tmp_path / "fine.pth.tar"), state, "hifigan")
    w.submit(str(tmp_path / "no_such_dir" / "x.pth.tar"), state, "hifigan")
    with pytest.raises(RuntimeError, match="no_such_dir does not exist"):
        w.wait()
    assert checkpoint_format(str(tmp_path / "fine.pth.tar")) == "reference"


def test_the_async_writer_snapshots_before_the_next_step(corpus):
    """A save submitted before a step holds the state before it, though the
    step updates the parameters and Adam in place while the worker writes."""
    from fastvocoder_tpu_torch import hparams as thp

    cfg = thp.load_model_config("hifigan", str(corpus / "hifigan.yaml"))
    trainer = ttrainer.make_trainer(cfg, hp=thp.HP.replace(fixed_length=10), disc_cfg=TINY_DISC,
                                    device="cpu")
    state = trainer.init_state(0)
    rng = np.random.default_rng(0)
    mel = torch.from_numpy(rng.standard_normal((2, 10, 80)).astype(np.float32))
    wav = torch.from_numpy((0.1 * rng.standard_normal((2, 2400))).astype(np.float32))
    trainer.gan_step(state, mel, wav)
    want = {k: v.clone() for k, v in state.generator.state_dict().items()}
    w = AsyncCheckpointWriter()
    path = str(corpus / "snap.pth.tar")
    w.submit(path, state, "hifigan")
    for _ in range(2):
        trainer.gan_step(state, mel, wav)
    w.wait()
    back = trainer.init_state(1)
    load_checkpoint(path, back, "hifigan")
    assert back.step == 1
    for k, v in back.generator.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)


def test_a_train1_payload_still_loads(corpus):
    """A checkpoint in the `train/1` format of the port's earlier trainer
    (modules' and optimisers' state_dicts) resumes: the next step is the
    step the saved state takes."""
    from fastvocoder_tpu_torch import hparams as thp

    cfg = thp.load_model_config("hifigan", str(corpus / "hifigan.yaml"))
    trainer = ttrainer.make_trainer(cfg, hp=thp.HP.replace(fixed_length=10), disc_cfg=TINY_DISC,
                                    device="cpu")
    state = trainer.init_state(0)
    rng = np.random.default_rng(0)
    mel = torch.from_numpy(rng.standard_normal((2, 10, 80)).astype(np.float32))
    wav = torch.from_numpy((0.1 * rng.standard_normal((2, 2400))).astype(np.float32))
    trainer.gan_step(state, mel, wav)
    path = str(corpus / "checkpoint_1.pth.tar")
    torch.save({"format": TRAIN_FORMAT, "model_name": "hifigan", "step": state.step,
                "gen_updates": state.gen_updates, "disc_updates": state.disc_updates,
                "generator": state.generator.state_dict(),
                "discriminator": state.discriminator.state_dict(),
                "optimizer": state.gen_opt.state_dict(),
                "discriminator_optimizer": state.disc_opt.state_dict()}, path)
    assert checkpoint_format(path) == "train"
    back = trainer.init_state(1)
    load_checkpoint(path, back, "hifigan")
    assert (back.step, back.gen_updates, back.disc_updates) == (1, 1, 1)
    trainer.gan_step(state, mel, wav)
    trainer.gan_step(back, mel, wav)
    for v, w in zip(state.generator.parameters(), back.generator.parameters()):
        torch.testing.assert_close(w, v, rtol=0, atol=0)
    with pytest.raises(ValueError, match="not 'basis-melgan'"):
        load_checkpoint(path, back, "basis-melgan")


def test_the_restricted_unpickler_refuses_a_foreign_global_by_name(tmp_path):
    """A training checkpoint is read without JAX or optax by an unpickler
    that knows tensors, numpy arrays and optax's state records: another
    global is refused, by name, before it is imported or called."""
    import collections

    path = str(tmp_path / "checkpoint_1.pth.tar")
    torch.save({"model": {}, "step": 1, "extra": collections.Counter("ab")}, path)
    with pytest.raises(ValueError, match="refused global collections.Counter"):
        checkpoint_format(path)
    torch.save({"model": {}, "step": 1, "call": os.getcwd}, path)
    with pytest.raises(ValueError, match="refused global posix.getcwd"):
        load_checkpoint(path, None, "hifigan")


def test_a_trained_run_resumes_from_its_reference_layout_checkpoint(corpus):
    """`run_train`'s checkpoints are in the reference layout; `latest_checkpoint`
    finds the tail, and resuming from the run directory continues the
    unbroken run bit for bit (device path, the default here)."""
    whole = run_train(_argv(corpus, "hifigan", corpus / "whole", max_steps=4), disc_cfg=TINY_DISC)
    cut = corpus / "cut"
    run_train(_argv(corpus, "hifigan", cut, max_steps=3), disc_cfg=TINY_DISC)
    assert checkpoint_format(latest_checkpoint(str(cut))) == "reference"
    resumed = run_train(_argv(corpus, "hifigan", cut, max_steps=4, checkpoint_path=cut),
                        disc_cfg=TINY_DISC)
    assert [s for s, _ in resumed.history] == [4]
    assert resumed.history[0][1] == dict(whole.history)[4]
    for (k, v), w in zip(whole.generator.state_dict().items(),
                         resumed.generator.state_dict().values()):
        torch.testing.assert_close(w, v, rtol=0, atol=0, msg=k)
