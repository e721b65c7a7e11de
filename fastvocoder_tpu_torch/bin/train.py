"""Training entry point: `run_train(argv)`.

Counterpart of `fastvocoder_tpu/bin/train.py` (reference
bin/train.py:258-499).  Per step the host picks
`pre_adv_step` or `gan_step` at the `discriminator_train_start_steps`
boundary, as the JAX package's `bin/train.py` does.  It keeps that script's
artifacts:
per-step `total_loss.txt` / `stft_loss.txt` appends, a `logger.txt` line
every `log_step` (with the run's `eta`), TensorBoard scalars under
`hp.tensorboard_path` mirrored into `all_scalars.json` on exit,
`checkpoint_<step>.pth.tar` every `save_step` (and at `max_steps`) in the
reference's layout (`train/checkpoint.py`), written on a worker thread,
and the `valid_step` sweep over full utterances in index order.  A run
directory as `--checkpoint_path` resumes from its newest checkpoint (the
JAX package's too, its Adam states included) and goes on with the batches
the unbroken run would have seen; `--restore_step` takes precedence over
the checkpoint's step, as in the JAX script.

Input: with `--device_cache 1` the whole corpus is staged on the device
and crops are cut there (`data/device_cache.py`); with 0 the host cuts
them and `runtime.prefetch_to_device` copies batch k+1 on a side stream
while step k runs; -1, the default, takes the JAX script's rule (the
device path when the padded corpus is at most 6e9 bytes; one process
always).  The host path sends Basis-MelGAN's weight target as float16, as
the JAX script does; the device path stores it in bf16.

The run is on the CUDA device unless `--device cpu` is passed; with neither
it raises.  Metrics stay on the device between log points, so steps queue
without a host sync.  `--use_mpd 1` adds the multi-period discriminator
(`-1`, the default, takes the YAML's `use_mpd` key).  NHV reads each
utterance's `<name>.f0.npy` beside its `<name>.mel.npy` (training and
validation) and conditions on the mel and f0.  `--mixprecision 1` trains
in bf16 as the JAX script does (`make_trainer(compute_dtype=
torch.bfloat16)`: float32 parameters, optimiser state and losses, bf16
convs and kernels); `--remat 1` recomputes the generator forward in the
backward (`make_trainer(remat=True)`).  `--stall_exit_s` (default 900, 0
off) arms a watchdog that exits the process with code 17 when no step has
completed for that long; `TRAIN_DEADLINE_EPOCH` (else `DEADLINE_EPOCH`), a
Unix time, stops the run at the first step boundary past it with a tail
checkpoint.  `--fused_train` -1 or 1 trains through the kernels, the
port's path on the card; 0 runs the generator's residual-stack and MRF
stages as the modules' library convs instead (`make_trainer(fused_train=
False)`: cuDNN on the card, in every pass of a step; Basis-MelGAN's decode
keeps its kernel), as the JAX script's 0 runs them as XLA convs.  A float32
run computes its cuDNN convs under the caller's
`torch.backends.cudnn.allow_tf32`, True unless changed (PyTorch's default:
TF32 convs); this script leaves it as it is and logs it.

Data parallelism: started by `torchrun --nproc_per_node N -m
fastvocoder_tpu_torch.bin.train ...` (or any launcher that sets RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT), each process trains
on its own card (`cuda:LOCAL_RANK`; NCCL, or gloo with `--device cpu`) on
`batch_size / N` rows of each global batch, its slice of the common
shuffled epoch; the JAX script runs one process a host over all of its
chips instead.  Rank 0 broadcasts its state after initialisation or a
resume, every update averages the ranks' gradients, and the logged metrics
are the global batch's.  Rank 0 alone writes checkpoints, `logger.txt`, the
loss files and TensorBoard, validates and runs the stall watchdog; rank 0's
clock decides the deadline, broadcast at each step boundary, so that every
rank stops at the same step.  `--device_cache -1` takes the device path
only in one process, as the JAX script does; with 1 each rank holds its own
copy of the corpus.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import threading
import time
from datetime import datetime

import numpy as np
import torch

from fastvocoder_tpu_torch.data.dataset import (
    BufferDataset,
    WeightDataset,
    batch_iterator,
    load_data_to_buffer,
    num_batches_per_epoch,
    to_device,
)
from fastvocoder_tpu_torch.data.device_cache import DeviceCorpus
from fastvocoder_tpu_torch.hparams import DISC, HP, DiscriminatorConfig, load_model_config
from fastvocoder_tpu_torch.parallel import (
    DataParallel,
    maybe_initialize_distributed,
    rank_device,
    reduce_metrics,
    replicate_state,
)
from fastvocoder_tpu_torch.runtime import StepTimer, prefetch_to_device
from fastvocoder_tpu_torch.train.checkpoint import (
    AsyncCheckpointWriter,
    latest_checkpoint,
    load_checkpoint,
)
from fastvocoder_tpu_torch.train.trainer import make_trainer

logger = logging.getLogger(__name__)

DEVICE_CACHE_MAX_BYTES = 6e9  # the JAX script's auto rule (sized for a 16 GB TPU)
STALL_EXIT_CODE = 17


class _NoopWriter:
    def add_scalar(self, *a, **k):
        pass

    def close(self):
        pass


class _ScalarJsonWriter:
    """A TensorBoard writer whose scalars are also dumped to a JSON file on
    close: the reference's tensorboardX `export_scalars_to_json`
    (reference bin/train.py:473), which torch's SummaryWriter dropped."""

    def __init__(self, writer, json_path: str):
        self._w = writer
        self._path = json_path
        self.scalars: dict = {}

    def add_scalar(self, tag, value, global_step=None):
        self._w.add_scalar(tag, value, global_step=global_step)
        self.scalars.setdefault(tag, []).append([global_step, float(value)])

    def close(self):
        with open(self._path, "w") as f:
            json.dump(self.scalars, f)
        self._w.close()


def _make_writer(logdir: str):
    try:
        from torch.utils.tensorboard import SummaryWriter

        return SummaryWriter(logdir)
    except Exception:  # tensorboard is not installed
        logger.warning("tensorboard unavailable; TensorBoard scalars are not written "
                       "(all_scalars.json still is)")
        return _NoopWriter()


def _start_stall_watchdog(heartbeat, stall_exit_s, logger_path, exit_fn=os._exit,
                          sleep_fn=time.sleep, stop: threading.Event = None):
    """A daemon thread that turns "no completed train-loop iteration for
    `stall_exit_s` seconds" into `exit_fn(17)`, so that a supervisor
    relaunches the run from its newest checkpoint (the JAX script's
    failure detection, SURVEY.md section 5: a hung device call never
    returns, and a supervisor sees only dead processes).  The line goes to
    the log and to the run's `logger.txt`.  `heartbeat` is a one-element
    list holding the `time.monotonic()` of the last completed iteration;
    `stop` (set when the run returns) ends the thread."""
    stop = stop if stop is not None else threading.Event()

    def watch():
        while not stop.is_set():
            sleep_fn(min(30.0, stall_exit_s / 4))
            idle = time.monotonic() - heartbeat[0]
            if idle > stall_exit_s and not stop.is_set():
                msg = (f"stall watchdog: no training progress for {idle:.0f}s "
                       f"(> --stall_exit_s={stall_exit_s}); exiting for a resume from the "
                       f"last checkpoint")
                logger.error(msg)
                try:
                    with open(os.path.join(logger_path, "logger.txt"), "a") as f:
                        f.write(msg + "\n")
                except OSError:
                    pass
                exit_fn(STALL_EXIT_CODE)
                return  # reached only with an injected exit_fn

    t = threading.Thread(target=watch, daemon=True, name="stall_watchdog")
    t.start()
    return t


def wall_deadline() -> float:
    """`TRAIN_DEADLINE_EPOCH`, else `DEADLINE_EPOCH` (a Unix time; 0 or unset:
    none).  A malformed value is logged and ignored: the run goes on."""
    raw = os.environ.get("TRAIN_DEADLINE_EPOCH", os.environ.get("DEADLINE_EPOCH", "0"))
    try:
        return float(raw or 0)
    except ValueError:
        logger.warning("ignoring malformed TRAIN_DEADLINE_EPOCH/DEADLINE_EPOCH value "
                       f"{raw!r}; running without a wall-clock deadline")
        return 0.0


def corpus_bytes(dataset, hp, L=None, weight_channels: int = 0) -> int:
    """The JAX script's estimate of the padded corpus on the device
    (bin/train.py:519-529): items x longest utterance x (81 float32 mel
    rows, `hop_size` float32 samples, and a weight target's bf16 rows)."""
    max_f = max((dataset.mel_length(i) for i in range(len(dataset))), default=0)
    per_frame = 81 * 4 + hp.hop_size * 4
    if L is not None:
        per_frame += (hp.hop_size // (L // 2)) * weight_channels * 2
    return len(dataset) * max_f * per_frame


def run(args, disc_cfg: DiscriminatorConfig = DISC):
    """Train as `args` (the namespace `run_train` parses) says; -> the final
    `TrainState`, with the logged metrics of every step in
    `state.history`."""
    rank, world = maybe_initialize_distributed(args.device or "cuda")
    dp = DataParallel.current()
    is_main = rank == 0
    device = args.device or None
    if dp is not None:
        device = rank_device(args.device or "cuda")
        if args.batch_size % world:
            raise ValueError(f"batch_size {args.batch_size} must divide over {world} ranks")
        logger.info(f"data parallel: rank {rank} of {world} over {dp.backend} on {device}, "
                    f"{args.batch_size // world} rows of each batch of {args.batch_size}")
    per_rank_bs = args.batch_size // world
    cfg = load_model_config(args.model_name, args.config)
    if args.use_mpd >= 0:  # the command line over the YAML's key
        cfg = dataclasses.replace(cfg, use_mpd=bool(args.use_mpd))
    hp = HP.replace(
        use_feature_map_loss=cfg.use_feature_map_loss,
        batch_size=args.batch_size,
        batch_expand_size=args.batch_expand_size,
        fixed_length=args.fixed_length,
        save_step=args.save_step,
        valid_step=args.valid_step,
        valid_num=args.valid_num,
        discriminator_train_start_steps=args.discriminator_train_start_steps,
        test_size=args.test_size,
    )
    if args.run_dir:
        # a self-contained run directory: checkpoints, logs and TensorBoard under it
        hp = hp.replace(checkpoint_path=os.path.join(args.run_dir, "checkpoint"),
                        logger_path=os.path.join(args.run_dir, "logger"),
                        tensorboard_path=os.path.join(args.run_dir, "tensorboard"))

    logger.info(f"Loading Model of {args.model_name}...")
    is_basis = args.model_name == "basis-melgan"
    basis_signal_weight = None
    if is_basis:
        basis_signal_weight = np.load(
            os.path.join(args.basis_dataset_path, "basis_signal_weight.npy")).astype(np.float32)
    compute_dtype = None
    if args.mixprecision:
        logger.info("Start bf16 mixed precision training...")
        compute_dtype = torch.bfloat16
    fused_train = args.fused_train != 0
    if not fused_train:
        logger.info("--fused_train 0: the generator's stages run as the modules' library convs "
                    f"(cuDNN TF32 {'on' if torch.backends.cudnn.allow_tf32 else 'off'})")
    trainer = make_trainer(
        cfg, hp=hp, basis_signal_weight=basis_signal_weight,
        use_scheduler=bool(args.use_scheduler), learning_rate=args.learning_rate,
        learning_rate_discriminator=args.learning_rate_discriminator,
        disc_cfg=disc_cfg, device=device, seed=args.seed,
        compute_dtype=compute_dtype, remat=bool(args.remat), dp=dp, fused_train=fused_train,
    )
    device = trainer.device
    state = trainer.init_state(args.seed)

    ckpt_path = args.checkpoint_path
    if ckpt_path and os.path.isdir(ckpt_path):
        latest = latest_checkpoint(ckpt_path)
        if latest:
            logger.info(f"auto-resuming from {latest}")
        else:
            logger.warning(f"no checkpoints under {ckpt_path}")
        ckpt_path = latest or ""
    if ckpt_path:
        load_checkpoint(ckpt_path, state, args.model_name)
    if args.restore_step:  # over the checkpoint's own step, as in the JAX script
        state.step = args.restore_step
    if ckpt_path:
        logger.info(f"\n---Model Restored at Step {state.step}---\n")
    else:
        logger.info("\n---Start New Training---\n")
    replicate_state(state, dp)

    stamp = str(datetime.now()).replace(" ", "-").replace(":", "-").replace(".", "-")
    current_checkpoint_path = os.path.join(hp.checkpoint_path, stamp)
    current_logger_path = os.path.join(hp.logger_path, stamp)
    if is_main:
        os.makedirs(current_checkpoint_path, exist_ok=True)
        os.makedirs(current_logger_path, exist_ok=True)

    if is_basis:
        weight_dir = os.path.join(args.basis_dataset_path, "weight")
        dataset = WeightDataset.from_index_files(
            args.audio_index_path, args.mel_index_path, cfg.arch.L, weight_dir=weight_dir,
            hp=hp, test_size=hp.test_size)
        valid_dataset = WeightDataset.from_index_files(
            args.audio_index_valid_path, args.mel_index_valid_path, cfg.arch.L,
            weight_dir=weight_dir, hp=hp, test_size=hp.test_size)
    else:
        with_f0 = args.model_name == "nhv"  # NHV's f0 conditioning
        dataset = BufferDataset(load_data_to_buffer(
            args.audio_index_path, args.mel_index_path, test_size=hp.test_size,
            log=logger.info, with_f0=with_f0), hp)
        valid_dataset = BufferDataset(load_data_to_buffer(
            args.audio_index_valid_path, args.mel_index_valid_path, test_size=hp.test_size,
            log=logger.info, with_f0=with_f0), hp)

    steps_per_epoch = num_batches_per_epoch(len(dataset), hp, shard_count=world,
                                            batch_size=per_rank_bs)
    total_step = hp.epochs * steps_per_epoch
    logger.info(f"{steps_per_epoch} steps per epoch")
    if steps_per_epoch == 0:
        raise SystemExit(
            f"0 steps per epoch: {len(dataset)} items over {world} rank(s) cannot fill one "
            f"mega-batch of batch_size*batch_expand_size = {per_rank_bs}*"
            f"{hp.batch_expand_size} a rank; lower --batch_size/--batch_expand_size or add data"
        )
    L = cfg.arch.L if is_basis else None
    start_step = state.step
    history = []   # (step, {name: float}) of every step, drained at log points
    pending = []   # (step, metrics on the device)

    def drain_metrics():
        """The pending steps' metrics, the global batch's under data
        parallelism (one all-reduce; every rank drains at the same steps),
        appended to the loss files by rank 0."""
        if not pending:
            return []
        drained = [(s, {k: float(v) for k, v in m.items()})
                   for (s, _), m in zip(pending, reduce_metrics([m for _, m in pending], dp))]
        pending.clear()
        history.extend(drained)
        if not is_main:
            return drained
        with open(os.path.join(current_logger_path, "total_loss.txt"), "a") as ft, \
                open(os.path.join(current_logger_path, "stft_loss.txt"), "a") as fs:
            for _, m in drained:
                ft.write(f"{m['total_loss']}\n")
                fs.write(f"{m['stft_loss']}\n")
        return drained

    def save(step, what="checkpoint"):
        path = os.path.join(current_checkpoint_path, f"checkpoint_{step}.pth.tar")
        ckpt_writer.submit(path, state, args.model_name)  # snapshots before the next step
        logger.info(f"saving {what} {path} (async)")

    def run_validation():
        """Full utterances, batch 1, in index order (reference
        bin/train.py:451-471), padded to 64-frame buckets with the padded
        tail masked out of the loss."""
        logger.info("Start valid...")
        bucket = 64
        n_items = min(hp.valid_num + 1, len(valid_dataset))
        total = 0.0
        state.generator.eval()
        for idx in range(n_items):
            item = valid_dataset[idx]
            mel_item = item["mel"]
            if "f0" in item:  # NHV's conditioning channel
                mel_item = np.concatenate([mel_item, item["f0"][: mel_item.shape[0], None]], 1)
            t_mel = mel_item.shape[0]
            t_b = (t_mel + bucket - 1) // bucket * bucket
            mel = np.pad(mel_item, ((0, t_b - t_mel), (0, 0)))[None]
            wav = item["wav"][: t_mel * hp.hop_size]
            n_true = wav.shape[0]
            wav = np.pad(wav, (0, t_b * hp.hop_size - n_true))[None]
            batch = to_device({"mel": mel, "wav": wav}, device)
            total += float(trainer.valid_step_full(state.generator, batch["mel"], batch["wav"],
                                                   n_true))
        state.generator.train()
        # divided by valid_num over valid_num + 1 items: the reference's
        # quirk, kept (bin/train.py:458-471)
        writer.add_scalar("valid_stft_loss", total / float(hp.valid_num), state.step)

    def host_batches():
        # Batch number n of a run is batch (n - 1) % steps_per_epoch of epoch
        # (n - 1) // steps_per_epoch, each epoch drawn from (seed, epoch): a
        # resumed run skips what the run before it consumed and goes on with
        # the batches the unbroken run would have seen.  The weight target
        # is read only by the weight L1 before the discriminator starts
        # (reference bin/train.py:87-89): past the boundary it is dropped
        # from the stream, before it as float16, as the JAX script sends it
        # (an L1 target; the loss sums in float32).
        first_epoch, skip = divmod(start_step, steps_per_epoch)
        for epoch in range(first_epoch, hp.epochs):
            stream = batch_iterator(dataset, hp, seed=args.seed, epoch=epoch, L=L,
                                    shard_index=rank, shard_count=world, batch_size=per_rank_bs)
            for i, batch in enumerate(stream):
                if epoch == first_epoch and i < skip:
                    continue
                if is_basis and epoch * steps_per_epoch + i + 1 > hp.discriminator_train_start_steps:
                    batch = {k: v for k, v in batch.items() if k != "weight"}
                elif "weight" in batch:
                    batch = dict(batch, weight=batch["weight"].astype(np.float16))
                yield batch

    use_device_cache = args.device_cache
    if use_device_cache < 0:
        need = corpus_bytes(dataset, hp, L, cfg.arch.out_channels if is_basis else 0)
        use_device_cache = int(world == 1 and need <= DEVICE_CACHE_MAX_BYTES)
        logger.info(f"--device_cache -1: the padded corpus takes about {need / 1e9:.2f} GB, "
                    f"{'within' if need <= DEVICE_CACHE_MAX_BYTES else 'over'} the "
                    f"{DEVICE_CACHE_MAX_BYTES / 1e9:.0f} GB rule"
                    + (f" and {world} processes train" if world > 1 else "") + ": the "
                    f"{'device' if use_device_cache else 'host'} path")
    if use_device_cache:
        logger.info("input: the corpus on the device, crops cut there (data/device_cache.py)")
        corpus = DeviceCorpus(dataset, hp=hp, L=L, device=device, log=logger.info)
        batch_stream = corpus.batches(seed=args.seed, batch_size=per_rank_bs, shard_index=rank,
                                      shard_count=world, start_step=start_step,
                                      weight_until=hp.discriminator_train_start_steps)
    else:
        logger.info("input: host crops, prefetched to the device (runtime/prefetch.py)")
        batch_stream = prefetch_to_device(host_batches(), device)

    deadline = wall_deadline()
    if dp is not None:  # rank 0's deadline, decided by rank 0's clock below
        deadline = dp.broadcast_value(deadline)
    writer, ckpt_writer = _NoopWriter(), None
    if is_main:
        writer = _ScalarJsonWriter(_make_writer(os.path.join(hp.tensorboard_path, stamp)),
                                   os.path.join(current_logger_path, "all_scalars.json"))
        ckpt_writer = AsyncCheckpointWriter()
    stop_watchdog = threading.Event()
    heartbeat = [time.monotonic() + args.stall_exit_s]  # the first step gets twice the grace
    if is_main and args.stall_exit_s > 0:
        _start_stall_watchdog(heartbeat, args.stall_exit_s, current_logger_path,
                              stop=stop_watchdog)
    timer = StepTimer(clear_time=hp.clear_time)
    window_steps = 0
    timer.start()
    try:
        for batch in batch_stream:
            heartbeat[0] = time.monotonic()
            if args.max_steps and state.step >= args.max_steps:
                break
            step_fn = (trainer.gan_step if state.step + 1 > hp.discriminator_train_start_steps
                       else trainer.pre_adv_step)
            _, metrics = step_fn(state, batch["mel"], batch["wav"], batch.get("weight"))
            pending.append((state.step, metrics))
            window_steps += 1

            if state.step % hp.log_step == 0:
                drained = drain_metrics()  # waits for the window's steps
                mean_t = timer.stop() / max(window_steps, 1)
                timer.start()
                window_steps = 0
                m = drained[-1][1]
                epoch = (state.step - 1) // steps_per_epoch
                eta = (total_step - state.step) * mean_t
                msg = (f"epoch [{epoch + 1}] step [{state.step}/{total_step}] "
                       + " ".join(f"{k}={v:.6f}" for k, v in sorted(m.items()))
                       + f" step_time={mean_t:.3f}s eta={eta / 3600:.1f}h")
                logger.info(msg)
                if is_main:
                    with open(os.path.join(current_logger_path, "logger.txt"), "a") as f:
                        f.write(msg + "\n")
                for k, v in m.items():
                    writer.add_scalar(k, v, state.step)
            if state.step % hp.save_step == 0:
                drain_metrics()
                if is_main:
                    save(state.step)
            if state.step % hp.valid_step == 0:
                drain_metrics()
                if is_main:
                    run_validation()
            past_deadline = bool(deadline) and time.time() >= deadline
            if deadline and dp is not None:
                # clocks differ: a rank that stopped on its own clock would
                # leave the others waiting in the next step's all-reduce
                past_deadline = bool(dp.broadcast_value(past_deadline))
            if (args.max_steps and state.step >= args.max_steps) or past_deadline:
                if past_deadline:
                    logger.info(f"wall-clock deadline {deadline:.0f} reached at step "
                                f"{state.step}; stopping")
                else:
                    logger.info(f"reached max_steps={args.max_steps}; stopping")
                if is_main and state.step % hp.save_step != 0:
                    save(state.step, "final checkpoint")  # the tail: a resumed run loses nothing
                break
        drain_metrics()
        if ckpt_writer is not None:
            ckpt_writer.wait()
    finally:
        batch_stream.close()  # frees the prefetch thread of a run cut short
        stop_watchdog.set()
        if ckpt_writer is not None:
            ckpt_writer.close()
        writer.close()
    state.history = history
    return state


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--audio_index_path", type=str,
                        default=os.path.join("dataset", "audio", "train"))
    parser.add_argument("--mel_index_path", type=str,
                        default=os.path.join("dataset", "mel", "train"))
    parser.add_argument("--audio_index_valid_path", type=str,
                        default=os.path.join("dataset", "audio", "valid"))
    parser.add_argument("--mel_index_valid_path", type=str,
                        default=os.path.join("dataset", "mel", "valid"))
    parser.add_argument("--checkpoint_path", type=str, default="",
                        help="a checkpoint, or a run directory to resume from its newest one")
    parser.add_argument("--restore_step", type=int, default=0,
                        help="the step to go on from (0: the checkpoint's own)")
    parser.add_argument("--run_dir", type=str, default="",
                        help="self-contained run directory: checkpoints and logs go to "
                             "<run_dir>/{checkpoint,logger}")
    parser.add_argument("--learning_rate", type=float, default=HP.learning_rate)
    parser.add_argument("--learning_rate_discriminator", type=float,
                        default=HP.learning_rate_discriminator)
    parser.add_argument("--model_name", type=str, required=True,
                        help="hifigan, multiband-hifigan, basis-melgan, melgan or nhv")
    parser.add_argument("--config", type=str, required=True,
                        help="path to the model configuration file")
    parser.add_argument("--use_scheduler", type=int, default=0)
    parser.add_argument("--basis_dataset_path", type=str, default="Basis-MelGAN-dataset")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--max_steps", type=int, default=0,
                        help="stop after N steps (0 = run on, like the reference)")
    parser.add_argument("--test_size", type=int, default=0,
                        help="truncate the dataset for smoke runs")
    parser.add_argument("--batch_size", type=int, default=HP.batch_size)
    parser.add_argument("--batch_expand_size", type=int, default=HP.batch_expand_size)
    parser.add_argument("--fixed_length", type=int, default=HP.fixed_length)
    parser.add_argument("--save_step", type=int, default=HP.save_step)
    parser.add_argument("--valid_step", type=int, default=HP.valid_step)
    parser.add_argument("--valid_num", type=int, default=HP.valid_num)
    parser.add_argument("--discriminator_train_start_steps", type=int,
                        default=HP.discriminator_train_start_steps)
    parser.add_argument("--device", type=str, default="",
                        help="cuda (default; raises without a GPU; under torchrun each rank "
                             "takes cuda:LOCAL_RANK) or cpu (gloo under torchrun)")
    parser.add_argument("--mixprecision", type=int, default=0,
                        help="1 trains in bf16 mixed precision (float32 parameters and "
                             "optimiser state, bf16 compute)")
    parser.add_argument("--use_mpd", type=int, default=-1,
                        help="1 adds the multi-period discriminator, 0 leaves it out; -1 "
                             "takes the YAML's use_mpd key (off, as in the reference)")
    parser.add_argument("--remat", type=int, default=0,
                        help="1 recomputes the generator forward in the backward (less "
                             "activation memory, one more generator pass an update)")
    parser.add_argument("--device_cache", type=int, default=-1,
                        help="1 stages the corpus on the device and cuts crops there, 0 cuts "
                             "them on the host and prefetches, -1 takes the JAX script's rule "
                             f"(the device path up to {DEVICE_CACHE_MAX_BYTES:.0e} bytes)")
    parser.add_argument("--stall_exit_s", type=int, default=900,
                        help="exit with code 17 when no step completes for this many seconds "
                             "(the first step gets twice as long); 0 disables")
    parser.add_argument("--fused_train", type=int, default=-1,
                        help="-1 or 1 trains through the kernels (this package's path on the "
                             "card); 0 runs the generator's residual-stack and MRF stages as "
                             "the modules' library convs (cuDNN on the card)")
    return parser


def run_train(argv=None, disc_cfg: DiscriminatorConfig = DISC):
    """Parse `argv` and train; -> the final `TrainState`.  `disc_cfg` sizes
    the discriminator (the reference's sizes by default)."""
    return run(build_parser().parse_args(argv), disc_cfg=disc_cfg)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    run_train()
