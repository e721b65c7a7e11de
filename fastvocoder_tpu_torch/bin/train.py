"""Training entry point: `run_train(argv)`.

Counterpart of `fastvocoder_tpu/bin/train.py` (reference
bin/train.py:258-499) for one device.  Per step the host picks
`pre_adv_step` or `gan_step` at the `discriminator_train_start_steps`
boundary, as the JAX package's `bin/train.py` does.  It keeps that script's
artifacts:
per-step `total_loss.txt` / `stft_loss.txt` appends, a `logger.txt` line
every `log_step`, `all_scalars.json` on exit, `checkpoint_<step>.pth.tar`
every `save_step` (and at `max_steps`), and the `valid_step` sweep over full
utterances in index order; a run directory as `--checkpoint_path` resumes
from its newest checkpoint and goes on with the batches the unbroken run
would have seen.

The run is on the CUDA device unless `--device cpu` is passed; with neither
it raises.  Metrics stay on the device between log points, so steps queue
without a host sync.  Arguments of the JAX script whose features are not
ported yet (`--mixprecision`, `--remat`, `--device_cache`, `--use_mpd`)
raise when set.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
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
from fastvocoder_tpu_torch.hparams import DISC, HP, DiscriminatorConfig, load_model_config
from fastvocoder_tpu_torch.train.checkpoint import (
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from fastvocoder_tpu_torch.train.trainer import make_trainer

logger = logging.getLogger(__name__)

# arguments of the JAX script that this package accepts only at their
# "off" value: name -> (off value, what waits)
WAITING = {
    "mixprecision": (0, "bf16 mixed precision"),
    "remat": (0, "rematerialisation of the generator forward"),
    "device_cache": (0, "the on-device corpus cache"),
    "use_mpd": (0, "the multi-period discriminator"),
}


def run(args, disc_cfg: DiscriminatorConfig = DISC):
    """Train as `args` (the namespace `run_train` parses) says; -> the final
    `TrainState`, with the logged metrics of every step in
    `state.history`."""
    for name, (off, what) in WAITING.items():
        if getattr(args, name, off) not in (off, -1):
            raise NotImplementedError(
                f"--{name}: {what} is not ported yet (ROADMAP queue A)"
            )
    cfg = load_model_config(args.model_name, args.config)
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
        # a self-contained run directory: checkpoints and logs under it
        hp = hp.replace(checkpoint_path=os.path.join(args.run_dir, "checkpoint"),
                        logger_path=os.path.join(args.run_dir, "logger"))

    logger.info(f"Loading Model of {args.model_name}...")
    is_basis = args.model_name == "basis-melgan"
    basis_signal_weight = None
    if is_basis:
        basis_signal_weight = np.load(
            os.path.join(args.basis_dataset_path, "basis_signal_weight.npy")).astype(np.float32)
    trainer = make_trainer(
        cfg, hp=hp, basis_signal_weight=basis_signal_weight,
        use_scheduler=bool(args.use_scheduler), learning_rate=args.learning_rate,
        learning_rate_discriminator=args.learning_rate_discriminator,
        disc_cfg=disc_cfg, device=args.device or None,
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
        logger.info(f"\n---Model Restored at Step {state.step}---\n")
    else:
        logger.info("\n---Start New Training---\n")

    stamp = str(datetime.now()).replace(" ", "-").replace(":", "-").replace(".", "-")
    current_checkpoint_path = os.path.join(hp.checkpoint_path, stamp)
    current_logger_path = os.path.join(hp.logger_path, stamp)
    os.makedirs(current_checkpoint_path, exist_ok=True)
    os.makedirs(current_logger_path, exist_ok=True)
    scalars: dict = {}

    def add_scalar(tag, value, step):
        scalars.setdefault(tag, []).append([step, float(value)])

    if is_basis:
        weight_dir = os.path.join(args.basis_dataset_path, "weight")
        dataset = WeightDataset.from_index_files(
            args.audio_index_path, args.mel_index_path, cfg.arch.L, weight_dir=weight_dir,
            hp=hp, test_size=hp.test_size)
        valid_dataset = WeightDataset.from_index_files(
            args.audio_index_valid_path, args.mel_index_valid_path, cfg.arch.L,
            weight_dir=weight_dir, hp=hp, test_size=hp.test_size)
    else:
        dataset = BufferDataset(load_data_to_buffer(
            args.audio_index_path, args.mel_index_path, test_size=hp.test_size,
            log=logger.info), hp)
        valid_dataset = BufferDataset(load_data_to_buffer(
            args.audio_index_valid_path, args.mel_index_valid_path, test_size=hp.test_size,
            log=logger.info), hp)

    steps_per_epoch = num_batches_per_epoch(len(dataset), hp)
    total_step = hp.epochs * steps_per_epoch
    logger.info(f"{steps_per_epoch} steps per epoch")
    if steps_per_epoch == 0:
        raise SystemExit(
            f"0 steps per epoch: {len(dataset)} items cannot fill one mega-batch of "
            f"batch_size*batch_expand_size = {hp.batch_size}*{hp.batch_expand_size}; lower "
            "--batch_size/--batch_expand_size or add data"
        )
    L = cfg.arch.L if is_basis else None
    start_step = state.step
    history = []   # (step, {name: float}) of every step, drained at log points
    pending = []   # (step, metrics on the device)

    def drain_metrics():
        if not pending:
            return []
        drained = [(s, {k: float(v) for k, v in m.items()}) for s, m in pending]
        pending.clear()
        with open(os.path.join(current_logger_path, "total_loss.txt"), "a") as ft, \
                open(os.path.join(current_logger_path, "stft_loss.txt"), "a") as fs:
            for _, m in drained:
                ft.write(f"{m['total_loss']}\n")
                fs.write(f"{m['stft_loss']}\n")
        history.extend(drained)
        return drained

    def save(step):
        path = os.path.join(current_checkpoint_path, f"checkpoint_{step}.pth.tar")
        save_checkpoint(path, state, args.model_name)
        logger.info(f"saved checkpoint {path}")

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
            t_mel = item["mel"].shape[0]
            t_b = (t_mel + bucket - 1) // bucket * bucket
            mel = np.pad(item["mel"], ((0, t_b - t_mel), (0, 0)))[None]
            wav = item["wav"][: t_mel * hp.hop_size]
            n_true = wav.shape[0]
            wav = np.pad(wav, (0, t_b * hp.hop_size - n_true))[None]
            batch = to_device({"mel": mel, "wav": wav}, device)
            total += float(trainer.valid_step_full(state.generator, batch["mel"], batch["wav"],
                                                   n_true))
        state.generator.train()
        # divided by valid_num over valid_num + 1 items: the reference's
        # quirk, kept (bin/train.py:458-471)
        add_scalar("valid_stft_loss", total / float(hp.valid_num), state.step)

    def host_batches():
        # Batch number n of a run is batch (n - 1) % steps_per_epoch of epoch
        # (n - 1) // steps_per_epoch, each epoch drawn from (seed, epoch): a
        # resumed run skips what the run before it consumed and goes on with
        # the batches the unbroken run would have seen.  The weight target
        # is read only by the weight L1 before the discriminator starts
        # (reference bin/train.py:87-89): past the boundary it is dropped
        # from the stream.
        first_epoch, skip = divmod(start_step, steps_per_epoch)
        for epoch in range(first_epoch, hp.epochs):
            stream = batch_iterator(dataset, hp, seed=args.seed, epoch=epoch, L=L)
            for i, batch in enumerate(stream):
                if epoch == first_epoch and i < skip:
                    continue
                if is_basis and epoch * steps_per_epoch + i + 1 > hp.discriminator_train_start_steps:
                    batch = {k: v for k, v in batch.items() if k != "weight"}
                yield batch

    window_start, window_steps = time.perf_counter(), 0
    for host_batch in host_batches():
        if args.max_steps and state.step >= args.max_steps:
            break
        batch = to_device(host_batch, device)
        step_fn = (trainer.gan_step if state.step + 1 > hp.discriminator_train_start_steps
                   else trainer.pre_adv_step)
        _, metrics = step_fn(state, batch["mel"], batch["wav"], batch.get("weight"))
        pending.append((state.step, metrics))
        window_steps += 1

        if state.step % hp.log_step == 0:
            drained = drain_metrics()  # waits for the window's steps
            mean_t = (time.perf_counter() - window_start) / max(window_steps, 1)
            window_start, window_steps = time.perf_counter(), 0
            m = drained[-1][1]
            epoch = (state.step - 1) // steps_per_epoch
            msg = (f"epoch [{epoch + 1}] step [{state.step}/{total_step}] "
                   + " ".join(f"{k}={v:.6f}" for k, v in sorted(m.items()))
                   + f" step_time={mean_t:.3f}s")
            logger.info(msg)
            with open(os.path.join(current_logger_path, "logger.txt"), "a") as f:
                f.write(msg + "\n")
            for k, v in m.items():
                add_scalar(k, v, state.step)
        if state.step % hp.save_step == 0:
            drain_metrics()
            save(state.step)
        if state.step % hp.valid_step == 0:
            drain_metrics()
            run_validation()
        if args.max_steps and state.step >= args.max_steps:
            logger.info(f"reached max_steps={args.max_steps}; stopping")
            if state.step % hp.save_step != 0:
                save(state.step)  # the tail, so a resumed run loses nothing
            break

    drain_metrics()
    with open(os.path.join(current_logger_path, "all_scalars.json"), "w") as f:
        json.dump(scalars, f)
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
    parser.add_argument("--run_dir", type=str, default="",
                        help="self-contained run directory: checkpoints and logs go to "
                             "<run_dir>/{checkpoint,logger}")
    parser.add_argument("--learning_rate", type=float, default=HP.learning_rate)
    parser.add_argument("--learning_rate_discriminator", type=float,
                        default=HP.learning_rate_discriminator)
    parser.add_argument("--model_name", type=str, required=True,
                        help="hifigan, multiband-hifigan, basis-melgan")
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
                        help="cuda (default; raises without a GPU) or cpu")
    for name, (off, what) in WAITING.items():
        parser.add_argument(f"--{name}", type=int, default=off,
                            help=f"{what}: not ported yet, raises when set")
    return parser


def run_train(argv=None, disc_cfg: DiscriminatorConfig = DISC):
    """Parse `argv` and train; -> the final `TrainState`.  `disc_cfg` sizes
    the discriminator (the reference's sizes by default)."""
    return run(build_parser().parse_args(argv), disc_cfg=disc_cfg)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    run_train()
