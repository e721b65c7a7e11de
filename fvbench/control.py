"""The readings that set a cell's limits, on the card, many seeds in one
process:

    python3 -m fvbench.control --workload <cell> --as program --seeds 1 2 ... --seconds 3
    python3 -m fvbench.control --workload <cell> --as control --seeds ...
    python3 -m fvbench.control --workload <cell> --as half_batch --seeds ...

`program`: the cell as it runs, a short window, its check numbers: the lower
readings.  `control`: the reference put in the program's place and computed
one precision below the configuration's (TF32 for float32 with TF32 off),
held against the reference as the program is: the upper readings.  A served
cell runs the control through its own driver, the TF32 reference as the
generator's forward; a training cell's control is the TF32 reference's
checked steps against the float32 reference's.  `half_batch` (training):
the program's step given half the batch, its losses the mean over the rest.
One JSON line per seed.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time


@contextlib.contextmanager
def tf32():
    import torch

    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def tf32_forward(cell, seed: int, device):
    """The reference's served forward in TF32, on the seed's weights."""
    from fvbench import reference_of, weights

    ref = reference_of(cell)
    params = weights.make_params(ref, cell.config, seed, device, weight_norm=False)

    def forward(mel):
        with tf32():
            return ref.inference(params, mel, cell.config)

    return forward


def train_control(cell, seed: int, device) -> dict:
    """The TF32 reference's checked steps held against the float32
    reference's, by the cell's own comparison."""
    from fvbench import common
    from fvbench.drivers import train

    ctx = common.Context(cell=cell, seed=seed, seconds=0.0, trace=False, device=device,
                         t_start=time.perf_counter())
    items = train.corpus(ctx)
    frames = [it["mel"].shape[0] for it in items]
    import numpy as np

    from fvbench import traffic

    stream = traffic.crops(seed, np.array(frames), cell.mix["batch"], cell.mix["frames"])
    checked = [stream.next() for _ in range(cell.mix["check_steps"])]
    gan = cell.mix["step"] == "gan_step"
    names = {"generator": None}
    if gan:
        names["discriminator"] = None
    first = {net: _trained_names(cell, net) for net in names}
    want = train.reference_run(ctx, items, checked, gan, first)
    with tf32():
        got = train.reference_run(ctx, items, checked, gan, first)
    ctx.stderr(train.details(got, want))
    return train.compare(got, want)


def _trained_names(cell, net: str):
    from fvbench import disc_reference_of, reference_of, weights
    from fvbench.reference.train import FROZEN

    if net == "generator":
        P = weights.meta_params(reference_of(cell), cell.config, weight_norm=True)
    else:
        P = weights.meta_params(disc_reference_of(cell), cell.config["discriminator"],
                                weight_norm=True)
    return {k: None for k in P if not k.startswith(FROZEN)}


@contextlib.contextmanager
def half_batch():
    """The program's training steps given the first half of each batch."""
    from fastvocoder_tpu_torch.train.trainer import Trainer

    saved = Trainer.gan_step, Trainer.pre_adv_step

    def halve(step):
        def wrapped(self, state, mel, wav, weight=None):
            h = mel.shape[0] // 2
            return step(self, state, mel[:h], wav[:h], None if weight is None else weight[:h])
        return wrapped

    Trainer.gan_step, Trainer.pre_adv_step = halve(saved[0]), halve(saved[1])
    try:
        yield
    finally:
        Trainer.gan_step, Trainer.pre_adv_step = saved


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--as", dest="role", choices=("program", "control", "half_batch"),
                   required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)

    from fvbench.run import cache_dirs, execute

    cache_dirs()
    import torch

    from fvbench.registry import Registry

    cell = Registry.load().cell(args.workload)
    device = torch.device("cuda", 0)
    training = cell.mix["driver"] == "train"
    for seed in args.seeds:
        t = time.perf_counter()
        if args.role == "control" and training:
            from fvbench import common

            common.set_precision(cell.config["dtype"], cell.config["tf32"])
            checks, extra = train_control(cell, seed, device), {}
        else:
            override = tf32_forward(cell, seed, device) if args.role == "control" else None
            with half_batch() if args.role == "half_batch" else contextlib.nullcontext():
                ctx = execute(cell, seed, args.seconds, False, device, t, override)
            checks, extra = ctx.checks, dict(ctx.e2e, attempted=ctx.attempted, failed=ctx.failed)
        print(json.dumps({"workload": args.workload, "as": args.role, "seed": seed,
                          "checks": checks, **extra,
                          "wall_s": time.perf_counter() - t}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
