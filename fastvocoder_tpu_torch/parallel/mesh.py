"""Data parallelism for the GAN train step and for batched serving.

Counterpart of `fastvocoder_tpu/parallel/mesh.py`.  There a mesh is a
`jax.sharding.Mesh` over the batch axis: parameters are replicated, the
batch is sharded along its first axis, and XLA's partitioner places the
gradient all-reduce.  Here a mesh is a list of `torch.device`s:

  * in training, each process of a `torch.distributed` group runs on its
    own card (`distributed.py`), holds the same parameters
    (`replicate_state` broadcasts rank 0's), takes its rows of the global
    batch (`shard_batch`, or `batch_iterator` / `DeviceCorpus.batches` with
    `shard_index` and `shard_count`), and its trainer reduces each
    network's gradients in one flattened all-reduce an update
    (`compile_train_step`);
  * in serving, one process holds a replica of the generator on each device
    of the mesh and splits each batch's rows over them
    (`models/batched.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import torch

from fastvocoder_tpu_torch import resolve_device
from fastvocoder_tpu_torch.parallel.distributed import DataParallel

DATA_AXIS = "data"  # the batch axis the mesh splits, as in the JAX package


def make_mesh(devices: Optional[Sequence] = None) -> List[torch.device]:
    """The mesh's devices: `devices` as given (a device may repeat: two
    replicas on one card), by default every CUDA device; raises without
    CUDA unless the CPU is named."""
    if devices is None:
        resolve_device("cuda")
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    mesh = [resolve_device(d) for d in devices]
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


def _split_rows(v, n: int) -> list:
    if v.shape[0] % n:
        raise ValueError(f"{v.shape[0]} rows do not split over {n} devices")
    k = v.shape[0] // n
    return [v[i * k: (i + 1) * k] for i in range(n)]


def _on(v, device: torch.device) -> torch.Tensor:
    t = v if isinstance(v, torch.Tensor) else torch.from_numpy(v)
    return t.to(device, non_blocking=True)


def shard_batch(batch: Dict[str, object], mesh: Sequence[torch.device],
                dp: Optional[DataParallel] = None) -> List[Dict[str, torch.Tensor]]:
    """A global batch (arrays or tensors of equal rows) split along its first
    axis.  Under a process group (`dp`, by default the formed one): this
    rank's rows, one dict on the mesh's first device (a rank's own card).
    In one process: one dict a device of the mesh, contiguous rows in
    order.  The rows must divide evenly."""
    dp = dp if dp is not None else DataParallel.current()
    if dp is not None:
        return [{k: _on(_split_rows(v, dp.world)[dp.rank], mesh[0]) for k, v in batch.items()}]
    parts = {k: _split_rows(v, len(mesh)) for k, v in batch.items()}
    return [{k: _on(parts[k][i], d) for k in batch} for i, d in enumerate(mesh)]


def replicate_state(state, dp: Optional[DataParallel] = None):
    """Give every rank rank 0's training state: the generator's and the
    discriminator's parameters and buffers, both Adam states and the step
    counters, one broadcast a (type, device) of each.  Call it after
    initialisation or a resume, on every rank; each rank's Adam state must
    hold the same entries (a fresh start or the same checkpoint).  Without a
    group it returns `state` as it is."""
    dp = dp if dp is not None else DataParallel.current()
    if dp is None:
        return state
    for module in (state.generator, state.discriminator):
        dp.broadcast_(list(module.parameters()) + list(module.buffers()))
    for opt in (state.gen_opt, state.disc_opt):
        tensors = [v for group in opt.param_groups for p in group["params"] if p in opt.state
                   for v in opt.state[p].values() if isinstance(v, torch.Tensor)]
        dp.broadcast_(tensors)
    counts = torch.tensor([state.step, state.gen_updates, state.disc_updates])
    dp.broadcast_([counts])
    state.step, state.gen_updates, state.disc_updates = (int(c) for c in counts.tolist())
    return state


def compile_train_step(step_fn: Callable, dp: Optional[DataParallel] = None) -> Callable:
    """The JAX package's `compile_train_step` for this package: a step of a
    `Trainer` (`trainer.pre_adv_step` or `trainer.gan_step`) as the same
    step of a trainer whose gradients are reduced over `dp` (by default the
    formed group; without one, the step as it is).  Each network's
    gradients, the frozen basis's included, cross in one flattened
    all-reduce before the clip, so every rank clips by the same norm and
    the replicas stay equal."""
    dp = dp if dp is not None else DataParallel.current()
    trainer = step_fn.__self__
    if dp is None or trainer.dp == dp:
        return step_fn
    return getattr(dataclasses.replace(trainer, dp=dp), step_fn.__name__)


# the Basis-MelGAN weight target is an optional argument of the port's steps,
# so both of the JAX package's forms are one function here
compile_train_step_no_weight = compile_train_step


def reduce_metrics(metrics: Sequence[Dict[str, torch.Tensor]],
                   dp: Optional[DataParallel]) -> List[Dict[str, torch.Tensor]]:
    """Steps' metrics (each a dict of scalars computed on this rank's rows)
    as the global batch's: the ranks' mean of every value, in one
    all-reduce.  Every loss is a mean over equal shards, or already global
    (spectral convergence, `losses/stft_loss.py`), so the mean is the
    global value.  Call it at the same points on every rank."""
    if dp is None or not metrics:
        return list(metrics)
    keys = [sorted(m) for m in metrics]
    flat = torch.stack([m[k].detach().float().reshape(()) for m, ks in zip(metrics, keys)
                        for k in ks])
    (flat,) = dp.all_reduce_mean([flat])
    out, i = [], 0
    for ks in keys:
        out.append({k: flat[i + j] for j, k in enumerate(ks)})
        i += len(ks)
    return out
