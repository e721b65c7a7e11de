"""Data-parallel process groups for training, one process per card.

Counterpart of `fastvocoder_tpu/parallel/distributed.py`.  The JAX package
runs one process a host over all of its chips and forms the global runtime
with `jax.distributed.initialize`; this package runs one process a card
(`torchrun --nproc_per_node N`, or any launcher that sets the same
environment) and joins them in a `torch.distributed` process group:

  RANK, WORLD_SIZE     this process's rank and the number of processes
  LOCAL_RANK           its card on this host: `cuda:LOCAL_RANK`
  MASTER_ADDR, MASTER_PORT   rank 0's address, where the group meets

NCCL joins CUDA devices, gloo the CPU (`device="cpu"`, the CPU tests).
Nothing is asked of a run whose environment names no group: it stays one
process, `(0, 1)`.

`DataParallel` is what the trainer, the losses and the training script hold
of a group: the rank, the world size and the collectives they use, each
tensor list flattened into one buffer so that a network's gradients cross
in one all-reduce per update (the JAX package's XLA emits one fused
gradient all-reduce, `parallel/mesh.py:82-90`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from fastvocoder_tpu_torch import resolve_device


def multihost_env_requested() -> bool:
    """Whether the environment asks for a process group: rank 0's address
    is set, or more than one process is named."""
    if os.environ.get("MASTER_ADDR"):
        return True
    try:
        return int(os.environ.get("WORLD_SIZE", "1")) > 1
    except ValueError:
        return False


def rank_device(device="cuda") -> torch.device:
    """This process's device: `cuda:LOCAL_RANK` for a CUDA device (raising
    without one), the CPU when asked for."""
    device = resolve_device(device)
    if device.type == "cuda":
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return device


def maybe_initialize_distributed(device="cuda", backend: Optional[str] = None) -> Tuple[int, int]:
    """Join the process group the environment asks for; -> (rank, world
    size), (0, 1) when it asks for none.  `device` is the run's: a CUDA
    device (this process's card becomes the current one) takes NCCL unless
    `backend` names another, the CPU gloo; asked for CUDA without a card,
    it raises.  Idempotent: with a group already formed it returns that
    group's rank and size."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if not multihost_env_requested():
        return 0, 1
    device = rank_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    rank = int(os.environ.get("RANK", "0"))
    world = int(os.environ.get("WORLD_SIZE", "1"))
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world)
    return rank, world


def is_main_process() -> bool:
    """True on the process that writes checkpoints, logs and TensorBoard:
    rank 0, or the only process."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


class _AllReduceSum(torch.autograd.Function):
    """The sum over the group, whose gradient is the sum of the ranks'
    gradients: under the convention that a step averages the ranks'
    gradients, that is the gradient of the mean of the ranks' losses."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat(flat: torch.Tensor, like: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    return [piece.view_as(t) for piece, t in zip(flat.split([t.numel() for t in like]), like)]


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """A process group as data parallelism uses it.  Every rank holds the
    same parameters and its own rows of the global batch; a step's
    gradients are the mean of the ranks' (`all_reduce_mean`), which is the
    global batch's gradient wherever a loss is a mean over equal shards."""

    rank: int
    world: int
    group: Any = None  # a torch.distributed ProcessGroup; None: the default group

    @classmethod
    def current(cls, group: Any = None) -> Optional["DataParallel"]:
        """The formed group (`group`, else the default one), or None when no
        group is formed."""
        if not (dist.is_available() and dist.is_initialized()):
            return None
        return cls(dist.get_rank(group), dist.get_world_size(group), group)

    @property
    def backend(self) -> str:
        return str(dist.get_backend(self.group))

    def rows(self, n_local: int) -> slice:
        """This rank's rows of a global batch of `n_local * world` rows."""
        return slice(self.rank * n_local, (self.rank + 1) * n_local)

    def all_reduce_sum(self, t: torch.Tensor, differentiable: bool = False) -> torch.Tensor:
        """The sum of `t` over the group, a new tensor.  `differentiable`:
        its gradient is the sum of the ranks' gradients (a global batch
        statistic); else `t` is taken without its graph."""
        if differentiable:
            return _AllReduceSum.apply(t, self.group)
        out = t.detach().clone()
        dist.all_reduce(out, group=self.group)
        return out

    def all_reduce_mean(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The ranks' mean of each tensor (one type, one device), through one
        all-reduce of a flattened copy; -> views of that buffer, shaped as
        the inputs."""
        if not tensors:
            return []
        flat = _flat([t.detach() for t in tensors])
        dist.all_reduce(flat, group=self.group)
        flat /= self.world
        return _unflat(flat, tensors)

    def broadcast_(self, tensors: Sequence[torch.Tensor], src: int = 0) -> None:
        """Overwrite `tensors` with rank `src`'s values, one broadcast a
        (type, device) among them."""
        by_kind = {}
        for t in tensors:
            by_kind.setdefault((t.dtype, t.device), []).append(t)
        for (_, device), same in by_kind.items():
            flat = _flat([t.detach() for t in same])
            if device.type == "cpu" and self.backend == "nccl":  # NCCL moves CUDA memory only
                flat = flat.to(torch.device("cuda", torch.cuda.current_device()))
            dist.broadcast(flat, src=src, group=self.group)
            with torch.no_grad():
                for t, v in zip(same, _unflat(flat, same)):
                    t.copy_(v)

    def broadcast_value(self, value: float, src: int = 0) -> float:
        """Rank `src`'s `value` on every rank (a host sync)."""
        device = "cpu"
        if self.backend == "nccl":
            device = torch.device("cuda", torch.cuda.current_device())
        t = torch.tensor([float(value)], dtype=torch.float64, device=device)
        dist.broadcast(t, src=src, group=self.group)
        return float(t.item())
