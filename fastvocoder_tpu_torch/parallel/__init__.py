"""Data parallelism: process groups for training (`distributed.py`) and
meshes of devices for training and serving (`mesh.py`)."""

from fastvocoder_tpu_torch.parallel.distributed import (
    DataParallel,
    is_main_process,
    maybe_initialize_distributed,
    multihost_env_requested,
    rank_device,
)
from fastvocoder_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    compile_train_step,
    compile_train_step_no_weight,
    make_mesh,
    reduce_metrics,
    replicate_state,
    shard_batch,
)

__all__ = [
    "DATA_AXIS",
    "DataParallel",
    "compile_train_step",
    "compile_train_step_no_weight",
    "is_main_process",
    "make_mesh",
    "maybe_initialize_distributed",
    "multihost_env_requested",
    "rank_device",
    "reduce_metrics",
    "replicate_state",
    "shard_batch",
]
