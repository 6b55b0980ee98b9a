"""Training: orchestration, optimizers and the train steps.

Counterpart of ray_tpu/train, in two layers as there:

- Orchestration: `DataParallelTrainer`/`TorchTrainer` + controller/worker
  group (reference: train/v2/api/data_parallel_trainer.py:64), the session
  API (`report`, `get_checkpoint`, `get_dataset_shard`, ...), checkpoint
  storage, and the host ZeRO plane (`ZeroShardedOptimizer`).
- In-program: `make_train_step`/`make_sp_pp_train_step` build the train
  steps on one device or over a mesh; the model's loss is
  ``ray_tpu_torch.models.transformer.loss_fn``.

The orchestration layer does not import torch: the controller, the sync
actor and Tune's trial runners stay light, and only the train loop's
workers pay for torch and CUDA. The in-program names (the optimizers,
steps and ZeRO planes) load on first access, after ``_device``'s numerics
settings. The JAX package's `JaxConfig`/`JaxTrainer` have no counterpart
here.
"""

import importlib

from ray_tpu_torch.train import storage
from ray_tpu_torch.train._checkpoint import Checkpoint
from ray_tpu_torch.train.backend import BackendConfig, TorchConfig
from ray_tpu_torch.train.config import (
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.train.session import (
    broadcast_from_rank_zero,
    collective_barrier,
    get_checkpoint,
    get_context,
    get_dataset_shard,
    report,
    report_opt_state,
)
from ray_tpu_torch.train.trainer import (
    DataParallelTrainer,
    TorchTrainer,
    Result,
    TrainingFailedError,
)

# name → the submodule that defines it (loaded with torch on first access)
_IN_PROGRAM = {
    **{n: "optim" for n in ("AdamWInt8", "adamw", "adamw_int8",
                            "optimizer_state_bytes", "param_leaves")},
    **{n: "spmd" for n in ("init_sharded", "make_sp_pp_train_step",
                           "make_train_step")},
    **{n: "zero" for n in ("ZeroShardedOptimizer", "make_zero_train_step",
                           "match_partition_rules", "zero")},
}


def __getattr__(name: str):
    sub = _IN_PROGRAM.get(name)
    if sub is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    importlib.import_module("ray_tpu_torch._device")  # numerics first
    mod = importlib.import_module(f"{__name__}.{sub}")
    return mod if name == sub else getattr(mod, name)


__all__ = [
    "AdamWInt8",
    "BackendConfig",
    "Checkpoint",
    "CheckpointConfig",
    "DataParallelTrainer",
    "FailureConfig",
    "TorchTrainer",
    "Result",
    "RunConfig",
    "ScalingConfig",
    "TorchConfig",
    "TrainingFailedError",
    "adamw",
    "adamw_int8",
    "broadcast_from_rank_zero",
    "collective_barrier",
    "get_checkpoint",
    "get_context",
    "get_dataset_shard",
    "init_sharded",
    "make_sp_pp_train_step",
    "make_train_step",
    "optimizer_state_bytes",
    "param_leaves",
    "report",
    "report_opt_state",
    "storage",
    "zero",
    "ZeroShardedOptimizer",
    "make_zero_train_step",
    "match_partition_rules",
]
