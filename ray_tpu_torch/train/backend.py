"""Training backends: per-worker process-group setup hooks.

(reference: Train's pluggable Backend/BackendConfig — torch NCCL/Gloo at
train/torch/config.py:43,73,122.) Counterpart of ray_tpu/train/backend.py:
the JAX package's ``JaxConfig`` (``jax.distributed.initialize`` on every
worker) has no place here; ``TorchConfig`` forms the torch process group,
over gloo or over NCCL on the workers' GPUs. On one worker it is a no-op.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

BACKENDS = ("gloo", "nccl")


@dataclass
class BackendConfig:
    backend_name = "none"

    def env_for_worker(self, rank: int, world_size: int,
                       coordinator: str | None) -> dict:
        return {}

    def on_training_start(self) -> None:
        """Runs inside each worker before the train fn."""


@dataclass
class TorchConfig(BackendConfig):
    """torch process groups over gloo (CPU and CUDA tensors) or NCCL (CUDA
    tensors, one GPU a rank). (reference: train/torch/config.py:43 —
    TorchConfig(backend, init_method).) ``init_port`` 0 takes a free port of
    this host when the group's first rank is set up (the JAX package's
    fixed 8477 would collide between groups on one host)."""

    backend_name = "torch"
    backend: str = "gloo"
    init_port: int = 0

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"TorchConfig.backend must be one of {BACKENDS}, "
                             f"got {self.backend!r}")

    def env_for_worker(self, rank: int, world_size: int,
                       coordinator: str | None) -> dict:
        if not self.init_port:  # one port for every rank of this group
            self.init_port = _free_port()
        return {
            "RANK": str(rank),
            "LOCAL_RANK": str(rank),
            "WORLD_SIZE": str(world_size),
            "MASTER_ADDR": coordinator or "127.0.0.1",
            "MASTER_PORT": str(self.init_port),
        }

    def on_training_start(self) -> None:
        import torch.distributed as dist

        if not dist.is_initialized() and int(os.environ.get("WORLD_SIZE", "1")) > 1:
            dist.init_process_group(self.backend)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
