"""GPU utilities — the port's counterpart of util/accelerators/tpu.py.

A Compute Engine GPU VM is one host, so the TPU pod utilities (the pod's
name and worker count, the ``TPU-{type}-head`` resource) have no
counterpart here; what remains is the host's GPU count and the GPUs bound
to this worker process. Detection is env-var driven
(``RAY_TPU_TORCH_GPUS`` simulates GPUs without hardware).

(reference capability: python/ray/util/accelerators/ — per-accelerator
helpers over the node's detected resources.)
"""

from __future__ import annotations

from ray_tpu_torch._private.accelerators import (current_worker_gpus,
                                                 detect_num_gpus)

__all__ = [
    "get_num_gpus_on_node",
    "get_current_process_visible_gpu_ids",
]


def get_num_gpus_on_node() -> int:
    """GPUs on this host (0 where there is none)."""
    return detect_num_gpus()


def get_current_process_visible_gpu_ids() -> list[int]:
    """GPU ids bound to this worker process ([] for CPU workers)."""
    return current_worker_gpus()
