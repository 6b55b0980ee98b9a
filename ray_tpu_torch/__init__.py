"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu.

Mirrors ray_tpu's module paths and public names (``ray_tpu_torch.ops.attention``
is the twin of ``ray_tpu.ops.attention``) so each reference module has an
obvious counterpart. Imports torch and numpy only: never jax, never ray_tpu.

The runtime core (``init``/``remote``/``get``/``put``/``wait``/``kill``,
actors, placement groups) is the port's own copy of the JAX package's, with
the GPU as its accelerator resource (``num_gpus``). Importing the package
does not import torch: the runtime's processes load it only when their
code does, and every computing subpackage (ops, models, llm, train,
parallel) loads it first through ``_device``.

Device rule: entry points run on ``cuda`` unless the caller passes
``device="cpu"``; with no GPU and no ``device=`` they raise. On a CUDA tensor a
kernel wrapper launches its hand-written Hopper kernel (``csrc/``) or raises;
only a CPU tensor takes the plain PyTorch version.
"""

from ray_tpu_torch._private.api import (
    available_resources,
    cancel,
    cluster_resources,
    cluster_state,
    free,
    get,
    get_actor,
    get_runtime_context,
    init,
    is_initialized,
    kill,
    nodes,
    timeline,
    put,
    remote,
    shutdown,
    wait,
)
from ray_tpu_torch._private.worker import ObjectRef
from ray_tpu_torch.actor import ActorClass, ActorHandle, method
from ray_tpu_torch.cross_lang import cpp_function, start_cpp_worker
from ray_tpu_torch.remote_function import RemoteFunction
from ray_tpu_torch import exceptions
from ray_tpu_torch import util

__version__ = "0.1.0"


def __getattr__(name):
    # the device rule lives with torch; importing it on first use keeps
    # ``import ray_tpu_torch`` free of torch
    if name == "resolve_device":
        from ray_tpu_torch._device import resolve_device

        return resolve_device
    raise AttributeError(f"module 'ray_tpu_torch' has no attribute {name!r}")


__all__ = [
    "ActorClass",
    "ActorHandle",
    "ObjectRef",
    "RemoteFunction",
    "available_resources",
    "cancel",
    "cluster_resources",
    "cluster_state",
    "cpp_function",
    "exceptions",
    "free",
    "get",
    "get_actor",
    "get_runtime_context",
    "init",
    "is_initialized",
    "kill",
    "method",
    "nodes",
    "resolve_device",
    "timeline",
    "put",
    "remote",
    "shutdown",
    "start_cpp_worker",
    "wait",
    "util",
    "__version__",
]
