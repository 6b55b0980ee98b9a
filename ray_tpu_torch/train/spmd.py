"""Train-step builder: loss in, optimizer step out.

Counterpart of ray_tpu/train/spmd.py's ``make_train_step`` on one device.
The JAX version jits a pure step over sharded params; here the step runs
eagerly, ``loss.backward()`` fills the leaves' ``.grad`` and the optimizer
updates the leaves in place.
"""

from __future__ import annotations

from typing import Callable

import torch

MULTI_GPU_TODO = ("a train step over a mesh of more than one device is not "
                  "ported yet: ROADMAP.md Queue 1 item 11 (Multi-GPU)")


def make_train_step(loss_fn: Callable, optimizer: torch.optim.Optimizer, *,
                    mesh=None) -> Callable:
    """Returns ``step(params, opt_state, batch) -> (params, opt_state,
    loss)`` for ``loss_fn(params, batch) -> scalar``.

    The step frees the previous gradients, runs forward and backward, and
    steps `optimizer` (built over the leaves of `params`, e.g. by
    ``train.adamw``), so params and optimizer state are updated in place
    and returned as they came; ``opt_state`` is carried only to keep the JAX
    signature. The loss comes back as a detached device scalar (no host
    sync). `mesh` may be None or a one-device mesh (anything with
    ``size()``); a larger one raises."""
    if mesh is not None and mesh.size() > 1:
        raise NotImplementedError(MULTI_GPU_TODO)

    def step(params, opt_state, batch):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(params, batch)
        loss.backward()
        optimizer.step()
        return params, opt_state, loss.detach()

    return step
