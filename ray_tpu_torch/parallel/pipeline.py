"""Pipeline parallelism: GPipe microbatch ticks over the `pp` axis, the twin
of ray_tpu/parallel/pipeline.py.

Each rank of the `pp` axis holds its stage's slice of the stage-stacked
layer params and runs, at every tick, its stage function on its input:
stage 0 on the next microbatch, the others on what the previous stage
sent (``collectives.ring_permute``). The schedule is static, as the JAX
scan's: every stage computes at every tick, bubble ticks included, and
only the last stage's valid ticks are kept. Every rank builds the same
autograd graph (selections are ``torch.where`` on the stage index, not
Python branches), so the backward's collectives line up across ranks.
"""

from __future__ import annotations

from typing import Callable

import torch

from ray_tpu_torch.parallel.collectives import (allreduce, axis_index,
                                                axis_size, ring_permute)
from ray_tpu_torch.parallel.mesh import MESH_AXIS_PP, tree_map


def pipeline_apply(stage_fn: Callable, stage_params, x, *,
                   axis_name: str = MESH_AXIS_PP):
    """Run microbatches x [n_micro, micro_batch, ...] (the same on every
    stage) through the pipeline; returns the [n_micro, ...] outputs, valid
    on every rank (the last stage's outputs summed over the axis, the
    others contributing zeros).

    stage_fn(stage_params, h) -> h', applied by each stage to each
    microbatch; h' must have h's shape (activations hop between stages).
    """
    n_stages = axis_size(axis_name)
    stage = axis_index(axis_name)
    n_micro = x.shape[0]
    n_ticks = n_micro + n_stages - 1
    first = torch.tensor(stage == 0, device=x.device)
    recv = torch.zeros_like(x[0])
    banked = []
    for t in range(n_ticks):
        inp = torch.where(first, x[min(t, n_micro - 1)], recv)
        h = stage_fn(stage_params, inp)
        if t >= n_stages - 1:  # microbatch t - (n_stages - 1) leaves the last
            banked.append(h)
        if t < n_ticks - 1:
            recv = ring_permute(h, axis_name)
    outputs = torch.stack(banked)
    last = torch.tensor(stage == n_stages - 1, device=x.device)
    return allreduce(torch.where(last, outputs, torch.zeros_like(outputs)),
                     axis_name)


def stack_stage_params(params_per_layer, n_stages: int):
    """[L, ...] stacked layer params → [pp, L//pp, ...] for sharding over
    pp."""
    def reshape(p):
        L = p.shape[0]
        if L % n_stages != 0:
            raise ValueError(f"{L} layers not divisible by {n_stages} stages")
        return p.reshape(n_stages, L // n_stages, *p.shape[1:])

    return tree_map(reshape, params_per_layer)
