"""Mixture-of-experts routing: token-choice top-k with capacity (GShard
style), the twin of ray_tpu/ops/moe.py.

Dense products over one-hot dispatch tensors with static shapes, as in the
JAX package: the [N, E, C] dispatch and combine tensors gather each
expert's tokens into a [E, C, D] batch and scatter the results back. The
JAX package leaves these products and the experts' matmuls to XLA (no
Pallas kernel), so here they are library matmuls too.

The arithmetic is the JAX code's step for step. One difference in means:
``jax.lax.top_k`` puts the lower index first among equal values and
``torch.topk`` does not promise to, so the top k come from a stable
descending sort. Router logits are computed in bf16, where ties are not
rare.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class RoutingInfo(NamedTuple):
    dispatch: torch.Tensor    # [N, E, C] one-hot dispatch mask, f32
    combine: torch.Tensor     # [N, E, C] combine weights (gate-scaled), f32
    aux_loss: torch.Tensor    # load-balancing loss (f32 scalar)


def topk_routing(router_logits, *, num_experts: int, k: int,
                 capacity_factor: float = 1.25) -> RoutingInfo:
    """router_logits: [N, E] (N = flattened tokens). Top-k token-choice
    routing with per-expert capacity C = ceil(k * N / E * capacity_factor);
    tokens over capacity are dropped (their combine weights are zero).
    Capacity is shared by all N rows of the call."""
    N, E = router_logits.shape
    if E != num_experts:
        raise ValueError(f"router logits have {E} experts, expected "
                         f"{num_experts}")
    capacity = int(max(k * N / E * capacity_factor, 1.0) + 0.9999)

    probs = torch.softmax(router_logits.float(), dim=-1)               # [N, E]
    # the k largest, lower expert index first among ties (jax.lax.top_k)
    gate_vals, expert_idx = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
    gate_vals, expert_idx = gate_vals[:, :k], expert_idx[:, :k]       # [N, k]
    # renormalise the selected gates (Mixtral convention)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    # position of each (token, choice) in its expert's queue
    onehot = torch.nn.functional.one_hot(expert_idx, E).int()         # [N, k, E]
    flat = onehot.reshape(N * k, E)
    # order: token-major, choice-major — earlier tokens win capacity
    pos_in_expert = torch.cumsum(flat, dim=0) - flat                  # [N*k, E]
    pos = (pos_in_expert * flat).sum(-1).reshape(N, k)                # [N, k]
    keep = (pos < capacity).float()                                   # [N, k]
    # one-hot over the capacity slots; a position past capacity has none
    slots = torch.arange(capacity, device=pos.device)
    slot_onehot = (pos[..., None] == slots).float()                   # [N, k, C]
    # accumulate per choice: peak memory stays at the [N, E, C] output size
    dispatch = torch.zeros((N, E, capacity), dtype=torch.float32,
                           device=probs.device)
    combine = torch.zeros_like(dispatch)
    for c in range(k):
        d = (onehot[:, c].float()[:, :, None]
             * slot_onehot[:, c][:, None, :]
             * keep[:, c][:, None, None])                             # [N, E, C]
        dispatch = dispatch + d
        combine = combine + d * gate_vals[:, c][:, None, None]

    # Switch-style load-balance aux loss
    frac_tokens = onehot[:, 0].float().mean(0)  # top-1 assignment share
    frac_probs = probs.mean(0)
    aux = E * (frac_tokens * frac_probs).sum()
    return RoutingInfo(dispatch=dispatch, combine=combine, aux_loss=aux)


def moe_apply(x, routing: RoutingInfo, expert_fn: Callable, expert_params):
    """x: [N, D] → [N, D]. ``expert_fn(expert_params, xe)`` computes every
    expert at once on xe [E, C, D], its params' leaves stacked on a leading
    expert dim (a batched matmul over the stack: the counterpart of the JAX
    code's ``jax.vmap(expert_fn)``)."""
    xe = torch.einsum("nd,nec->ecd", x, routing.dispatch.to(x.dtype))  # [E, C, D]
    ye = expert_fn(expert_params, xe)                                  # [E, C, D]
    return torch.einsum("ecd,nec->nd", ye, routing.combine.to(x.dtype))
