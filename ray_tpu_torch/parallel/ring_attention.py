"""Ring attention: exact attention over a sequence-sharded axis, the twin of
ray_tpu/parallel/ring_attention.py.

Blockwise attention with an online softmax; the K/V blocks rotate around
the `sp` axis (``collectives.ring_permute``), so after n hops every query
block has seen every key block. Plain PyTorch, as the JAX version is jnp
and reaches no Pallas kernel; its gradient flows back around the ring
through ring_permute's backward (the opposite shift). Each rank calls it
with q/k/v already sharded on the sequence dimension, under a mesh with
that axis (``parallel.use_mesh``); shapes are per-shard [B, T_local, H, D].
"""

from __future__ import annotations

import torch

from ray_tpu_torch.parallel.collectives import (axis_index, axis_size,
                                                ring_permute)

_NEG_INF = -1e30


def _block_attend(q, k, v, m_prev, l_prev, o_prev, mask, scale):
    """One flash-attention-style accumulation step.

    q: [B,Tq,H,D]  k,v: [B,Tk,H,D]  mask: [Tq,Tk] bool (True = attend)
    m,l: [B,H,Tq]  o: [B,Tq,H,D]
    """
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    s = torch.where(mask[None, None, :, :], s, torch.full_like(s, _NEG_INF))
    m_new = torch.maximum(m_prev, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    # rows fully masked in this block contribute exp(-1e30 - m) ≈ 0 naturally
    correction = torch.exp(m_prev - m_new)
    l_new = l_prev * correction + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v)
    o_new = o_prev * correction.transpose(1, 2)[..., None] + pv
    return m_new, l_new, o_new


def ring_attention(q, k, v, *, axis_name: str, causal: bool = True,
                   scale: float | None = None):
    """Exact (optionally causal) attention with KV rotating around
    `axis_name`.

    Per-shard inputs [B, T, H, D]; K/V heads must already match Q heads
    (repeat GQA KV heads before sharding). Returns per-shard [B, T, H, D].
    """
    B, T, H, D = q.shape
    if scale is None:
        scale = D ** -0.5
    n = axis_size(axis_name)
    my = axis_index(axis_name)
    dev = q.device
    q_pos = my * T + torch.arange(T, device=dev)

    qf = q.float()
    m = torch.full((B, H, T), _NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, T), dtype=torch.float32, device=dev)
    o = torch.zeros((B, T, H, D), dtype=torch.float32, device=dev)
    k_cur, v_cur = k, v
    for idx in range(n):
        src = (my - idx) % n  # which shard's KV block we currently hold
        k_pos = src * T + torch.arange(T, device=dev)
        if causal:
            mask = q_pos[:, None] >= k_pos[None, :]
        else:
            mask = torch.ones((T, T), dtype=torch.bool, device=dev)
        m, l, o = _block_attend(qf, k_cur.float(), v_cur.float(), m, l, o,
                                mask, scale)
        if idx < n - 1:  # the JAX scan's n-th hop only returns KV home
            k_cur = ring_permute(k_cur, axis_name)
            v_cur = ring_permute(v_cur, axis_name)
    out = o / l.clamp_min(1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype)


def reference_attention(q, k, v, *, causal: bool = True,
                        scale: float | None = None):
    """Unsharded reference: q, k, v [B, T, H, D] with equal head counts,
    computed in f32 with a dense score tensor."""
    B, T, H, D = q.shape
    if scale is None:
        scale = D ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o.to(q.dtype)
