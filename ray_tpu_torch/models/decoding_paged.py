"""Paged KV-cache decoding, the twin of ray_tpu/models/decoding_paged.py.

The pool is [L, num_pages, page, Hkv, Dh]; each slot owns the pages its
block table names, and page 0 is reserved scratch (the engine never grants
it), so inactive rows can write there harmlessly. Page allocation is host
bookkeeping in the engine.

Unlike the JAX functions, which donate and return a new state, these update
`state` in place (PyTorch has no donation, and copying a 2 GB pool per step
would double its memory): the per-step K/V scatter is an ``index_put_``
into the pool, and insertion writes the granted pages directly.

``decode_step_paged_ragged`` is the serving path: its attention core is one
ragged launch per layer (ops/ragged_paged_attention.py — the Hopper kernel
on the card). ``decode_step_paged`` keeps the full-table gather with a
masked softmax as a second oracle.
"""

from __future__ import annotations

import torch

from ray_tpu_torch import ops
from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.decoding import _mlp_block
from ray_tpu_torch.models.transformer import (
    TransformerConfig, _attn_out, _attn_qkv, _norm, lm_logits, rope_tables,
    unstack_layers)


def init_paged_state(cfg: TransformerConfig, max_slots: int, max_len: int,
                     num_pages: int, page_size: int, device=None) -> dict:
    """Page pool + block tables. `num_pages * page_size` is the total token
    capacity shared by all slots (oversubscribable vs max_slots*max_len)."""
    device = resolve_device(device)
    L, Hkv, Dh = cfg.n_layers, cfg.kv_heads, cfg.head_dim
    max_pages_per_seq = (max_len + page_size - 1) // page_size
    i32 = dict(dtype=torch.int32, device=device)
    return {
        "kp": torch.zeros((L, num_pages, page_size, Hkv, Dh), dtype=cfg.dtype,
                          device=device),
        "vp": torch.zeros((L, num_pages, page_size, Hkv, Dh), dtype=cfg.dtype,
                          device=device),
        # page ids per slot; unused entries point at page 0 (masked anyway)
        "block": torch.zeros((max_slots, max_pages_per_seq), **i32),
        "length": torch.zeros((max_slots,), **i32),
        "last_token": torch.zeros((max_slots,), **i32),
        "active": torch.zeros((max_slots,), dtype=torch.bool, device=device),
    }


@torch.no_grad()
def insert_sequence_paged(state, slot: int, kv, length: int, first_token,
                          pages, cfg: TransformerConfig) -> dict:
    """Write a prefilled [L, T, Hkv, Dh] KV into the first T/page_size of
    this slot's `pages` ([max_pages_per_seq] page ids, padded with 0 — the
    engine grants every page the sequence will need up front) and activate
    the row. In place."""
    P = state["kp"].shape[2]
    L, T, Hkv, Dh = kv["k"].shape
    n = T // P
    pages = torch.as_tensor(pages, dtype=torch.int32, device=state["kp"].device)
    idx = pages[:n].long()
    state["kp"][:, idx] = kv["k"].reshape(L, n, P, Hkv, Dh).to(state["kp"].dtype)
    state["vp"][:, idx] = kv["v"].reshape(L, n, P, Hkv, Dh).to(state["vp"].dtype)
    state["block"][slot] = pages
    state["length"][slot] = int(length)
    state["last_token"][slot] = torch.as_tensor(first_token).to(torch.int32)
    state["active"][slot] = True
    return state


def _step_inputs(state, cfg):
    """Each row's position and this step's K/V write target (page, offset)."""
    P = state["kp"].shape[2]
    pos = state["length"]                                      # [B]
    page_ids = torch.gather(state["block"], 1,
                            (pos // P).long()[:, None])[:, 0]  # [B]
    # inactive rows scatter into page 0 — reserved scratch
    page_ids = torch.where(state["active"], page_ids,
                           torch.zeros_like(page_ids)).long()
    offsets = (pos % P).long()
    return pos, page_ids, offsets


def _embed_step(params, state, cfg):
    dt = cfg.dtype
    x = params["embed"].to(dt)[state["last_token"].long()[:, None]]
    if cfg.pos == "learned":
        x = x + params["pos_embed"].to(dt)[state["length"].long()][:, None]
    return x


def _finish_step(params, state, x, cfg):
    x = _norm(x, params["final_norm"], cfg)
    logits = lm_logits(x[:, 0], params, cfg)
    state["length"] += state["active"].to(torch.int32)
    return state, logits.float()


@torch.no_grad()
def decode_step_paged_ragged(params, state, cfg: TransformerConfig,
                             pages_bound: int, *, impl: str | None = None):
    """Advance every active row one token — ragged paged attention.

    The per-step K/V scatter is in place (``index_put_`` into the pool);
    the attention core is ONE ragged launch per layer over the batch's
    block tables sliced to `pages_bound` — the engine's host-side bound on
    the batch's live page count. impl: None → the Hopper kernel on CUDA and
    the plain version on the CPU; "reference" → the plain version.
    Returns (state, logits [B, V] f32).
    """
    dt = cfg.dtype
    B = state["block"].shape[0]
    pos, page_ids, offsets = _step_inputs(state, cfg)
    tbl = state["block"][:, :pages_bound]
    x = _embed_step(params, state, cfg)
    cos, sin = rope_tables(cfg, x.device)
    G = cfg.n_heads // cfg.kv_heads
    positions = pos.long()[:, None]
    for i, lp in enumerate(unstack_layers(params)):
        kp, vp = state["kp"][i], state["vp"][i]  # views into the pool
        q, k, v = _attn_qkv(_norm(x, lp["norm1"], cfg), lp["attn"], cfg)
        if cfg.pos == "rope":
            q = ops.apply_rope(q, cos, sin, positions=positions)
            k = ops.apply_rope(k, cos, sin, positions=positions)
        kp.index_put_((page_ids, offsets), k[:, 0].to(kp.dtype))
        vp.index_put_((page_ids, offsets), v[:, 0].to(vp.dtype))
        qh = q[:, 0].reshape(B, cfg.kv_heads, G, cfg.head_dim)
        out = ops.ragged_decode_attention(
            qh, kp, vp, tbl, pos, scale=cfg.head_dim ** -0.5, impl=impl)
        out = out.reshape(B, 1, cfg.n_heads, cfg.head_dim).to(dt)
        x = x + _attn_out(out, lp["attn"], cfg)
        x = x + _mlp_block(_norm(x, lp["norm2"], cfg), lp, cfg)
    return _finish_step(params, state, x, cfg)


@torch.no_grad()
def decode_step_paged(params, state, cfg: TransformerConfig):
    """Advance every active row one token against its paged cache: gather
    each row's full block table and run a masked softmax (the second
    oracle for the ragged path)."""
    dt = cfg.dtype
    B, MP = state["block"].shape
    P = state["kp"].shape[2]
    S = MP * P
    pos, page_ids, offsets = _step_inputs(state, cfg)
    x = _embed_step(params, state, cfg)
    cos, sin = rope_tables(cfg, x.device)
    G = cfg.n_heads // cfg.kv_heads
    positions = pos.long()[:, None]
    block = state["block"].long()
    mask = torch.arange(S, device=x.device)[None, :] <= pos[:, None]
    for i, lp in enumerate(unstack_layers(params)):
        kp, vp = state["kp"][i], state["vp"][i]
        q, k, v = _attn_qkv(_norm(x, lp["norm1"], cfg), lp["attn"], cfg)
        if cfg.pos == "rope":
            q = ops.apply_rope(q, cos, sin, positions=positions)
            k = ops.apply_rope(k, cos, sin, positions=positions)
        kp.index_put_((page_ids, offsets), k[:, 0].to(kp.dtype))
        vp.index_put_((page_ids, offsets), v[:, 0].to(vp.dtype))
        k_cache = kp[block].reshape(B, S, cfg.kv_heads, cfg.head_dim)
        v_cache = vp[block].reshape(B, S, cfg.kv_heads, cfg.head_dim)
        qh = q[:, 0].reshape(B, cfg.kv_heads, G, cfg.head_dim)
        scores = torch.einsum("bkgd,bskd->bkgs", qh,
                              k_cache.to(dt)) / (cfg.head_dim ** 0.5)
        scores = torch.where(mask[:, None, None, :], scores.float(),
                             torch.full_like(scores, -1e30, dtype=torch.float32))
        w = torch.softmax(scores, dim=-1).to(dt)
        out = torch.einsum("bkgs,bskd->bkgd", w, v_cache.to(dt))
        out = out.reshape(B, 1, cfg.n_heads, cfg.head_dim)
        x = x + _attn_out(out, lp["attn"], cfg)
        x = x + _mlp_block(_norm(x, lp["norm2"], cfg), lp, cfg)
    return _finish_step(params, state, x, cfg)


def release_slot_paged(state, slot: int) -> dict:
    state["active"][slot] = False
    state["length"][slot] = 0
    return state
