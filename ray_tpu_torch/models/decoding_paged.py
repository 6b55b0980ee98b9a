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
masked softmax as a second oracle (the engine's ``attn_impl="gather"``).

The prefix cache and chunked prefill build on ``gather_prefix_pages`` (a
cached prefix out of the pool), ``prefill_with_prefix`` (the continuation
prefill: a masked dense softmax over prefix + causal suffix, as in the JAX
package), ``write_kv_pages`` and ``activate_slot`` (the two halves of
``insert_sequence_paged``).
"""

from __future__ import annotations

import torch

from ray_tpu_torch import ops
from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.decoding import (
    _cache_attention, _embed_step, _finish_step, _mlp_block, release_slot)
from ray_tpu_torch.models.transformer import (
    TransformerConfig, _attn_out, _attn_qkv, _norm, embed_tokens, lm_logits,
    local_heads, rope_tables, unstack_layers)


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
def write_kv_pages(state, kv, pages) -> dict:
    """Write a bucketed [L, T, Hkv, Dh] KV into the first T/page_size of
    `pages` without touching the row bookkeeping: the chunked-prefill
    building block (chunks accumulate page by page; the row activates once
    the whole prompt is resident, activate_slot). In place."""
    P = state["kp"].shape[2]
    L, T, Hkv, Dh = kv["k"].shape
    n = T // P
    idx = torch.as_tensor(pages, device=state["kp"].device)[:n].long()
    state["kp"][:, idx] = kv["k"].reshape(L, n, P, Hkv, Dh).to(state["kp"].dtype)
    state["vp"][:, idx] = kv["v"].reshape(L, n, P, Hkv, Dh).to(state["vp"].dtype)
    return state


def activate_slot(state, slot: int, block_row, length: int,
                  first_token) -> dict:
    """Turn a fully prefilled row live for decode: its block table
    ([max_pages_per_seq] page ids, 0-padded), length and first token."""
    state["block"][slot] = torch.as_tensor(block_row, dtype=torch.int32,
                                           device=state["block"].device)
    state["length"][slot] = int(length)
    state["last_token"][slot] = torch.as_tensor(first_token).to(torch.int32)
    state["active"][slot] = True
    return state


def insert_sequence_paged(state, slot: int, kv, length: int, first_token,
                          pages, cfg: TransformerConfig) -> dict:
    """Write a prefilled [L, T, Hkv, Dh] KV into the first T/page_size of
    this slot's `pages` ([max_pages_per_seq] page ids, padded with 0 — the
    engine grants every page the sequence will need up front) and activate
    the row. In place."""
    write_kv_pages(state, kv, pages)
    return activate_slot(state, slot, pages, length, first_token)


def insert_sequence_paged_prefix(state, slot: int, kv, suffix_pages,
                                 block_row, length: int, first_token,
                                 cfg: TransformerConfig) -> dict:
    """Like insert_sequence_paged, but only the suffix KV is written (the
    prefix already lives in shared cache pages): `suffix_pages` receive the
    suffix bucket, `block_row` is the whole table (shared prefix ids +
    private ids + 0-padding)."""
    write_kv_pages(state, kv, suffix_pages)
    return activate_slot(state, slot, block_row, length, first_token)


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
    H, Hkv = local_heads(params)
    G = H // Hkv
    positions = pos.long()[:, None]
    for i, lp in enumerate(unstack_layers(params)):
        kp, vp = state["kp"][i], state["vp"][i]  # views into the pool
        q, k, v = _attn_qkv(_norm(x, lp["norm1"], cfg), lp["attn"], cfg)
        if cfg.pos == "rope":
            q = ops.apply_rope(q, cos, sin, positions=positions)
            k = ops.apply_rope(k, cos, sin, positions=positions)
        kp.index_put_((page_ids, offsets), k[:, 0].to(kp.dtype))
        vp.index_put_((page_ids, offsets), v[:, 0].to(vp.dtype))
        qh = q[:, 0].reshape(B, Hkv, G, cfg.head_dim)
        out = ops.ragged_decode_attention(
            qh, kp, vp, tbl, pos, scale=cfg.head_dim ** -0.5, impl=impl)
        out = out.reshape(B, 1, H, cfg.head_dim).to(dt)
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
    H, Hkv = local_heads(params)
    G = H // Hkv
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
        k_cache = kp[block].reshape(B, S, Hkv, cfg.head_dim)
        v_cache = vp[block].reshape(B, S, Hkv, cfg.head_dim)
        qh = q[:, 0].reshape(B, Hkv, G, cfg.head_dim)
        scores = torch.einsum("bkgd,bskd->bkgs", qh,
                              k_cache.to(dt)) / (cfg.head_dim ** 0.5)
        scores = torch.where(mask[:, None, None, :], scores.float(),
                             torch.full_like(scores, -1e30, dtype=torch.float32))
        w = torch.softmax(scores, dim=-1).to(dt)
        out = torch.einsum("bkgs,bskd->bkgd", w, v_cache.to(dt))
        out = out.reshape(B, 1, H, cfg.head_dim)
        x = x + _attn_out(out, lp["attn"], cfg)
        x = x + _mlp_block(_norm(x, lp["norm2"], cfg), lp, cfg)
    return _finish_step(params, state, x, cfg)


release_slot_paged = release_slot


# --------------------------------------------------- prefix-cache support
# Cached blocks stay in the page pool and are gathered into a dense array
# for the continuation prefill, as in the JAX package (no kernel there).


def gather_prefix_pages(kp, vp, page_ids):
    """Cached prefix KV out of the pool: page_ids [n] → k, v
    [L, n*P, Hkv, Dh] (unused tail ids point at scratch page 0 and are
    masked by prefix_len)."""
    L, _, P, Hkv, Dh = kp.shape
    ids = torch.as_tensor(page_ids, device=kp.device).long()
    n = ids.shape[0]
    return (kp[:, ids].reshape(L, n * P, Hkv, Dh),
            vp[:, ids].reshape(L, n * P, Hkv, Dh))


@torch.no_grad()
def prefill_with_prefix(params, tokens, prefix_k, prefix_v, prefix_len: int,
                        length: int, cfg: TransformerConfig):
    """Continuation prefill: run only the suffix tokens [1, Ts] (padded
    bucket; true count `length`) over a cached prefix KV [L, Tp, Hkv, Dh]
    (valid first `prefix_len` positions, K already roped at its absolute
    positions) plus the causal suffix: a masked dense softmax over
    [Ts, Tp + Ts], as the JAX function computes it (the flash kernel does
    not take this mask).

    Returns (logits at the last suffix token [V] f32,
             suffix kv {k, v: [L, Ts, Hkv, Dh]}).
    """
    dt = cfg.dtype
    B, Ts = tokens.shape
    Tp = prefix_k.shape[1]
    dev = tokens.device
    # positions past the tables clamp, as the JAX gathers do
    pos = (int(prefix_len) + torch.arange(Ts, device=dev)).clamp(
        max=cfg.max_seq_len - 1)
    x = embed_tokens(params, tokens, cfg)
    if cfg.pos == "learned":
        x = x + params["pos_embed"].to(dt)[pos][None]
    cos, sin = rope_tables(cfg, x.device)
    ar_p = torch.arange(Tp, device=dev)
    ar_s = torch.arange(Ts, device=dev)
    mask = torch.cat([(ar_p[None, :] < int(prefix_len)).expand(Ts, Tp),
                      ar_s[:, None] >= ar_s[None, :]], dim=1)[None]
    H, Hkv = local_heads(params)
    G = H // Hkv
    L, Dh = cfg.n_layers, cfg.head_dim
    kv_k = torch.empty((L, Ts, Hkv, Dh), dtype=dt, device=dev)
    kv_v = torch.empty_like(kv_k)
    for i, lp in enumerate(unstack_layers(params)):
        q, k, v = _attn_qkv(_norm(x, lp["norm1"], cfg), lp["attn"], cfg)
        if cfg.pos == "rope":
            q = ops.apply_rope(q, cos, sin, positions=pos)
            k = ops.apply_rope(k, cos, sin, positions=pos)
        k_all = torch.cat([prefix_k[i][None].to(dt), k], dim=1)
        v_all = torch.cat([prefix_v[i][None].to(dt), v], dim=1)
        qh = q.reshape(B, Ts, Hkv, G, Dh)
        out = _cache_attention(qh, k_all, v_all, mask, dt, Dh)
        x = x + _attn_out(out.reshape(B, Ts, H, Dh), lp["attn"], cfg)
        x = x + _mlp_block(_norm(x, lp["norm2"], cfg), lp, cfg)
        kv_k[i] = k[0]
        kv_v[i] = v[0]
    x = _norm(x, params["final_norm"], cfg)
    logits = lm_logits(x[0, int(length) - 1], params, cfg)
    return logits.float(), {"k": kv_k, "v": kv_v}
