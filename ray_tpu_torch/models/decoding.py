"""KV-cache decoding, the twin of ray_tpu/models/decoding.py.

``prefill`` runs one prompt at its bucketed length and returns per-layer KV
for either cache layout, ``prefill_batch`` several prompts of one bucket
at once (the PD prefill tier). Their attention goes through
``ops.attention``: the flash kernel on the card, where every bucket is a
multiple of 64.
``_mlp_block`` is the dense mlp or, for a MoE config, the routed experts
(``transformer._mlp_block``); a MoE layer's output depends on the whole
call's rows, which share the experts' capacity: the bucket's padding at
prefill, every slot of the batch at decode.

The slot layout keeps one contiguous ``[L, slots, max_len, Hkv, Dh]`` cache
per K and V. ``decode_step`` advances every row one token and
``verify_step`` K tokens (speculative decoding), each with a masked dense
softmax over the row's cache, as the JAX functions compute it (no Pallas
kernel is on either path there). Like the paged steps, both write the
caches in place: the scheduler thread owns the state, and copying a 2 GB
cache per step would double its memory. Inactive rows sit at position 0
and write there, as in the JAX package; their logits are ignored.

LoRA: ``init_lora_bank`` holds every adapter's q/v factors, layer-major;
``prefill`` takes one adapter index, ``decode_step`` one per row (index 0
is the all-zero null adapter, so such a row computes base + 0 exactly).

Sampling takes an explicit ``torch.Generator`` on the logits' device where
the JAX code takes a PRNG key; the two give different random streams, so
only greedy decoding can match the JAX package token for token.

Tensor parallelism: every step takes its head counts from the weights
(``transformer.local_heads``), so a rank holding a slice of the heads,
with a cache (or pool) of its own kv heads as a contiguous tensor, runs
the same functions; the blocks sum their partial outputs over tp
(models/transformer.py), so every rank computes the full logits.
"""

from __future__ import annotations

import torch

from ray_tpu_torch import ops
from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models import transformer as tr
from ray_tpu_torch.models.transformer import (
    TransformerConfig, _attn_out, _dense_mlp, _moe_mlp, _norm, _proj_in,
    embed_tokens, lm_logits, local_heads, rope_tables, unstack_layers)

_NEG_INF = -1e30


def _mlp_block(normed, layer_p, cfg):
    if cfg.moe:
        delta, _aux = _moe_mlp(normed, layer_p["mlp"], cfg)
        return delta
    return _dense_mlp(normed, layer_p["mlp"], cfg)


def init_decode_state(cfg: TransformerConfig, max_slots: int, max_len: int,
                      device=None) -> dict:
    """The slot layout's state: per-layer KV + per-row bookkeeping."""
    device = resolve_device(device)
    L, Hkv, Dh = cfg.n_layers, cfg.kv_heads, cfg.head_dim
    i32 = dict(dtype=torch.int32, device=device)
    return {
        "k": torch.zeros((L, max_slots, max_len, Hkv, Dh), dtype=cfg.dtype,
                         device=device),
        "v": torch.zeros((L, max_slots, max_len, Hkv, Dh), dtype=cfg.dtype,
                         device=device),
        "length": torch.zeros((max_slots,), **i32),      # tokens in cache
        "last_token": torch.zeros((max_slots,), **i32),  # next input per row
        "active": torch.zeros((max_slots,), dtype=torch.bool, device=device),
    }


def init_lora_bank(cfg: TransformerConfig, num_adapters: int, rank: int,
                   device=None) -> dict:
    """Multi-LoRA bank: q and v factors of `num_adapters` adapters plus the
    null adapter at index 0 (all zero), layer-major ([L, N+1, ...])."""
    device = resolve_device(device)
    L, E = cfg.n_layers, cfg.d_model
    H, Hkv, Dh = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    N = num_adapters + 1
    kw = dict(dtype=cfg.dtype, device=device)
    return {
        "A_q": torch.zeros((L, N, E, rank), **kw),
        "B_q": torch.zeros((L, N, rank, H, Dh), **kw),
        "A_v": torch.zeros((L, N, E, rank), **kw),
        "B_v": torch.zeros((L, N, rank, Hkv, Dh), **kw),
        "scale": torch.zeros((N,), dtype=torch.float32, device=device),
    }


def _lora_layers(bank):
    """Per-layer (A_q, B_q, A_v, B_v) views of a bank."""
    return list(zip(*(bank[k].unbind(0) for k in ("A_q", "B_q", "A_v", "B_v"))))


def _attn_qkv(x, p, cfg, lora_l=None, lora_idx=None, lora_scale=None):
    """QKV projections; with a LoRA layer slice, plus the q/v deltas of
    adapter `lora_idx`: an int (one prefill sequence) or a [B] tensor (one
    adapter per decode row), `lora_scale` its alpha/r."""
    if lora_l is None:
        return tr._attn_qkv(x, p, cfg)
    dt = cfg.dtype
    q = _proj_in(x, p["wq"], dt)
    k = _proj_in(x, p["wk"], dt)
    v = _proj_in(x, p["wv"], dt)
    aq, bq, av, bv = lora_l
    if isinstance(lora_idx, int):  # one sequence: one adapter
        dq = _proj_in(x @ aq[lora_idx].to(dt), bq[lora_idx], dt)
        dv = _proj_in(x @ av[lora_idx].to(dt), bv[lora_idx], dt)
        s = lora_scale.to(dt)
    else:  # one adapter per row: batched gather + matmul
        dq = torch.einsum("btr,brhd->bthd", torch.einsum(
            "bte,ber->btr", x, aq[lora_idx].to(dt)), bq[lora_idx].to(dt))
        dv = torch.einsum("btr,brhd->bthd", torch.einsum(
            "bte,ber->btr", x, av[lora_idx].to(dt)), bv[lora_idx].to(dt))
        s = lora_scale.to(dt)[:, None, None, None]
    q = q + dq * s
    v = v + dv * s
    if cfg.bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    return q, k, v


@torch.no_grad()
def prefill(params, tokens, length: int, cfg: TransformerConfig, *,
            attn_impl: str | None = None, lora_bank=None,
            lora_idx: int = 0):
    """Run one prompt [1, T] (T = bucket size, padded; true length `length`).

    Returns (logits_at_last [V] f32, kv {k, v: [L, T, Hkv, Dh]}).
    attn_impl: None → the flash kernel on CUDA, the reference on the CPU;
    "reference" forces the plain dense attention (the card's oracle).
    With `lora_bank`, adds adapter `lora_idx`'s q/v deltas.
    """
    dt = cfg.dtype
    B, T = tokens.shape
    x = embed_tokens(params, tokens, cfg)
    if cfg.pos == "learned":
        x = x + params["pos_embed"][:T].to(dt)
    cos, sin = rope_tables(cfg, x.device)
    L, Hkv, Dh = cfg.n_layers, local_heads(params)[1], cfg.head_dim
    kv_k = torch.empty((L, T, Hkv, Dh), dtype=dt, device=x.device)
    kv_v = torch.empty_like(kv_k)
    loras = [None] * L if lora_bank is None else _lora_layers(lora_bank)
    lscale = None if lora_bank is None else lora_bank["scale"][lora_idx]
    for i, lp in enumerate(unstack_layers(params)):
        q, k, v = _attn_qkv(_norm(x, lp["norm1"], cfg), lp["attn"], cfg,
                            loras[i], int(lora_idx), lscale)
        if cfg.pos == "rope":
            q = ops.apply_rope(q, cos, sin)
            k = ops.apply_rope(k, cos, sin)
        out = ops.attention(q, k, v, causal=True, impl=attn_impl)
        x = x + _attn_out(out, lp["attn"], cfg)
        x = x + _mlp_block(_norm(x, lp["norm2"], cfg), lp, cfg)
        kv_k[i] = k[0]
        kv_v[i] = v[0]
    x = _norm(x, params["final_norm"], cfg)
    logits = lm_logits(x[0, length - 1], params, cfg)
    return logits.float(), {"k": kv_k, "v": kv_v}


@torch.no_grad()
def prefill_batch(params, tokens, lengths, cfg: TransformerConfig):
    """Batched prompt prefill: [B, T] tokens (one shared bucket, padded;
    true per-row lengths in `lengths` [B]).

    Returns (logits_at_last [B, V] f32, kv {k, v: [L, B, T, Hkv, Dh]}).
    The PD prefill tier's admission batching (llm/pd.py PrefillCoalescer):
    queued prompts of one bucket share one forward, whose attention is the
    flash kernel at batch B on the card. Causality keeps rows independent:
    positions past a row's length only produce KV the consumer masks.
    """
    dt = cfg.dtype
    B, T = tokens.shape
    x = embed_tokens(params, tokens, cfg)
    if cfg.pos == "learned":
        x = x + params["pos_embed"][:T].to(dt)
    cos, sin = rope_tables(cfg, x.device)
    L, Hkv, Dh = cfg.n_layers, local_heads(params)[1], cfg.head_dim
    kv_k = torch.empty((L, B, T, Hkv, Dh), dtype=dt, device=x.device)
    kv_v = torch.empty_like(kv_k)
    for i, lp in enumerate(unstack_layers(params)):
        q, k, v = _attn_qkv(_norm(x, lp["norm1"], cfg), lp["attn"], cfg)
        if cfg.pos == "rope":
            q = ops.apply_rope(q, cos, sin)
            k = ops.apply_rope(k, cos, sin)
        out = ops.attention(q, k, v, causal=True)
        x = x + _attn_out(out, lp["attn"], cfg)
        x = x + _mlp_block(_norm(x, lp["norm2"], cfg), lp, cfg)
        kv_k[i] = k
        kv_v[i] = v
    x = _norm(x, params["final_norm"], cfg)
    last = torch.as_tensor(lengths, device=x.device).long() - 1
    logits = lm_logits(x[torch.arange(B, device=x.device), last], params, cfg)
    return logits.float(), {"k": kv_k, "v": kv_v}


@torch.no_grad()
def insert_sequence(state, slot: int, kv, length: int, first_token,
                    cfg: TransformerConfig) -> dict:
    """Graft a prefilled [L, T, Hkv, Dh] KV into decode row `slot` and
    activate it. In place; positions past T are zeroed, as the JAX
    function's padded update leaves them."""
    T = kv["k"].shape[1]
    for name in ("k", "v"):
        state[name][:, slot, :T] = kv[name].to(state[name].dtype)
        state[name][:, slot, T:] = 0
    state["length"][slot] = int(length)
    state["last_token"][slot] = torch.as_tensor(first_token).to(torch.int32)
    state["active"][slot] = True
    return state


def _embed_step(params, state, cfg):
    dt = cfg.dtype
    x = embed_tokens(params, state["last_token"].long()[:, None], cfg)
    if cfg.pos == "learned":
        x = x + params["pos_embed"].to(dt)[state["length"].long()][:, None]
    return x


def _finish_step(params, state, x, cfg):
    x = _norm(x, params["final_norm"], cfg)
    logits = lm_logits(x[:, 0], params, cfg)
    state["length"] += state["active"].to(torch.int32)
    return state, logits.float()


def _cache_attention(qh, k_cache, v_cache, mask, dt, Dh):
    """Masked dense softmax of queries qh [B, K, Hkv, G, Dh] over a row's
    cache [B, S, Hkv, Dh]; mask [B, K, S]. Scores in `dt`, softmax in f32,
    as the JAX steps compute it. Returns [B, K, Hkv, G, Dh] in `dt`."""
    scores = torch.einsum("bkhgd,bshd->bhgks", qh,
                          k_cache.to(dt)) / (Dh ** 0.5)
    scores = torch.where(mask[:, None, None], scores.float(),
                         torch.full_like(scores, _NEG_INF,
                                         dtype=torch.float32))
    w = torch.softmax(scores, dim=-1).to(dt)
    return torch.einsum("bhgks,bshd->bkhgd", w, v_cache.to(dt))


@torch.no_grad()
def decode_step(params, state, cfg: TransformerConfig, lora_bank=None,
                slot_lora=None):
    """Advance every row of the slot cache one token. With `lora_bank` and
    `slot_lora` [B], each row adds its own adapter's q/v deltas in the same
    batched step. Returns (state, logits [B, V] f32)."""
    dt = cfg.dtype
    L, B, S = state["k"].shape[:3]
    pos = state["length"].long()                               # [B]
    rows = torch.arange(B, device=pos.device)
    x = _embed_step(params, state, cfg)
    cos, sin = rope_tables(cfg, x.device)
    H, Hkv = local_heads(params)
    G = H // Hkv
    mask = (torch.arange(S, device=pos.device)[None, :]
            <= pos[:, None])[:, None]                          # [B, 1, S]
    loras = [None] * L if lora_bank is None else _lora_layers(lora_bank)
    lscale = None if lora_bank is None else lora_bank["scale"][slot_lora]
    for i, lp in enumerate(unstack_layers(params)):
        kc, vc = state["k"][i], state["v"][i]  # views [B, S, Hkv, Dh]
        q, k, v = _attn_qkv(_norm(x, lp["norm1"], cfg), lp["attn"], cfg,
                            loras[i], slot_lora, lscale)
        if cfg.pos == "rope":
            q = ops.apply_rope(q, cos, sin, positions=pos[:, None])
            k = ops.apply_rope(k, cos, sin, positions=pos[:, None])
        # this step's K/V at each row's position (inactive rows: 0)
        kc.index_put_((rows, pos), k[:, 0].to(kc.dtype))
        vc.index_put_((rows, pos), v[:, 0].to(vc.dtype))
        qh = q.reshape(B, 1, Hkv, G, cfg.head_dim)
        out = _cache_attention(qh, kc, vc, mask, dt, cfg.head_dim)
        x = x + _attn_out(out.reshape(B, 1, H, cfg.head_dim), lp["attn"],
                          cfg)
        x = x + _mlp_block(_norm(x, lp["norm2"], cfg), lp, cfg)
    return _finish_step(params, state, x, cfg)


@torch.no_grad()
def verify_step(params, state, draft, cfg: TransformerConfig, K: int):
    """Speculative verification: advance every row K tokens at once.

    Inputs per row are [last_token, draft_0 .. draft_{K-2}] at positions
    len .. len+K-1; returns (state, logits [B, K, V] f32), logits[:, j]
    being the next-token distribution after input j. KV is written for all
    K inputs; `length` and `last_token` are not advanced (commit_accepted
    does that once the host knows how many drafts were accepted). Rejected
    inputs' KV lies past the committed length, where the mask hides it.

    Near the end of the cache, positions >= max_len are not written and
    their rope and learned-position lookups clamp to the last table row:
    what the JAX function's one-hot scatter and clamped gathers do.
    """
    dt = cfg.dtype
    L, B, S = state["k"].shape[:3]
    dev = state["length"].device
    draft = torch.as_tensor(draft, device=dev)
    tokens = torch.cat([state["last_token"][:, None], draft.int()], dim=1)
    pos = (state["length"].long()[:, None]
           + torch.arange(K, device=dev)[None, :])             # [B, K]
    look = pos.clamp(max=cfg.max_seq_len - 1)
    x = embed_tokens(params, tokens.long(), cfg)
    if cfg.pos == "learned":
        x = x + params["pos_embed"].to(dt)[look]
    cos, sin = rope_tables(cfg, x.device)
    H, Hkv = local_heads(params)
    G = H // Hkv
    # the in-range writes: one host sync a step, not one a layer
    sel = (pos < S).flatten().nonzero()[:, 0]
    rows_w = sel // K
    pos_w = pos.flatten()[sel]
    mask = torch.arange(S, device=dev)[None, None, :] <= pos[:, :, None]
    for i, lp in enumerate(unstack_layers(params)):
        kc, vc = state["k"][i], state["v"][i]
        q, k, v = _attn_qkv(_norm(x, lp["norm1"], cfg), lp["attn"], cfg)
        if cfg.pos == "rope":
            q = ops.apply_rope(q, cos, sin, positions=look)
            k = ops.apply_rope(k, cos, sin, positions=look)
        kc.index_put_((rows_w, pos_w),
                      k.reshape(B * K, *k.shape[2:])[sel].to(kc.dtype))
        vc.index_put_((rows_w, pos_w),
                      v.reshape(B * K, *v.shape[2:])[sel].to(vc.dtype))
        qh = q.reshape(B, K, Hkv, G, cfg.head_dim)
        out = _cache_attention(qh, kc, vc, mask, dt, cfg.head_dim)
        x = x + _attn_out(out.reshape(B, K, H, cfg.head_dim), lp["attn"],
                          cfg)
        x = x + _mlp_block(_norm(x, lp["norm2"], cfg), lp, cfg)
    x = _norm(x, params["final_norm"], cfg)
    return state, lm_logits(x, params, cfg).float()


def commit_accepted(state: dict, new_last, counts) -> dict:
    """Advance each active row by its accepted-token count (1 + accepted
    drafts) and set its new last (unverified) token. In place."""
    dev = state["length"].device
    act = state["active"]
    counts = torch.as_tensor(counts, device=dev).int()
    new_last = torch.as_tensor(new_last, device=dev).int()
    state["length"] = torch.where(act, state["length"] + counts,
                                  state["length"])
    state["last_token"] = torch.where(act, new_last, state["last_token"])
    return state


def commit_tokens(state: dict, next_tokens) -> dict:
    """Record sampled tokens as the next decode inputs (active rows only).
    Updates `state` in place (the JAX version donates its buffers)."""
    state["last_token"] = torch.where(state["active"], next_tokens.int(),
                                      state["last_token"])
    return state


def release_slot(state: dict, slot: int) -> dict:
    """Deactivate a row of either layout. In place."""
    state["active"][slot] = False
    state["length"][slot] = 0
    return state


def _categorical(logits, generator):
    """One draw per row from softmax(logits) via Gumbel-max."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=torch.float32)
    g = -torch.log(-torch.log(u.clamp_min(1e-20)))
    return torch.argmax(logits.float() + g, dim=-1).int()


def sample_per_row(logits, generator, temperatures, top_ks):
    """Row-wise temperature + top-k sampling for the decode hot loop.
    logits [B, V], temperatures [B] (0 → greedy), top_ks [B] int (0 → off)."""
    V = logits.shape[-1]
    greedy = torch.argmax(logits, dim=-1).int()
    scaled = logits / temperatures.clamp_min(1e-6)[:, None]
    # per-row k-th largest as the cutoff (k=0 → cutoff -inf, i.e. no cut)
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    idx = (top_ks.long() - 1).clamp(0, V - 1)
    kth = torch.gather(sorted_desc, 1, idx[:, None])
    kth = torch.where(top_ks[:, None] > 0, kth, torch.full_like(kth, -torch.inf))
    scaled = torch.where(scaled < kth, torch.full_like(scaled, _NEG_INF), scaled)
    sampled = _categorical(scaled, generator)
    return torch.where(temperatures <= 0.0, greedy, sampled)


def sample(logits, generator, temperature: float, top_k: int = 0):
    """Greedy when temperature == 0, else (top-k) categorical. [B, V] → [B]."""
    greedy = torch.argmax(logits, dim=-1).int()
    if temperature <= 0.0:
        return greedy
    scaled = logits / max(temperature, 1e-6)
    if top_k and top_k > 0:
        kth = torch.sort(scaled, dim=-1).values[:, -top_k][:, None]
        scaled = torch.where(scaled < kth, torch.full_like(scaled, _NEG_INF),
                             scaled)
    return _categorical(scaled, generator)
