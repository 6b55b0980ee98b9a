"""KV-cache prefill and sampling, the twin of ray_tpu/models/decoding.py.

``prefill`` runs one prompt at its bucketed length and returns per-layer KV
for the paged pool (models/decoding_paged.py). Its attention goes through
``ops.attention``: the flash kernel on the card, where every bucket is a
multiple of 64. ``_mlp_block`` is the dense mlp or, for a MoE config, the
routed experts (``transformer._moe_mlp``); a MoE layer's output depends on
the whole call's rows, which share the experts' capacity: the bucket's
padding at prefill, every slot of the batch at decode. LoRA,
``verify_step`` and the slot-layout decode are not ported yet (ROADMAP.md
Queue 1).

Sampling takes an explicit ``torch.Generator`` on the logits' device where
the JAX code takes a PRNG key; the two give different random streams, so
only greedy decoding can match the JAX package token for token.
"""

from __future__ import annotations

import torch

from ray_tpu_torch import ops
from ray_tpu_torch.models.transformer import (
    TransformerConfig, _attn_out, _attn_qkv, _dense_mlp, _moe_mlp, _norm,
    lm_logits, rope_tables, unstack_layers)

_NEG_INF = -1e30


def _mlp_block(normed, layer_p, cfg):
    if cfg.moe:
        delta, _aux = _moe_mlp(normed, layer_p["mlp"], cfg)
        return delta
    return _dense_mlp(normed, layer_p["mlp"], cfg)


@torch.no_grad()
def prefill(params, tokens, length: int, cfg: TransformerConfig, *,
            attn_impl: str | None = None):
    """Run one prompt [1, T] (T = bucket size, padded; true length `length`).

    Returns (logits_at_last [V] f32, kv {k, v: [L, T, Hkv, Dh]}).
    attn_impl: None → the flash kernel on CUDA, the reference on the CPU;
    "reference" forces the plain dense attention (the card's oracle).
    """
    dt = cfg.dtype
    B, T = tokens.shape
    x = params["embed"].to(dt)[tokens]
    if cfg.pos == "learned":
        x = x + params["pos_embed"][:T].to(dt)
    cos, sin = rope_tables(cfg, x.device)
    L, Hkv, Dh = cfg.n_layers, cfg.kv_heads, cfg.head_dim
    kv_k = torch.empty((L, T, Hkv, Dh), dtype=dt, device=x.device)
    kv_v = torch.empty_like(kv_k)
    for i, lp in enumerate(unstack_layers(params)):
        q, k, v = _attn_qkv(_norm(x, lp["norm1"], cfg), lp["attn"], cfg)
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


def commit_tokens(state: dict, next_tokens) -> dict:
    """Record sampled tokens as the next decode inputs (active rows only).
    Updates `state` in place (the JAX version donates its buffers)."""
    state["last_token"] = torch.where(state["active"], next_tokens.int(),
                                      state["last_token"])
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
