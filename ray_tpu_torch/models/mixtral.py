"""Mixtral MoE family configs (own copy of ray_tpu/models/mixtral.py's
table). ``SIZES["8x7b"]`` has the published widths of
mistralai/Mixtral-8x7B-v0.1: d_model 4096, 32 layers, 32 heads, 8 kv
heads, d_ff 14336, 8 experts with top-2 routing, vocab 32000, rope θ 1e6."""

from __future__ import annotations

import torch

from ray_tpu_torch.models.transformer import MoEConfig, TransformerConfig

SIZES = {
    "tiny": dict(d_model=256, n_layers=4, n_heads=8, n_kv_heads=4, d_ff=512),
    "8x7b": dict(d_model=4096, n_layers=32, n_heads=32, n_kv_heads=8, d_ff=14336),
    "8x22b": dict(d_model=6144, n_layers=56, n_heads=48, n_kv_heads=8, d_ff=16384),
}


def mixtral_config(size: str = "8x7b", *, vocab_size: int = 32000,
                   max_seq_len: int = 8192, num_experts: int = 8,
                   top_k: int = 2, dtype=torch.bfloat16,
                   **overrides) -> TransformerConfig:
    base = dict(SIZES[size])
    base.update(
        vocab_size=vocab_size,
        max_seq_len=max_seq_len,
        norm="rms",
        act="swiglu",
        pos="rope",
        rope_theta=1000000.0,
        bias=False,
        tie_embeddings=False,
        moe=MoEConfig(num_experts=num_experts, top_k=top_k),
        dtype=dtype,
    )
    base.update(overrides)
    return TransformerConfig(**base)
