"""Llama-3 family configs (own copy of ray_tpu/models/llama.py's table)."""

from __future__ import annotations

import torch

from ray_tpu_torch.models.transformer import TransformerConfig

SIZES = {
    # (d_model, layers, heads, kv_heads, d_ff)
    "tiny": dict(d_model=256, n_layers=4, n_heads=8, n_kv_heads=4, d_ff=688),
    "1b": dict(d_model=2048, n_layers=16, n_heads=32, n_kv_heads=8, d_ff=8192),
    "3b": dict(d_model=3072, n_layers=28, n_heads=24, n_kv_heads=8, d_ff=8192),
    "8b": dict(d_model=4096, n_layers=32, n_heads=32, n_kv_heads=8, d_ff=14336),
    "70b": dict(d_model=8192, n_layers=80, n_heads=64, n_kv_heads=8, d_ff=28672),
}


def llama_config(size: str = "8b", *, vocab_size: int = 128256,
                 max_seq_len: int = 8192, dtype=torch.bfloat16,
                 **overrides) -> TransformerConfig:
    base = dict(SIZES[size])
    base.update(
        vocab_size=vocab_size,
        max_seq_len=max_seq_len,
        norm="rms",
        act="swiglu",
        pos="rope",
        rope_theta=500000.0,
        bias=False,
        tie_embeddings=False,
        dtype=dtype,
    )
    base.update(overrides)
    return TransformerConfig(**base)
