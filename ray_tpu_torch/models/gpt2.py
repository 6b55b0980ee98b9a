"""GPT-2 family configs (own copy of ray_tpu/models/gpt2.py's table):
LayerNorm, GELU, learned positions, biases and tied embeddings."""

from __future__ import annotations

import torch

from ray_tpu_torch.models.transformer import TransformerConfig

SIZES = {
    "124m": dict(d_model=768, n_layers=12, n_heads=12, d_ff=3072),
    "350m": dict(d_model=1024, n_layers=24, n_heads=16, d_ff=4096),
    "774m": dict(d_model=1280, n_layers=36, n_heads=20, d_ff=5120),
    "1.5b": dict(d_model=1600, n_layers=48, n_heads=25, d_ff=6400),
}


def gpt2_config(size: str = "124m", *, vocab_size: int = 50257,
                max_seq_len: int = 1024, dtype=torch.bfloat16,
                **overrides) -> TransformerConfig:
    base = dict(SIZES[size])
    base.update(
        vocab_size=vocab_size,
        max_seq_len=max_seq_len,
        norm="ln",
        act="gelu",
        pos="learned",
        bias=True,
        tie_embeddings=True,
        dtype=dtype,
    )
    base.update(overrides)
    return TransformerConfig(**base)
