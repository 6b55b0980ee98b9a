"""FLOPs and bytes of each operation, from its shapes and real lengths.

Sizes by short name: H query heads, Hkv kv heads, Dh head size, L layers,
E width, F feed-forward width, V vocabulary, X experts, k experts a token
takes. Activations and KV are bf16 (2 bytes), softmax statistics f32.

Causal attention over T real tokens touches T (T + 1) / 2 query-key
pairs. The forward takes two matmuls of 2 Dh FLOPs a pair and head; the
backward five (the scores again, dP, dV, dQ, dK), 2.5 times the forward.
"""

from __future__ import annotations

BF16, F32 = 2, 4


def pairs(T: int) -> int:
    return T * (T + 1) // 2


def flash_fwd(lengths, H: int, Hkv: int, Dh: int, layers: int = 1):
    """Causal forward over sequences of the given real lengths: reads q,
    k, v, writes o and the f32 log-sum-exp."""
    flops = sum(4 * Dh * H * pairs(T) for T in lengths) * layers
    nbytes = sum(T * ((2 * H + 2 * Hkv) * Dh * BF16 + H * F32)
                 for T in lengths) * layers
    return flops, nbytes


def flash_bwd(lengths, H: int, Hkv: int, Dh: int, layers: int = 1):
    """Causal backward: reads q, k, v, o, dO and the lse, writes dq, dk,
    dv and the f32 row sums delta."""
    flops = sum(10 * Dh * H * pairs(T) for T in lengths) * layers
    nbytes = sum(T * ((4 * H + 4 * Hkv) * Dh * BF16 + 2 * H * F32)
                 for T in lengths) * layers
    return flops, nbytes


def ragged_decode(contexts, H: int, Hkv: int, Dh: int, layers: int):
    """One decode token per entry, attending over `c` cached tokens: reads
    its K and V pages once (Hkv heads) and q, writes o."""
    flops = sum(4 * Dh * H * c for c in contexts) * layers
    nbytes = sum(2 * c * Hkv * Dh * BF16 + 2 * H * Dh * BF16
                 for c in contexts) * layers
    return flops, nbytes


def token_matmul_flops(d: dict) -> float:
    """Forward matmul FLOPs of one token through every layer, as the
    published model routes it: the q/k/v/o projections, then the router
    and the top-k experts' SwiGLU, or the dense GELU mlp. No capacity
    padding is counted."""
    E, H, Hkv, Dh, F = d["E"], d["H"], d["Hkv"], d["Dh"], d["F"]
    attn = 2 * E * (H + 2 * Hkv) * Dh + 2 * H * Dh * E
    mlp = (2 * E * d["X"] + d["k"] * 3 * 2 * E * F) if d["X"] \
        else 2 * 2 * E * F
    return d["L"] * (attn + mlp)


def head_flops(d: dict) -> float:
    return 2 * d["E"] * d["V"]


def prefill_flops(d: dict, T: int) -> float:
    """A prompt of T real tokens, the head at its last position."""
    attn = flash_fwd([T], d["H"], d["Hkv"], d["Dh"], d["L"])[0]
    return T * token_matmul_flops(d) + attn + head_flops(d)


def decode_flops(d: dict, context: int) -> float:
    """One decoded token attending over `context` tokens."""
    attn = ragged_decode([context], d["H"], d["Hkv"], d["Dh"], d["L"])[0]
    return token_matmul_flops(d) + attn + head_flops(d)


def train_flops_per_token(n_params: int, d: dict, seq: int) -> float:
    """The port's training count (ray_tpu_torch/benchmarks/train_step.py
    flops_per_token, copied): 6 N for every param, embeddings included,
    plus 6 L S H Dh of causal attention; a remat recompute is not work."""
    return 6.0 * n_params + 6.0 * d["L"] * seq * d["H"] * d["Dh"]
