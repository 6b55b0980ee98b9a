"""Decoder-only transformer core shared by the GPT-2, Llama and Mixtral
families, the twin of ray_tpu/models/transformer.py.

Params are a dict tree with the JAX package's names and layouts, layers
stacked on dim 0: ``wq [L,E,H,Dh]``, ``wk/wv [L,E,Hkv,Dh]``, ``wo [L,H,Dh,E]``,
``wi_gate/wi_up [L,E,F]``, mlp ``wo [L,F,E]``, norms ``{"w": [L,E]}``,
``embed [V,E]``, ``lm_head [E,V]``; with ``cfg.moe`` the mlp is a router
``[L,E,X]`` and the experts' stacked ``gate/up [L,X,E,F]`` and
``down [L,X,F,E]`` (ops/moe.py routes each token to its top-k experts).
Compute runs in ``cfg.dtype`` with f32 norms, softmax and routing, casting
weights at each use as the JAX code does (a no-op when they are already
stored in ``cfg.dtype``).

``forward`` takes the stacked leaves apart once per call (``torch.unbind``,
whose backward is one stack) and returns the logits and the layers' summed
MoE aux loss. Training: ``loss_fn`` is the next-token loss plus
``aux_coef * aux / n_layers`` for MoE; with ``cfg.remat`` the layers run
under non-reentrant ``torch.utils.checkpoint`` as ``remat_policy`` says,
the counterpart of the JAX package's ``jax.checkpoint`` policies.

Multi-device (parallel/): ``logical_axes`` names each leaf's dimensions
for the rule tables. The blocks are tensor- and expert-parallel by the
shapes they are given: a rank holding a contiguous slice of the heads
(with tp | n_kv_heads, q head h keeps its kv head h // G on the same
rank), of the mlp hidden dim, of the experts or of the vocabulary computes
its partial and sums it over the axis the rules put that dimension on
(``allreduce`` after the row-parallel ``wo`` projections and the expert
outputs, a masked lookup for a vocab-sharded embedding), under the mesh
made current by ``parallel.use_mesh``. With full shapes the blocks are the
unsharded code, and need no mesh. ``sp_axis`` runs ring attention over a
sequence-sharded axis with positions offset by the shard's start.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ray_tpu_torch import ops
from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.parallel import collectives
from ray_tpu_torch.parallel.mesh import (DEFAULT_RULES, checkpoint_context,
                                         current_batch_axes)

# the mesh axes the rule tables put the split dimensions on
_HEADS_AXIS = DEFAULT_RULES.params["heads"]
_MLP_AXIS = DEFAULT_RULES.params["mlp"]
_VOCAB_AXIS = DEFAULT_RULES.params["vocab"]
_EXPERT_AXIS = DEFAULT_RULES.params["expert"]

REMAT_POLICIES = ("nothing", "dots", "pairs")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    aux_coef: float = 0.01


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int | None = None          # None → MHA
    d_head: int | None = None              # None → d_model // n_heads
    d_ff: int = 2048
    norm: str = "rms"                      # "rms" | "ln"
    act: str = "swiglu"                    # "swiglu" | "gelu"
    pos: str = "rope"                      # "rope" | "learned"
    rope_theta: float = 10000.0
    max_seq_len: int = 2048
    tie_embeddings: bool = False
    bias: bool = False                     # attn/mlp biases (GPT-2 style)
    moe: MoEConfig | None = None
    remat: bool = True                     # checkpoint layers (memory for FLOPs)
    remat_policy: str = "nothing"          # "nothing" | "dots" (save matmul
                                           # outputs) | "pairs" (every other layer)
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy must be one of {REMAT_POLICIES}, "
                             f"got {self.remat_policy!r}")

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    def num_params(self) -> int:
        def count(tree):
            if isinstance(tree, dict):
                return sum(count(v) for v in tree.values())
            return math.prod(tree)
        return count(param_shapes(self))


# ------------------------------------------------------------------ init

def param_shapes(cfg: TransformerConfig) -> dict:
    """The param tree's shapes (same tree as the JAX package's init)."""
    L, E, F, V = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size
    H, Hkv, Dh = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    norm = {"w": (L, E)} if cfg.norm == "rms" else {"w": (L, E), "b": (L, E)}
    attn = {"wq": (L, E, H, Dh), "wk": (L, E, Hkv, Dh), "wv": (L, E, Hkv, Dh),
            "wo": (L, H, Dh, E)}
    if cfg.bias:
        attn.update(bq=(L, H, Dh), bk=(L, Hkv, Dh), bv=(L, Hkv, Dh), bo=(L, E))
    if cfg.moe:
        X = cfg.moe.num_experts
        mlp = {"router": (L, E, X), "gate": (L, X, E, F), "up": (L, X, E, F),
               "down": (L, X, F, E)}
    elif cfg.act == "swiglu":
        mlp = {"wi_gate": (L, E, F), "wi_up": (L, E, F), "wo": (L, F, E)}
    else:
        mlp = {"wi": (L, E, F), "wo": (L, F, E)}
        if cfg.bias:
            mlp.update(bi=(L, F), bo=(L, E))
    final = {"w": (E,)} if cfg.norm == "rms" else {"w": (E,), "b": (E,)}
    out = {"embed": (V, E),
           "layers": {"norm1": norm, "attn": attn, "norm2": dict(norm),
                      "mlp": mlp},
           "final_norm": final}
    if cfg.pos == "learned":
        out["pos_embed"] = (cfg.max_seq_len, E)
    if not cfg.tie_embeddings:
        out["lm_head"] = (E, V)
    return out


def _init_std(path: tuple, cfg: TransformerConfig) -> float | None:
    """Normal std of a leaf (the JAX init's), or None for ones/zeros."""
    if any(k in ("norm1", "norm2", "final_norm") for k in path) \
            or path[-1] in ("bq", "bk", "bv", "bo", "bi"):
        return None
    if path[-1] in ("wo", "down"):
        return 0.02 / math.sqrt(2 * cfg.n_layers)
    return 0.02


def init(generator: torch.Generator, cfg: TransformerConfig, device=None,
         dtype: torch.dtype | None = None) -> dict:
    """Random params drawn on `device` (no host round trip: an 8B model is
    drawn in seconds on the card). `dtype` defaults to cfg.param_dtype;
    serving passes cfg.dtype to store the weights once in the compute type."""
    return draw(generator, param_shapes(cfg), lambda path: _init_std(path, cfg),
                resolve_device(device), dtype or cfg.param_dtype)


def draw(generator: torch.Generator, shapes: dict, std_of, device,
         dtype: torch.dtype) -> dict:
    """A param tree of `shapes` drawn on `device`: normal with std
    ``std_of(path)``, or ones for norm weights ("w") and zeros for the rest
    where it is None."""
    def build(tree, path):
        if isinstance(tree, dict):
            return {k: build(v, path + (k,)) for k, v in tree.items()}
        std = std_of(path)
        if std is None:
            fill = 1.0 if path[-1] == "w" else 0.0
            return torch.full(tree, fill, dtype=dtype, device=device)
        x = torch.randn(tree, generator=generator, dtype=dtype, device=device)
        return x.mul_(std)

    return build(shapes, ())


def logical_axes(cfg: TransformerConfig) -> dict:
    """Same tree as init(), leaves = tuples of logical dim names (the JAX
    package's); stacked layer params get a leading 'layers' dim."""
    norm = {"w": ("embed",)} if cfg.norm == "rms" else \
        {"w": ("embed",), "b": ("embed",)}
    attn = {"wq": ("embed", "heads", "head_dim"),
            "wk": ("embed", "kv_heads", "head_dim"),
            "wv": ("embed", "kv_heads", "head_dim"),
            "wo": ("heads", "head_dim", "embed")}
    if cfg.bias:
        attn.update(bq=("heads", "head_dim"), bk=("kv_heads", "head_dim"),
                    bv=("kv_heads", "head_dim"), bo=("embed",))
    if cfg.moe:
        mlp = {"router": ("embed", None), "gate": ("expert", "embed", "mlp"),
               "up": ("expert", "embed", "mlp"),
               "down": ("expert", "mlp", "embed")}
    elif cfg.act == "swiglu":
        mlp = {"wi_gate": ("embed", "mlp"), "wi_up": ("embed", "mlp"),
               "wo": ("mlp", "embed")}
    else:
        mlp = {"wi": ("embed", "mlp"), "wo": ("mlp", "embed")}
        if cfg.bias:
            mlp.update(bi=("mlp",), bo=("embed",))
    layer = {"norm1": norm, "attn": attn, "norm2": dict(norm), "mlp": mlp}
    stacked = {k: {n: ("layers",) + t for n, t in v.items()}
               for k, v in layer.items()}
    out = {"embed": ("vocab", "embed"), "layers": stacked,
           "final_norm": dict(norm)}
    if cfg.pos == "learned":
        out["pos_embed"] = (None, "embed")
    if not cfg.tie_embeddings:
        out["lm_head"] = ("embed", "vocab")
    return out


# ----------------------------------------------------------------- apply

def _norm(x, p, cfg):
    if cfg.norm == "rms":
        return ops.rms_norm(x, p["w"])
    return ops.layer_norm(x, p["w"], p.get("b"))


def _proj_in(x, w, dt):
    """einsum("bte,ehd->bthd") as one matmul on the flattened weight."""
    E = w.shape[0]
    return (x @ w.to(dt).reshape(E, -1)).unflatten(-1, w.shape[1:])


def _proj_out(o, w, dt):
    """einsum("bthd,hde->bte") as one matmul on the flattened weight."""
    return o.flatten(-2) @ w.to(dt).reshape(-1, w.shape[-1])


def _attn_qkv(x, p, cfg):
    """QKV projections [B, T, E] → q [B,T,H,Dh], k/v [B,T,Hkv,Dh]."""
    dt = cfg.dtype
    q = _proj_in(x, p["wq"], dt)
    k = _proj_in(x, p["wk"], dt)
    v = _proj_in(x, p["wv"], dt)
    if cfg.bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    return q, k, v


def _attn_out(out, p, cfg):
    """Attention output projection [B, T, H, Dh] → [B, T, E]; a rank with a
    slice of the heads sums its partial over the heads' axis before the
    (replicated) bias."""
    out = _proj_out(out, p["wo"], cfg.dtype)
    if p["wo"].shape[0] < cfg.n_heads:
        out = collectives.allreduce(out, _HEADS_AXIS)
    if cfg.bias:
        out = out + p["bo"].to(cfg.dtype)
    return out


def _attn_block(x, p, cfg, cos, sin, attn_impl, positions=None,
                sp_axis=None):
    q, k, v = _attn_qkv(x, p, cfg)
    if cfg.pos == "rope":
        q = ops.apply_rope(q, cos, sin, positions=positions)
        k = ops.apply_rope(k, cos, sin, positions=positions)
    return _attn_out(ops.attention(q, k, v, causal=True, sp_axis=sp_axis,
                                   impl=attn_impl), p, cfg)


def _dense_mlp(x, p, cfg):
    dt = cfg.dtype
    if cfg.act == "swiglu":
        h = ops.swiglu(x @ p["wi_gate"].to(dt), x @ p["wi_up"].to(dt))
    else:
        h = x @ p["wi"].to(dt)
        if cfg.bias:
            h = h + p["bi"].to(dt)
        h = ops.gelu(h)
    out = h @ p["wo"].to(dt)
    if p["wo"].shape[0] < cfg.d_ff:  # a slice of the hidden dim: partial
        out = collectives.allreduce(out, _MLP_AXIS)
    if cfg.bias and cfg.act != "swiglu":  # the swiglu mlp has no biases
        out = out + p["bo"].to(dt)
    return out


def _moe_mlp(x, p, cfg):
    """The MoE mlp on [B, T, E] → (delta [B, T, E], aux loss f32 scalar).
    Routing spans all B*T rows: they share the experts' capacity. A rank
    holding E/ep of the experts (and/or a slice of their hidden dim) runs
    its experts on the routing's columns for them and sums its partial
    output over ep (and tp); the tokens are not split over ep. When the
    current mesh splits the batch (the meshed train step), the router
    logits are gathered over those axes first, so that capacity is shared
    by the global batch as in the JAX package's gspmd program."""
    dt = cfg.dtype
    B, T, E = x.shape
    xf = x.reshape(B * T, E)
    router_logits = (xf @ p["router"].to(dt)).float()
    batch_axes = current_batch_axes()
    if batch_axes:
        router_logits = collectives.allgather(router_logits, batch_axes)
    routing = ops.topk_routing(router_logits, num_experts=cfg.moe.num_experts,
                               k=cfg.moe.top_k,
                               capacity_factor=cfg.moe.capacity_factor)
    X_loc = p["gate"].shape[0]
    if batch_axes or X_loc < cfg.moe.num_experts:
        rows = slice(None)
        if batch_axes:
            n = B * T
            rows = slice(collectives.axis_index(batch_axes) * n,
                         (collectives.axis_index(batch_axes) + 1) * n)
        lo = collectives.axis_index(_EXPERT_AXIS) * X_loc \
            if X_loc < cfg.moe.num_experts else 0
        routing = ops.RoutingInfo(
            dispatch=routing.dispatch[rows, lo:lo + X_loc],
            combine=routing.combine[rows, lo:lo + X_loc],
            aux_loss=routing.aux_loss)

    def expert_fn(pe, xe):  # every expert at once: [X, C, E] batched matmuls
        h = ops.swiglu(torch.bmm(xe, pe["gate"].to(dt)),
                       torch.bmm(xe, pe["up"].to(dt)))
        return torch.bmm(h, pe["down"].to(dt))

    expert_params = {"gate": p["gate"], "up": p["up"], "down": p["down"]}
    y = ops.moe_apply(xf, routing, expert_fn, expert_params)
    axes = tuple(a for a, split in (
        (_EXPERT_AXIS, X_loc < cfg.moe.num_experts),
        (_MLP_AXIS, p["gate"].shape[-1] < cfg.d_ff)) if split)
    if axes:
        y = collectives.allreduce(y, axes if len(axes) > 1 else axes[0])
    return y.reshape(B, T, E), routing.aux_loss


def unstack_layers(params: dict) -> list[dict]:
    """The per-layer trees of the stacked layer tree (views, no copies),
    taken apart at once: one ``torch.unbind`` per stacked leaf. Its
    backward is one stack of the L slice gradients, where L indexing views
    would each add a full-size gradient into the leaf."""
    def split(tree):
        if isinstance(tree, dict):
            parts = {k: split(v) for k, v in tree.items()}
            n = len(next(iter(parts.values())))
            return [{k: v[i] for k, v in parts.items()} for i in range(n)]
        return tree.unbind(0)
    return split(params["layers"])


def rope_tables(cfg: TransformerConfig, device):
    if cfg.pos != "rope":
        return None, None
    return ops.rope_frequencies(cfg.head_dim, cfg.max_seq_len,
                                theta=cfg.rope_theta, device=device)


def embed_tokens(params, tokens, cfg):
    """params["embed"][tokens] in cfg.dtype. A rank holding a slice of the
    vocabulary looks up the tokens in its slice, zeroes the rest and sums
    over the vocab axis (each token's row lives on one rank: exact)."""
    w = params["embed"].to(cfg.dtype)
    V_loc = w.shape[0]
    if V_loc == cfg.vocab_size:
        return w[tokens]
    local = tokens - collectives.axis_index(_VOCAB_AXIS) * V_loc
    mine = (local >= 0) & (local < V_loc)
    x = w[local.clamp(0, V_loc - 1)]
    x = torch.where(mine[..., None], x, torch.zeros_like(x))
    return collectives.allreduce(x, _VOCAB_AXIS)


def lm_logits(x, params, cfg):
    """Logits in cfg.dtype: over the whole vocabulary, or over this rank's
    vocab slice when the head is vocab-sharded (the losses take the slice:
    ``vocab_axis``/``logits_spec``)."""
    dt = cfg.dtype
    if cfg.tie_embeddings:
        return x @ params["embed"].to(dt).T
    return x @ params["lm_head"].to(dt)


def local_heads(params) -> tuple[int, int]:
    """(q heads, kv heads) of the attention weights this rank holds: the
    config's, or a tensor-parallel rank's slice of them."""
    attn = params["layers"]["attn"]
    return attn["wq"].shape[-2], attn["wk"].shape[-2]


def vocab_axis_of(params, cfg) -> str | None:
    """The mesh axis the head's vocab dim is split over, or None."""
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    V_loc = head.shape[0] if cfg.tie_embeddings else head.shape[1]
    return _VOCAB_AXIS if V_loc < cfg.vocab_size else None


def _block(x, lp, cfg, cos, sin, attn_impl, positions=None, sp_axis=None):
    """One layer: (x, its MoE aux loss, or None for a dense mlp)."""
    x = x + _attn_block(_norm(x, lp["norm1"], cfg), lp["attn"], cfg, cos, sin,
                        attn_impl, positions, sp_axis)
    normed = _norm(x, lp["norm2"], cfg)
    if cfg.moe:
        delta, aux = _moe_mlp(normed, lp["mlp"], cfg)
        return x + delta, aux
    return x + _dense_mlp(normed, lp["mlp"], cfg), None


def _save_matmuls(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of remat_policy="dots": keep the outputs
    of the 2-D matmuls (the projections and the MLP, which is what
    ``dots_with_no_batch_dims_saveable`` keeps in JAX) and recompute the
    rest."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _layer_fn(cfg: TransformerConfig, i: int):
    """Layer i's block, wrapped in a checkpoint as the remat policy says."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return _block
    if cfg.remat_policy == "pairs" and i % 2:
        return _block  # the second layer of each pair keeps its activations
    # the recompute runs under the forward's mesh (checkpoint_context)
    inner = None
    if cfg.remat_policy == "dots":
        inner = functools.partial(create_selective_checkpoint_contexts,
                                  _save_matmuls)
    return functools.partial(checkpoint, _block, use_reentrant=False,
                             context_fn=functools.partial(checkpoint_context,
                                                          inner))


def forward(params, tokens, cfg: TransformerConfig, *,
            sp_axis: str | None = None, attn_impl: str | None = None,
            return_hidden: bool = False):
    """tokens [B, T] int → (logits [B, T, V] in cfg.dtype, aux_loss); the
    aux loss (f32) is the sum of the MoE layers' load-balancing losses, 0
    for the dense stack. With return_hidden=True, returns the final-normed
    hidden states [B, T, E] instead of logits.

    With ``cfg.remat`` (and grad enabled) each layer is checkpointed as
    ``cfg.remat_policy`` says: "nothing" recomputes every layer in
    backward, "pairs" only the first layer of each pair (dense stacks
    only, as in the JAX package), "dots" every layer but its saved matmul
    outputs."""
    if cfg.remat and cfg.remat_policy == "pairs" and (cfg.n_layers % 2
                                                      or cfg.moe):
        raise ValueError(
            "remat_policy='pairs' needs an even n_layers and a dense (non-"
            "MoE) stack; falling back silently would misattribute benchmark "
            "results to selective remat")
    dt = cfg.dtype
    x = embed_tokens(params, tokens, cfg)
    T = tokens.shape[1]
    start = 0 if sp_axis is None else collectives.axis_index(sp_axis) * T
    positions = None if sp_axis is None else \
        start + torch.arange(T, device=x.device)
    if cfg.pos == "learned":
        x = x + params["pos_embed"][start:start + T].to(dt)
    cos, sin = rope_tables(cfg, x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, lp in enumerate(unstack_layers(params)):
        x, layer_aux = _layer_fn(cfg, i)(x, lp, cfg, cos, sin, attn_impl,
                                         positions, sp_axis)
        if layer_aux is not None:
            aux = aux + layer_aux
    x = _norm(x, params["final_norm"], cfg)
    if return_hidden:
        return x, aux
    return lm_logits(x, params, cfg), aux


def loss_fn(params, tokens, cfg: TransformerConfig, *,
            sp_axis: str | None = None, attn_impl: str | None = None,
            fused_ce: bool | None = None, logits_spec=None,
            ce_chunk: int | None = None):
    """Next-token LM loss on tokens [B, T + 1] (labels ``tokens[:, 1:]``,
    -100 ignored), the JAX package's rules: fused_ce (default: on for
    vocab >= 8192, and off with tied embeddings, which have no lm_head)
    streams the head matmul into a chunked cross-entropy so the [B, T, V]
    logits never exist at once. A MoE stack adds
    ``cfg.moe.aux_coef * aux / cfg.n_layers``. `logits_spec` (fused path
    only, as in the JAX package) names the vocab axis of the per-chunk
    logits; a vocab-sharded head gets P(None, "tp") without it, and the
    unfused loss takes its vocab slice the same way."""
    if fused_ce is None:
        fused_ce = cfg.vocab_size >= 8192
    fused_ce = fused_ce and not cfg.tie_embeddings
    if logits_spec is not None and not fused_ce:
        raise ValueError(
            "logits_spec requires the fused-CE path (untied embeddings and "
            "fused_ce enabled)")
    vocab_axis = vocab_axis_of(params, cfg)
    labels = tokens[:, 1:]
    if fused_ce:
        hidden, aux = forward(params, tokens[:, :-1], cfg, sp_axis=sp_axis,
                              attn_impl=attn_impl, return_hidden=True)
        B, T, E = hidden.shape
        if logits_spec is None and vocab_axis is not None:
            logits_spec = (None, vocab_axis)
        loss, _ = ops.fused_head_cross_entropy(
            hidden.reshape(B * T, E), params["lm_head"],
            labels.reshape(B * T), chunk=ce_chunk or 2048,
            logits_spec=logits_spec)
    else:
        logits, aux = forward(params, tokens[:, :-1], cfg, sp_axis=sp_axis,
                              attn_impl=attn_impl)
        loss, _ = ops.softmax_cross_entropy(logits, labels,
                                            vocab_axis=vocab_axis)
    if cfg.moe:
        loss = loss + cfg.moe.aux_coef * aux / cfg.n_layers
    return loss
