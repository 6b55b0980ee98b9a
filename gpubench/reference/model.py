"""The published models' layers in plain float32 PyTorch.

Mixtral-8x7B (arXiv:2401.04088, the model card's config.json): pre-norm
RMSNorm (eps from the config, or the port's where the config says the
reference follows it), rotary positions in the half-rotation
layout (theta 1e6), grouped-query attention (32 query heads over 8 kv
heads), a SwiGLU mixture of 8 experts of which each token takes the top 2
by softmax probability with the two gates renormalised, and an untied
head. Ties between equal probabilities go to the lower expert index. No
token is dropped.

GPT-2 (Radford et al. 2019, config.json): pre-norm LayerNorm, learned
positions, biases on every projection, the tanh approximation of GELU
("gelu_new"), and the head tied to the token embedding.

Every function takes one layer's params as float32 tensors in the layout
of ``gpubench/weights.py`` and a matmul (``lowp.matmul``), so the control
runs the same code in float8.
"""

from __future__ import annotations

import math

from gpubench.weights import dims

# query heads attended at once: bounds the float32 scores to
# HEAD_CHUNK x T x T per sequence
HEAD_CHUNK = 8


class Spec:
    """What the layers need from a configuration file. A departure of the
    port that the file lists under ``follows_port`` (Mixtral's RMSNorm
    eps) is followed, unless `published`."""

    def __init__(self, cfg: dict, published: bool = False):
        d = dims(cfg)
        self.E, self.L, self.H, self.Hkv, self.Dh = (d[k] for k in
                                                     ("E", "L", "H", "Hkv",
                                                      "Dh"))
        self.F, self.V, self.X, self.k = d["F"], d["V"], d["X"], d["k"]
        arch = cfg["architecture"]
        follows = {} if published else cfg.get("follows_port", {})
        self.norm = arch["norm"]
        self.eps = follows.get("norm_eps", arch["norm_eps"])
        self.bias, self.positions = arch["bias"], arch["positions"]
        self.rope_theta = cfg.get("rope_theta")
        self.tied = cfg["tie_word_embeddings"]


def norm(torch, x, p, spec: Spec):
    if spec.norm == "rmsnorm":
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True)
                               + spec.eps) * p["w"]
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + spec.eps) * p["w"] + p["b"]


def gelu_new(torch, x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x.pow(3))))


def rope(torch, x, theta: float):
    """x [B, T, H, Dh] at positions 0..T-1, half-rotation layout."""
    T, Dh = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, Dh, 2, dtype=torch.float64,
                                       device=x.device) / Dh)
    ang = torch.outer(torch.arange(T, dtype=torch.float64,
                                   device=x.device), inv)
    cos = ang.cos().float()[None, :, None, :]
    sin = ang.sin().float()[None, :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def causal_attention(torch, q, k, v):
    """q [B, T, H, Dh], k/v [B, T, Hkv, Dh] → [B, T, H, Dh]; query head h
    reads kv head h // (H / Hkv)."""
    B, T, H, Dh = q.shape
    G = H // k.shape[2]
    mask = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    outs = []
    for h0 in range(0, H, HEAD_CHUNK):
        hs = range(h0, min(h0 + HEAD_CHUNK, H))
        qh = q[:, :, h0:hs[-1] + 1].transpose(1, 2)          # [B, h, T, Dh]
        idx = torch.tensor([h // G for h in hs], device=q.device)
        kh = k.index_select(2, idx).transpose(1, 2)
        vh = v.index_select(2, idx).transpose(1, 2)
        s = (qh @ kh.transpose(-1, -2)) * Dh ** -0.5
        s = s.masked_fill(~mask, float("-inf"))
        outs.append(torch.softmax(s, dim=-1) @ vh)
    return torch.cat(outs, dim=1).transpose(1, 2)


def attention_block(torch, x, p, spec: Spec, mm):
    B, T, E = x.shape
    H, Hkv, Dh = spec.H, spec.Hkv, spec.Dh
    q = mm(x, p["wq"].reshape(E, H * Dh)).reshape(B, T, H, Dh)
    k = mm(x, p["wk"].reshape(E, Hkv * Dh)).reshape(B, T, Hkv, Dh)
    v = mm(x, p["wv"].reshape(E, Hkv * Dh)).reshape(B, T, Hkv, Dh)
    if spec.bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if spec.positions == "rope":
        q, k = rope(torch, q, spec.rope_theta), rope(torch, k, spec.rope_theta)
    o = causal_attention(torch, q, k, v).reshape(B, T, H * Dh)
    out = mm(o, p["wo"].reshape(H * Dh, E))
    return out + p["bo"] if spec.bias else out


def experts_block(torch, x, p, spec: Spec, mm, margins=None):
    """Dropless top-k routing: every token's k experts, gates renormalised.
    With a list `margins`, appends each token's log-probability margin
    between its k-th expert and the next: how near its choice is a tie."""
    B, T, E = x.shape
    h = x.reshape(B * T, E)
    probs = torch.softmax(mm(h, p["router"]), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    if margins is not None:
        margins.append((vals[:, spec.k - 1].log() - vals[:, spec.k].log())
                       .reshape(B, T))
    gates = vals[:, :spec.k] / vals[:, :spec.k].sum(-1, keepdim=True)
    idx = idx[:, :spec.k]
    out = torch.zeros_like(h)
    for e in range(spec.X):
        rows, slot = (idx == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        he = h[rows]
        y = mm(torch.nn.functional.silu(mm(he, p["gate"][e]))
               * mm(he, p["up"][e]), p["down"][e])
        out.index_add_(0, rows, y * gates[rows, slot][:, None])
    return out.reshape(B, T, E)


def dense_block(torch, x, p, spec: Spec, mm):
    h = mm(x, p["wi"])
    if spec.bias:
        h = h + p["bi"]
    out = mm(gelu_new(torch, h), p["wo"])
    return out + p["bo"] if spec.bias else out


def layer(torch, x, lp: dict, spec: Spec, mm, margins=None):
    """One pre-norm block on x [B, T, E]."""
    x = x + attention_block(torch, norm(torch, x, lp["norm1"], spec),
                            lp["attn"], spec, mm)
    h = norm(torch, x, lp["norm2"], spec)
    if spec.X:
        return x + experts_block(torch, h, lp["mlp"], spec, mm, margins)
    return x + dense_block(torch, h, lp["mlp"], spec, mm)


def embed(torch, params, tokens, spec: Spec):
    """tokens [B, T] → float32 [B, T, E]."""
    x = params["embed"].float()[tokens]
    if spec.positions == "learned":
        x = x + params["pos_embed"].float()[:tokens.shape[1]]
    return x


def head(torch, x, params, spec: Spec, mm):
    x = norm(torch, x, {k: v.float() for k, v in params["final_norm"].items()},
             spec)
    w = params["embed"].float().T if spec.tied else params["lm_head"].float()
    return mm(x, w)


def layer_params(params: dict, i: int) -> dict:
    """Layer i's params, as float32 (a copy for the served types)."""
    return {blk: {k: v[i].float() for k, v in leaves.items()}
            for blk, leaves in params["layers"].items()}
