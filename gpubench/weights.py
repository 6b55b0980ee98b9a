"""Weights made from the run's seed, in the port's param layout.

Both sides draw them here: the program's set-up before it serves or
trains, and the reference again after the program is gone, so the
reference takes nothing the program has made. Each leaf (a stack over the
layers) is one ``torch.randn`` call on the device with a generator seeded
from (seed, leaf path), in the type the program holds it in: the same
seed on the same device gives the same bits on both sides.

The layout is the one ``ray_tpu_torch.models.transformer`` documents:
``embed [V,E]``, stacked layers ``attn.wq [L,E,H,Dh]``, ``wk/wv
[L,E,Hkv,Dh]``, ``wo [L,H,Dh,E]``, biases ``bq [L,H,Dh]`` ..., norms
``{"w", "b"} [L,E]``; a MoE mlp ``router [L,E,X]``, ``gate/up [L,X,E,F]``,
``down [L,X,F,E]``; a GELU mlp ``wi [L,E,F]``, ``wo [L,F,E]``, ``bi [L,F]``,
``bo [L,E]``; ``final_norm``, ``pos_embed [S,E]`` and ``lm_head [E,V]``
where the family has them. Normal with the configuration's ``init.std``
(GPT-2's 0.02), the residual projections std / sqrt(2 L), the token
embedding ``init.embed_std``; norm scales 1 and biases 0.
"""

from __future__ import annotations

import math

from gpubench.common import sub_seed


# each size under the names of the two config.json conventions it is
# published in (Llama/Mixtral's and GPT-2's)
_ALIASES = {"E": ("hidden_size", "n_embd"), "L": ("num_hidden_layers",
                                                  "n_layer"),
            "H": ("num_attention_heads", "n_head"),
            "F": ("intermediate_size", "n_inner"),
            "S": ("max_position_embeddings", "n_positions")}


def _get(cfg: dict, short: str):
    for key in _ALIASES[short]:
        if cfg.get(key) is not None:
            return cfg[key]
    return None


def dims(cfg: dict) -> dict:
    """The sizes of a configuration file's model, by short names."""
    E, H = _get(cfg, "E"), _get(cfg, "H")
    return {"E": E, "L": _get(cfg, "L"), "H": H,
            "Hkv": cfg.get("num_key_value_heads") or H,
            "Dh": cfg.get("head_dim") or E // H,
            "F": _get(cfg, "F") or 4 * E, "V": cfg["vocab_size"],
            "X": cfg.get("num_local_experts", 0),
            "k": cfg.get("num_experts_per_tok", 0),
            "S": _get(cfg, "S") or 0}


def param_shapes(cfg: dict) -> dict:
    d = dims(cfg)
    E, L, H, Hkv, Dh, F, V, X = (d[k] for k in
                                 ("E", "L", "H", "Hkv", "Dh", "F", "V", "X"))
    arch = cfg["architecture"]
    ln = arch["norm"] == "layernorm"
    norm = {"w": (L, E), "b": (L, E)} if ln else {"w": (L, E)}
    attn = {"wq": (L, E, H, Dh), "wk": (L, E, Hkv, Dh),
            "wv": (L, E, Hkv, Dh), "wo": (L, H, Dh, E)}
    if arch["bias"]:
        attn.update(bq=(L, H, Dh), bk=(L, Hkv, Dh), bv=(L, Hkv, Dh),
                    bo=(L, E))
    if X:
        mlp = {"router": (L, E, X), "gate": (L, X, E, F),
               "up": (L, X, E, F), "down": (L, X, F, E)}
    else:
        mlp = {"wi": (L, E, F), "wo": (L, F, E)}
        if arch["bias"]:
            mlp.update(bi=(L, F), bo=(L, E))
    out = {"embed": (V, E),
           "layers": {"norm1": norm, "attn": attn, "norm2": dict(norm),
                      "mlp": mlp},
           "final_norm": {"w": (E,), "b": (E,)} if ln else {"w": (E,)}}
    if arch["positions"] == "learned":
        out["pos_embed"] = (d["S"], E)
    if not cfg["tie_word_embeddings"]:
        out["lm_head"] = (E, V)
    return out


def init_std(path: tuple, n_layers: int, init: dict) -> float | None:
    """Normal std of a leaf, or None for a norm (ones) or a bias (zeros)."""
    if any(k in ("norm1", "norm2", "final_norm") for k in path) \
            or path[-1] in ("bq", "bk", "bv", "bo", "bi"):
        return None
    if path == ("embed",):
        return init["embed_std"]
    if path[-1] in ("wo", "down"):
        return init["std"] / math.sqrt(2 * n_layers)
    return init["std"]


def leaves(tree: dict, path=()):
    """(path, leaf) pairs of a nested dict, in insertion order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, path + (k,))
        else:
            yield path + (k,), v


def draw_leaf(torch, seed: int, path: tuple, shape, n_layers: int,
              init: dict, device, dtype):
    std = init_std(path, n_layers, init)
    if std is None:
        fill = 1.0 if path[-1] == "w" else 0.0
        return torch.full(shape, fill, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(
        sub_seed(seed, "weights", "/".join(path)))
    return torch.randn(shape, generator=gen, dtype=dtype,
                       device=device).mul_(std)


def make(torch, cfg: dict, seed: int, device, dtype) -> dict:
    """The whole param tree of `cfg` drawn from `seed` on `device`."""
    shapes = param_shapes(cfg)
    L = dims(cfg)["L"]
    out: dict = {}
    for path, shape in leaves(shapes):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = draw_leaf(torch, seed, path, shape, L,
                                   cfg["init"], device, dtype)
    return out
