"""The training cells' reference: the first steps of the timed loop in
float32 (the control in float8), from the same seed's weights and batches.

The batch of each step is taken in blocks of rows (``micro`` at a time)
whose summed losses make the mean over the whole batch, so the float32
activations of GPT-2 XL fit beside its params, gradients and moments.
Returns each step's loss, each leaf's first gradient and each leaf's
change after the last step, as norms.
"""

from __future__ import annotations

from gpubench import weights
from gpubench.reference import lowp, model, strict_fp32
from gpubench.reference.adamw import AdamW


def unbind_layers(torch, params: dict) -> list[dict]:
    """Per-layer views of the stacked leaves (one unbind per leaf, whose
    backward is one stack)."""
    parts = {blk: {k: torch.unbind(v, 0) for k, v in leaves.items()}
             for blk, leaves in params["layers"].items()}
    L = len(next(iter(next(iter(parts.values())).values())))
    return [{blk: {k: v[i] for k, v in leaves.items()}
             for blk, leaves in parts.items()} for i in range(L)]


def batch_loss_sum(torch, params, tokens, spec, mm):
    """Summed next-token NLL of tokens [b, T + 1] (labels tokens[:, 1:])."""
    x = model.embed(torch, params, tokens[:, :-1], spec)
    for lp in unbind_layers(torch, params):
        x = model.layer(torch, x, lp, spec, mm)
    logits = model.head(torch, x, params, spec, mm)
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, tokens[:, 1:, None]).sum()


def run(torch, cfg: dict, seed: int, device, batches: list, opt: dict,
        micro: int, precision: str = "f32") -> dict:
    strict_fp32(torch)
    spec = model.Spec(cfg)
    mm = lowp.matmul(torch, precision)
    params = weights.make(torch, cfg, seed, device, torch.float32)
    named = list(weights.leaves(params))
    names = ["/".join(p) for p, _ in named]
    leaves = [t.requires_grad_(True) for _, t in named]
    start = [t.detach().clone() for t in leaves]
    adam = AdamW(torch, leaves, opt["learning_rate"], opt["b1"], opt["b2"],
                 opt["eps"], opt["weight_decay"])
    losses, first_grad = [], None
    for tokens in batches:
        n = tokens.shape[0] * (tokens.shape[1] - 1)
        total = 0.0
        for r in range(0, tokens.shape[0], micro):
            loss = batch_loss_sum(torch, params, tokens[r:r + micro], spec,
                                  mm) / n
            loss.backward()
            total += float(loss.detach())
        grads = [t.grad for t in leaves]
        if first_grad is None:
            first_grad = [float(g.norm()) for g in grads]
        with torch.no_grad():
            adam.step(grads)
        for t in leaves:
            t.grad = None
        losses.append(total)
    with torch.no_grad():
        change = [float((t - s).norm()) for t, s in zip(leaves, start)]
    return {"losses": losses, "leaves": names,
            "grad_norms": dict(zip(names, first_grad)),
            "change_norms": dict(zip(names, change))}
