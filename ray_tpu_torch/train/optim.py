"""Optimizers over the port's param trees.

Counterpart of ray_tpu/train/optim.py and of the ``optax.adamw`` the JAX
package trains with:

- ``adamw``: ``torch.optim.AdamW`` over the param leaves with optax's
  defaults. The update is the same as optax.adamw's: bias-corrected
  moments, eps added to sqrt(v_hat), and decoupled weight decay applied to
  the params as they were before the step. The rate is a float or, as in
  optax, a schedule of the step count.
- ``AdamWInt8`` / ``adamw_int8``: AdamW whose two moments live in int8 with
  one f32 absmax scale per block of 256 (the 8-bit-Adam recipe), ~2.06
  bytes of state per param instead of 8.
"""

from __future__ import annotations

import torch

_BLOCK = 256


def param_leaves(params) -> list[torch.Tensor]:
    """The tensors of a param tree (nested dicts), in insertion order."""
    if isinstance(params, dict):
        return [t for v in params.values() for t in param_leaves(v)]
    return [params]


class ScheduledAdamW(torch.optim.AdamW):
    """``torch.optim.AdamW`` whose rate is ``schedule(count)``, read before
    each step at the count of steps already taken, as optax evaluates a
    schedule (so the first step uses ``schedule(0)``). The count is kept in
    every param group, so it travels with ``state_dict()``."""

    def __init__(self, params, schedule, **kwargs):
        super().__init__(params, lr=float(schedule(0)), **kwargs)
        self._schedule = schedule
        for group in self.param_groups:
            group.setdefault("schedule_count", 0)

    def step(self, closure=None):
        for group in self.param_groups:
            group["lr"] = float(self._schedule(group["schedule_count"]))
            group["schedule_count"] += 1
        return super().step(closure)


def adamw(params, learning_rate, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4) -> torch.optim.AdamW:
    """``torch.optim.AdamW`` over the leaves of `params` with optax.adamw's
    defaults (weight_decay 1e-4). `learning_rate` is a float or a callable
    of the step count (a schedule, as optax takes; ``ScheduledAdamW``).
    Marks the leaves as requiring grad. On CUDA it uses PyTorch's fused
    update (one launch for all leaves)."""
    leaves = param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    fused = all(p.is_cuda for p in leaves)
    kwargs = dict(betas=(b1, b2), eps=eps, weight_decay=weight_decay,
                  fused=fused or None)
    if callable(learning_rate):
        return ScheduledAdamW(leaves, learning_rate, **kwargs)
    return torch.optim.AdamW(leaves, lr=learning_rate, **kwargs)


def _quantize(x: torch.Tensor, block: int):
    """f32 [N] → (int8 [N], f32 scales [N / block]) by per-block absmax."""
    blocks = x.reshape(-1, block)
    scale = blocks.abs().amax(dim=1) / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(blocks / safe[:, None]), -127, 127)
    return q.to(torch.int8).reshape(-1), scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor, block: int):
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    return (q.reshape(-1, block).float() * safe[:, None]).reshape(-1)


class AdamWInt8(torch.optim.Optimizer):
    """AdamW with block-quantized int8 moments, the counterpart of
    ``ray_tpu.train.optim.adamw_int8``.

    Per param the state holds ``step`` and the moments as int8 ``m_q``/``v_q``
    (padded to a multiple of `block`) with f32 ``m_scale``/``v_scale``. The
    update math is f32 and matches the JAX version: moments are dequantized,
    updated, bias-corrected at the incremented step, and requantized; `lr`
    may be a float or a schedule ``lr(step)`` read at the pre-increment step,
    as optax evaluates schedules. Params without a gradient are skipped."""

    def __init__(self, params, lr, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, block: int = _BLOCK):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay, block=block))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            block, eps, wd = group["block"], group["eps"], group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                n = p.numel()
                padded = n + (-n) % block
                if not st:
                    st["step"] = 0
                    for m in ("m", "v"):
                        st[f"{m}_q"] = torch.zeros(padded, dtype=torch.int8,
                                                   device=p.device)
                        st[f"{m}_scale"] = torch.zeros(
                            padded // block, dtype=torch.float32,
                            device=p.device)
                lr = group["lr"]
                lr = lr(st["step"]) if callable(lr) else lr
                st["step"] += 1
                c = torch.tensor(float(st["step"]), dtype=torch.float32)
                bc1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** c
                bc2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** c
                g = p.grad.reshape(-1).float()
                if padded != n:
                    g = torch.cat([g, g.new_zeros(padded - n)])
                m = _dequantize(st["m_q"], st["m_scale"], block)
                v = _dequantize(st["v_q"], st["v_scale"], block)
                m = b1 * m + (1.0 - b1) * g
                v = b2 * v + (1.0 - b2) * g * g
                upd = (m / bc1.to(p.device)) / (torch.sqrt(v / bc2.to(p.device))
                                                + eps)
                upd = upd[:n].reshape(p.shape)
                p.add_((-(lr * (upd + wd * p.float()))).to(p.dtype))
                st["m_q"], st["m_scale"] = _quantize(m, block)
                st["v_q"], st["v_scale"] = _quantize(v, block)
        return loss


def adamw_int8(params, learning_rate, b1: float = 0.9, b2: float = 0.999,
               eps: float = 1e-8, weight_decay: float = 0.0,
               block: int = _BLOCK) -> AdamWInt8:
    """``AdamWInt8`` over the leaves of `params` (marked as requiring grad),
    with the JAX ``adamw_int8``'s arguments and defaults."""
    leaves = param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    return AdamWInt8(leaves, learning_rate, betas=(b1, b2), eps=eps,
                     weight_decay=weight_decay, block=block)


def optimizer_state_bytes(opt_state) -> int:
    """Total bytes of the tensors held by an optimizer's state (an
    optimizer, or its ``state`` mapping)."""
    if isinstance(opt_state, torch.optim.Optimizer):
        opt_state = opt_state.state
    if isinstance(opt_state, torch.Tensor):
        return opt_state.numel() * opt_state.element_size()
    if isinstance(opt_state, dict):
        return sum(optimizer_state_bytes(v) for v in opt_state.values())
    return 0  # plain numbers such as a step count
