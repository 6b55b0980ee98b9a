"""AdamW (Loshchilov and Hutter, arXiv:1711.05101) in plain float32: the
decoupled weight decay shrinks the param before the update, and the
moments are bias-corrected, with eps added to the corrected root of the
second moment."""

from __future__ import annotations

import math


class AdamW:
    def __init__(self, torch, params: list, lr: float, b1: float, b2: float,
                 eps: float, weight_decay: float):
        self.params = params
        self.lr, self.b1, self.b2 = lr, b1, b2
        self.eps, self.wd = eps, weight_decay
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    def step(self, grads: list) -> None:
        self.t += 1
        bc1 = 1.0 - self.b1 ** self.t
        bc2 = 1.0 - self.b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            p.mul_(1.0 - self.lr * self.wd)
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = (v.sqrt() / math.sqrt(bc2)).add_(self.eps)
            p.addcdiv_(m, denom, value=-self.lr / bc1)
