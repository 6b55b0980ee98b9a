"""Loss ops: cross-entropy with optional z-loss, computed stably in f32.

Counterpart of ray_tpu/ops/losses.py.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

MULTI_GPU_TODO = ("logits_spec shards the head matmul over a device mesh, "
                  "which is not ported yet: ROADMAP.md Queue 1 item 11 "
                  "(Multi-GPU)")


def _nll_sums(logits, labels, *, ignore_index: int, z_loss: float):
    """(sum of nll over valid positions, number of valid positions) of
    logits [..., V] against labels [...], in f32."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    picked = lf.gather(-1, safe.unsqueeze(-1)).squeeze(-1)
    nll = lse - picked
    if z_loss > 0.0:
        nll = nll + z_loss * lse.square()
    valid = valid.float()
    return (nll * valid).sum(), valid.sum()


def softmax_cross_entropy(logits, labels, *, ignore_index: int = -100,
                          z_loss: float = 0.0):
    """logits [..., V] f32/bf16, labels [...] int. Returns (mean_loss,
    n_valid): the mean is over valid (non-ignored) positions, and z_loss
    adds z_loss * log(Z)^2 (PaLM-style) per position."""
    total, count = _nll_sums(logits, labels, ignore_index=ignore_index,
                             z_loss=z_loss)
    n_valid = count.clamp_min(1.0)
    return total / n_valid, n_valid


def fused_head_cross_entropy(hidden, head_w, labels, *,
                             ignore_index: int = -100, z_loss: float = 0.0,
                             chunk: int = 2048, logits_spec=None):
    """CE(hidden @ head_w, labels) without materializing the full logits.

    hidden [N, E] (any float dtype), head_w [E, V], labels [N]. Rows are
    padded to a multiple of `chunk` with ignored labels, and each chunk's
    head matmul and cross-entropy run under non-reentrant checkpointing, so
    only one [chunk, V] logits block exists at a time, forward and backward.
    """
    if logits_spec is not None:
        raise NotImplementedError(MULTI_GPU_TODO)
    N, E = hidden.shape
    pad = (-N) % chunk
    if pad:
        hidden = torch.cat([hidden, hidden.new_zeros((pad, E))])
        labels = torch.cat([labels, labels.new_full((pad,), ignore_index)])

    def one(h, lab, w):
        return _nll_sums(h @ w.to(h.dtype), lab, ignore_index=ignore_index,
                         z_loss=z_loss)

    total = count = 0.0
    for c in range(hidden.shape[0] // chunk):
        rows = slice(c * chunk, (c + 1) * chunk)
        s, n = checkpoint(one, hidden[rows], labels[rows], head_w,
                          use_reentrant=False)
        total, count = total + s, count + n
    n_valid = count.clamp_min(1.0)
    return total / n_valid, n_valid
