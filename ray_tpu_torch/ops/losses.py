"""Loss ops: cross-entropy with optional z-loss, computed stably in f32.

Counterpart of ray_tpu/ops/losses.py. With the vocab split over a mesh
axis (``vocab_axis``, or the fused loss's ``logits_spec``), each rank holds
its contiguous vocab slice of the logits: the log-sum-exp combines the
slices' max (a shift, not differentiated: its gradient cancels) and
sum-exp over the axis, and the label's logit comes from the rank whose
slice holds it.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.parallel import collectives
from ray_tpu_torch.parallel.mesh import checkpoint_context, current_mesh


def _nll_sums(logits, labels, *, ignore_index: int, z_loss: float,
              vocab_axis=None):
    """(sum of nll over valid positions, number of valid positions) of
    logits [..., V] against labels [...], in f32; with `vocab_axis`, V is
    this rank's slice of the vocabulary."""
    lf = logits.float()
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    if vocab_axis is None:
        lse = torch.logsumexp(lf, dim=-1)
        picked = lf.gather(-1, safe.unsqueeze(-1)).squeeze(-1)
    else:
        V_loc = lf.shape[-1]
        m = collectives.allreduce_max(lf.amax(dim=-1), vocab_axis)
        lse = m + collectives.allreduce(
            torch.exp(lf - m.unsqueeze(-1)).sum(-1), vocab_axis).log()
        local = safe - collectives.axis_index(vocab_axis) * V_loc
        mine = (local >= 0) & (local < V_loc)
        picked = lf.gather(-1, local.clamp(0, V_loc - 1).unsqueeze(-1))
        picked = picked.squeeze(-1)
        picked = collectives.allreduce(
            torch.where(mine, picked, torch.zeros_like(picked)), vocab_axis)
    nll = lse - picked
    if z_loss > 0.0:
        nll = nll + z_loss * lse.square()
    valid = valid.float()
    return (nll * valid).sum(), valid.sum()


def softmax_cross_entropy(logits, labels, *, ignore_index: int = -100,
                          z_loss: float = 0.0, vocab_axis=None):
    """logits [..., V] f32/bf16, labels [...] int. Returns (mean_loss,
    n_valid): the mean is over valid (non-ignored) positions, and z_loss
    adds z_loss * log(Z)^2 (PaLM-style) per position. `vocab_axis`: the
    logits are this rank's vocab slice, split over that mesh axis."""
    total, count = _nll_sums(logits, labels, ignore_index=ignore_index,
                             z_loss=z_loss, vocab_axis=vocab_axis)
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

    `logits_spec` (a PartitionSpec over [chunk, V]) with the vocab dim on a
    mesh axis: head_w is this rank's [E, V/n] slice, each rank computes its
    vocab slice of the head matmul and partial lse, and the slices combine
    over that axis (the current mesh's, ``parallel.use_mesh``). A chunk's
    rows are this rank's own, so the spec may not split them.
    """
    vocab_axis = None
    if logits_spec is not None:
        spec = tuple(logits_spec) + (None,) * (2 - len(tuple(logits_spec)))
        if len(spec) != 2 or spec[0] is not None:
            raise ValueError(f"logits_spec {logits_spec} must be (None, "
                             "vocab axis): the rows are this rank's own")
        vocab_axis = spec[1]
        if vocab_axis is not None and current_mesh() is None:
            raise RuntimeError(
                f"logits_spec {logits_spec} splits the vocab over "
                f"{vocab_axis!r}, which needs a mesh in use "
                "(parallel.use_mesh) over an initialised process group")
    N, E = hidden.shape
    pad = (-N) % chunk
    if pad:
        hidden = torch.cat([hidden, hidden.new_zeros((pad, E))])
        labels = torch.cat([labels, labels.new_full((pad,), ignore_index)])

    def one(h, lab, w):
        return _nll_sums(h @ w.to(h.dtype), lab, ignore_index=ignore_index,
                         z_loss=z_loss, vocab_axis=vocab_axis)

    total = count = 0.0
    for c in range(hidden.shape[0] // chunk):
        rows = slice(c * chunk, (c + 1) * chunk)
        s, n = checkpoint(one, hidden[rows], labels[rows], head_w,
                          use_reentrant=False, context_fn=checkpoint_context)
        total, count = total + s, count + n
    n_valid = count.clamp_min(1.0)
    return total / n_valid, n_valid
