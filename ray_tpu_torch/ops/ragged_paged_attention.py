"""Ragged paged attention for the decode step: Hopper kernel + plain version.

Counterpart of ray_tpu/ops/ragged_paged_attention.py, with its signatures and
layouts. One launch covers the whole continuous batch against one layer's
page pool: each row attends over exactly the pages its block table names, up
to its own position, so work tracks the tokens actually resident.

- The kernel is ``csrc/ragged_paged_attention.cu`` (flash-decoding): a split
  pass whose CTAs each walk ``pps`` of a row's live pages for one kv head,
  and a merge pass that combines the splits' partials by their logsumexp.
  One counted launch is these two device kernels. The split count comes
  from ``ragged_splits`` on the host (no device-to-host read). On a CUDA
  tensor the wrapper launches them or raises.
- ``ragged_decode_attention_reference`` is the plain PyTorch mirror of the
  JAX reference's per-page f32 online softmax; CPU tensors take it, and the
  card's check compares the kernel against it.
  ``ragged_decode_attention_split_reference`` mirrors the kernel's
  split-and-merge arithmetic; only the tests call it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ray_tpu_torch.ops import _build

_NEG_INF = -1e30

KERNEL = _build.Kernel(
    "ragged_paged_attention", "ragged_paged_attention_bf16",
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])

CTAS_PER_SM = 2  # split-pass CTAs the split count aims for on each SM


def ragged_splits(B: int, Hkv: int, nb: int, sm_count: int) -> tuple[int, int]:
    """(S, pps): the split count and pages per split of the split pass, from
    the batch's shape and the card's SM count alone, never from the rows'
    positions, so the decode step needs no device-to-host read. Aims for
    CTAS_PER_SM split CTAs on every SM when each (row, kv head) walks nb
    pages; S * pps >= nb and no split starts past nb."""
    want = max(1, -(-CTAS_PER_SM * sm_count // (B * Hkv)))
    pps = -(-nb // min(want, nb))
    return -(-nb // pps), pps


@functools.cache
def _sm_count(device_index: int) -> int:
    """The card's SM count, read once per card."""
    return torch.cuda.get_device_properties(
        device_index).multi_processor_count


def _page_sweep(qf, kp, vp, block_table, pos, pages, *, scale: float):
    """f32 online softmax over the table's pages `pages`, the JAX reference's
    per-page update: returns (m, l [B, H, 1], acc [B, H, Dh]). Pages whose
    first position is past a row's pos leave its accumulators untouched;
    out-of-range page ids clamp into the pool."""
    B, Hkv, G, Dh = qf.shape
    P = kp.shape[1]
    H = Hkv * G
    m = torch.full((B, H, 1), _NEG_INF, dtype=torch.float32, device=qf.device)
    l = torch.zeros((B, H, 1), dtype=torch.float32, device=qf.device)
    acc = torch.zeros((B, H, Dh), dtype=torch.float32, device=qf.device)
    offs = torch.arange(P, device=qf.device)
    pos = pos.long()
    for j in pages:
        pid = block_table[:, j].long().clamp(0, kp.shape[0] - 1)
        k = kp[pid].float()                                # [B, P, Hkv, Dh]
        v = vp[pid].float()
        s = torch.einsum("bkgd,bpkd->bkgp", qf, k) * scale
        kpos = j * P + offs
        s = torch.where(kpos[None, None, None, :] <= pos[:, None, None, None],
                        s, torch.full_like(s, _NEG_INF))
        sf = s.reshape(B, H, P)
        m_new = torch.maximum(m, sf.amax(dim=-1, keepdim=True))
        p = torch.exp(sf - m_new)
        corr = torch.exp(m - m_new)
        l_new = l * corr + p.sum(dim=-1, keepdim=True)
        pv = torch.einsum("bkgp,bpkd->bkgd", p.reshape(B, Hkv, G, P), v)
        acc_new = acc * corr + pv.reshape(B, H, Dh)
        live = (j * P <= pos)[:, None, None]
        m = torch.where(live, m_new, m)
        l = torch.where(live, l_new, l)
        acc = torch.where(live, acc_new, acc)
    return m, l, acc


def ragged_decode_attention_reference(q, kp, vp, block_table, pos, *,
                                      scale: float):
    """Plain version: a loop over the table's pages with the SAME f32
    online-softmax accumulation per page as the JAX reference. Dead pages
    (first position past the row's pos) keep the accumulators untouched."""
    _, l, acc = _page_sweep(q.float(), kp, vp, block_table, pos,
                            range(block_table.shape[1]), scale=scale)
    out = acc / l.clamp_min(1e-30)
    return out.reshape(q.shape).to(q.dtype)


def ragged_decode_attention_split_reference(q, kp, vp, block_table, pos, *,
                                            scale: float,
                                            pages_per_split: int):
    """Plain mirror of the kernel's split-and-merge arithmetic: split s runs
    the per-page online softmax over pages [s * pps, (s + 1) * pps) of the
    table (a split past a row's live pages stays empty: m = -1e30, l = 0),
    then M = max_s m_s, L = sum_s l_s e^(m_s - M) and
    out = sum_s acc_s e^(m_s - M) / max(L, 1e-30)."""
    nb = block_table.shape[1]
    qf = q.float()
    parts = [_page_sweep(qf, kp, vp, block_table, pos,
                         range(s, min(s + pages_per_split, nb)), scale=scale)
             for s in range(0, nb, pages_per_split)]
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    L = sum(l * torch.exp(m - M) for m, l, _ in parts)
    O = sum(acc * torch.exp(m - M) for m, _, acc in parts)
    out = O / L.clamp_min(1e-30)
    return out.reshape(q.shape).to(q.dtype)


def _ragged_kernel_call(q, kp, vp, block_table, pos, *, scale: float):
    if q.dim() != 4 or kp.dim() != 4 or kp.shape != vp.shape:
        raise ValueError("q must be [B, Hkv, G, Dh] and kp/vp equal "
                         "[num_pages, P, Hkv, Dh]")
    B, Hkv, G, Dh = q.shape
    N, P = kp.shape[0], kp.shape[1]
    if kp.shape[2:] != (Hkv, Dh):
        raise ValueError(f"pool {tuple(kp.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if block_table.dim() != 2 or block_table.shape[0] != B \
            or block_table.shape[1] < 1 or pos.shape != (B,):
        raise ValueError("block_table must be [B, nb>=1] and pos [B]")
    for name, x, dt in (("q", q, torch.bfloat16), ("kp", kp, torch.bfloat16),
                        ("vp", vp, torch.bfloat16),
                        ("block_table", block_table, torch.int32),
                        ("pos", pos, torch.int32)):
        if not x.is_cuda or x.device != q.device:
            raise ValueError(f"{name} must be on q's CUDA device")
        if x.dtype != dt:
            raise TypeError(f"ragged kernel takes {name} as {dt}, got {x.dtype}")
    for name, x in (("q", q), ("kp", kp), ("vp", vp), ("pos", pos)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if block_table.stride(1) != 1:
        raise ValueError("block_table rows must be contiguous")
    if Dh not in (64, 128) or P not in (16, 32, 64) or not 1 <= G <= 8:
        raise ValueError(f"ragged kernel supports Dh in (64, 128), page size "
                         f"in (16, 32, 64) and G <= 8; got Dh={Dh} P={P} G={G}")
    nb = block_table.shape[1]
    S, pps = ragged_splits(B, Hkv, nb, _sm_count(q.device.index))
    # split partials: O [B, Hkv, S, G, Dh], m and l [B, Hkv, S, G], f32
    n = B * Hkv * S * G
    scratch = torch.empty(n * (Dh + 2), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        KERNEL.launch(q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                      block_table.data_ptr(), pos.data_ptr(), out.data_ptr(),
                      scratch.data_ptr(), scratch[n * Dh:].data_ptr(),
                      scratch[n * (Dh + 1):].data_ptr(), B, Hkv, G, Dh, P,
                      nb, S, pps, block_table.stride(0), N, float(scale),
                      stream)
    return out


def ragged_decode_attention(q, kp, vp, block_table, pos, *,
                            scale: float | None = None,
                            impl: str | None = None):
    """One decode-attention launch over the whole continuous batch.

    q: [B, Hkv, G, Dh] — this step's queries (one token per row, grouped
    by kv head); kp/vp: [num_pages, P, Hkv, Dh] — one layer's page pool;
    block_table: [B, nb] int32 page ids (pre-sliced to the batch's live
    page bound); pos: [B] int32 — row b attends cache positions <= pos[b].
    Returns [B, Hkv, G, Dh] in q's dtype.

    impl: None → the kernel for CUDA tensors, the plain version for CPU
    tensors; "reference" → the plain version on any device.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if impl == "reference" or (impl is None and not q.is_cuda):
        return ragged_decode_attention_reference(q, kp, vp, block_table, pos,
                                                 scale=scale)
    if impl is not None:
        raise ValueError(f"impl must be None or 'reference', got {impl!r}")
    return _ragged_kernel_call(q, kp, vp, block_table, pos, scale=scale)
