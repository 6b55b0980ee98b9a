"""int8 block quantization + error feedback for host-plane collectives.

EQuARX-style (arXiv 2506.17615) wire compression for the ring collectives
in `collective.py`: every chunk a rank puts on the wire is block-quantized
to int8 with one f32 absmax scale per 256-element block (the same recipe
as `train/optim.py`'s int8 optimizer state, but numpy-side — these tensors
live on the host plane). ~3.9x fewer bytes-on-wire at block=256:
4 bytes/elem → 1 byte/elem + 4/256 bytes/elem of scales.

Quantization is lossy, and a gradient allreduce runs every step — without
correction the per-round error enters the optimizer as unbiased-ish noise
that error *feedback* (Seide et al. 2014; EF-SGD, Karimireddy et al. 2019)
turns into a telescoping sum: each quantization site keeps its residual
(what the wire could not carry) and adds it back into the next round's
input at the same site. The cumulative transmitted signal then tracks the
cumulative true signal within ONE round's quantization error, independent
of the number of rounds:

    sum_t Q(x_t + r_t) = sum_t x_t + r_0 - r_T,   |r_T| <= qstep/2 per elem

`tests/test_collective_quantized.py` asserts exactly this bound.

Sites are named by (group, ef_key, site) — `site` distinguishes the W-1
reduce-phase hops from the W-1 allgather-phase hops of one ring call, so
every hop carries its own residual and shapes stay stable across calls as
long as the caller reuses the same ef_key for the same tensor (the
standard collective contract already requires identical shapes).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

BLOCK = 256

# (group_name, ef_key, site) -> f32 residual, shape of the chunk quantized
# at that site. Process-local, like collective.py's _groups registry.
_residuals: dict[tuple, np.ndarray] = {}


class QuantizedChunk(NamedTuple):
    """Wire format of one int8-block-quantized chunk."""

    q: np.ndarray        # int8 [n + pad]
    scale: np.ndarray    # f32 [(n + pad) / BLOCK]
    n: int               # original element count
    dtype: str           # original dtype name (restored on dequantize)
    shape: tuple = ()    # original shape (dequantize returns flat [n])

    @property
    def wire_bytes(self) -> int:
        return self.q.nbytes + self.scale.nbytes


def quantize_block(x: np.ndarray, block: int = BLOCK) -> QuantizedChunk:
    """f32-ish [n] → int8 per-block-absmax chunk (numpy mirror of
    train/optim.py's `_quantize`)."""
    flat = np.ascontiguousarray(x).ravel()
    n = flat.size
    pad = (-n) % block
    f = flat.astype(np.float32, copy=False)
    if pad:
        f = np.concatenate([f, np.zeros((pad,), np.float32)])
    blocks = f.reshape(-1, block)
    scale = (np.abs(blocks).max(axis=1) / 127.0).astype(np.float32)
    safe = np.where(scale > 0, scale, 1.0)
    q = np.clip(np.rint(blocks / safe[:, None]), -127, 127).astype(np.int8)
    return QuantizedChunk(q.reshape(-1), scale, n, str(x.dtype),
                          tuple(x.shape))


def dequantize_block(c: QuantizedChunk, block: int = BLOCK) -> np.ndarray:
    safe = np.where(c.scale > 0, c.scale, 1.0).astype(np.float32)
    out = (c.q.reshape(-1, block).astype(np.float32) * safe[:, None])
    return out.reshape(-1)[:c.n].astype(c.dtype, copy=False)


def quantize_with_feedback(x: np.ndarray, group: str, ef_key: str,
                           site: str, block: int = BLOCK) -> QuantizedChunk:
    """Quantize `x + residual[site]`, storing the new residual — the error
    feedback loop for one wire hop. Residuals accumulate in f32 regardless
    of the payload dtype (f16 residual storage would itself quantize)."""
    key = (group, ef_key, site)
    r = _residuals.get(key)
    xf = np.ascontiguousarray(x).ravel().astype(np.float32, copy=True)
    if r is not None and r.shape == xf.shape:
        xf += r
    c = quantize_block(xf, block)
    _residuals[key] = xf - dequantize_block(c, block).astype(np.float32)
    return QuantizedChunk(c.q, c.scale, c.n, str(x.dtype), tuple(x.shape))


def release_group_residuals(group: str) -> None:
    """Drop every error-feedback residual held for `group` (called by
    destroy_collective_group — residuals are per-group state and keeping
    them past the group's life is a leak)."""
    for key in [k for k in _residuals if k[0] == group]:
        _residuals.pop(key, None)


def residual_count(group: str) -> int:
    """Test/introspection helper: live residual buffers for `group`."""
    return sum(1 for k in _residuals if k[0] == group)


def wire_bytes(payload) -> int:
    """Bytes an object occupies on the wire: quantized chunks report their
    compressed size, ndarrays their raw size."""
    if isinstance(payload, QuantizedChunk):
        return payload.wire_bytes
    if isinstance(payload, np.ndarray):
        return payload.nbytes
    return 0
