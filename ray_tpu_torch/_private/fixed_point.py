"""Fixed-point resource quantities.

(reference: src/ray/common/scheduling/fixed_point.h — resource amounts are
int64 multiples of 1e-4 so that repeated acquire/release cycles are exact;
float dicts with epsilon compares drift and eventually mis-schedule.)

The GCS stores node/bundle `total`/`available` dicts in these integer
units internally and converts at its API surfaces. Request-side resource
dicts (task/actor/PG specs, lease messages) stay user-facing floats and
are quantized at the scheduling chokepoints via `fp_dict` — `to_fp` is
deterministic per value, so an acquire followed by a release cancels to
exactly zero.
"""

from __future__ import annotations

PRECISION = 10_000  # 1e-4 resource units, matching the reference


def to_fp(v: float) -> int:
    return round(float(v) * PRECISION)


def from_fp(u: int) -> float:
    return u / PRECISION


def fp_dict(res: dict) -> dict:
    """Quantize a float resource dict into integer units."""
    return {k: to_fp(v) for k, v in res.items()}


def float_dict(res: dict) -> dict:
    """Integer units back to user-facing floats."""
    return {k: from_fp(v) for k, v in res.items()}
