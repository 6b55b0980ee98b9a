"""Kernels: the ragged paged decode attention's share of its roofline in
the trace slice. The work is each token served in the slice by a decode
step, attending over its context (ops/counts.py ragged_decode); the time
is that of the kernels implementing ragged_decode (ops/kernels/)."""

from gpubench import ops
from gpubench.metrics._read import dims, served_in
from gpubench.ops import counts


def read(layer):
    tr = layer.get("trace")
    if not tr:
        return None
    d = dims(layer)
    _, contexts = served_in(layer, tr["t0"], tr["t1"])
    if not contexts:
        return None
    work = [counts.ragged_decode(contexts, d["H"], d["Hkv"], d["Dh"],
                                 d["L"])]
    return ops.roofline_pct(work, ops.device_seconds("ragged_decode",
                                                     tr["kernel_s"]))
