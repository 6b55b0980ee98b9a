"""Kernels: the flash-attention forward's share of its roofline in the
trace slice. The work is the causal attention of each prompt prefilled in
the slice over its real length, not its bucket (ops/counts.py flash_fwd);
the time that of the kernels implementing flash_fwd (ops/kernels/)."""

from gpubench import ops
from gpubench.metrics._read import dims, served_in
from gpubench.ops import counts


def read(layer):
    tr = layer.get("trace")
    if not tr:
        return None
    d = dims(layer)
    prompts, _ = served_in(layer, tr["t0"], tr["t1"])
    if not prompts:
        return None
    work = [counts.flash_fwd(prompts, d["H"], d["Hkv"], d["Dh"], d["L"])]
    return ops.roofline_pct(work, ops.device_seconds("flash_fwd",
                                                     tr["kernel_s"]))
