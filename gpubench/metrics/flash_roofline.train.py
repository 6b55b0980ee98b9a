"""Kernels: the flash-attention forward and backward kernels' share of
their roofline in the trace slice. The time is that of the kernels
implementing flash_fwd and flash_bwd; the work is what those kernels run
in each traced step (ops/counts.py): the causal backward of every layer,
and the causal forward of every layer plus once more for each layer that
the port's remat policy recomputes in the backward. A recomputed forward
is device work of the flash forward kernel like the first, so leaving it
out would read the remat policy as a slower kernel."""

from gpubench import ops
from gpubench.metrics._read import dims
from gpubench.ops import counts


def recomputed_layers(port: dict, n_layers: int) -> int:
    """Layers whose attention forward runs again in the backward, as the
    port's ``_layer_fn`` (models/transformer.py) checkpoints them: none
    without remat; every other layer under "pairs"; every layer under
    "nothing" and under "dots", which saves only the 2-D matmuls."""
    if not port.get("remat", True):
        return 0
    if port.get("remat_policy", "nothing") == "pairs":
        return (n_layers + 1) // 2
    return n_layers


def read(layer):
    tr = layer.get("trace")
    if not tr or not tr.get("steps"):
        return None
    d = dims(layer)
    rows = [layer["seq"]] * (layer["batch"] * tr["steps"])
    secs = [ops.device_seconds(op, tr["kernel_s"])
            for op in ("flash_fwd", "flash_bwd")]
    if None in secs:
        return None
    fwd_layers = d["L"] + recomputed_layers(layer["cfg"]["port"], d["L"])
    work = [counts.flash_fwd(rows, d["H"], d["Hkv"], d["Dh"], fwd_layers),
            counts.flash_bwd(rows, d["H"], d["Hkv"], d["Dh"], d["L"])]
    return ops.roofline_pct(work, sum(secs))
