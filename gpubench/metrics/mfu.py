"""The whole step: model FLOPs of the tokens prefilled and decoded in the
trace slice (the published routing's, ops/counts.py) over the slice's
host-clock length, against the H100's 989 TFLOP/s."""

from gpubench.common import PEAK_BF16_FLOPS
from gpubench.metrics._read import served_flops


def read(layer):
    tr = layer.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    flops = served_flops(layer, tr["t0"], tr["t1"])
    return 100.0 * flops / tr["window_s"] / PEAK_BF16_FLOPS if flops \
        else None
