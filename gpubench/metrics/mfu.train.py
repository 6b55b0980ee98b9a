"""Train step: model FLOPs a token (the port's count, copied in
ops/counts.py: 6 N plus causal attention, not the remat recompute) times
the window's tokens a second, against the H100's 989 TFLOP/s."""

from gpubench.common import PEAK_BF16_FLOPS
from gpubench.metrics._read import dims
from gpubench.ops import counts


def read(layer):
    per_token = counts.train_flops_per_token(layer["n_params"], dims(layer),
                                             layer["seq"])
    return 100.0 * layer["tokens_per_s"] * per_token / PEAK_BF16_FLOPS
