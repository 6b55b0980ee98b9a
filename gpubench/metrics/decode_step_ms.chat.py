"""Model step: the engine's decode step (device step and the sampled ids'
trip to the host), its decode_seconds over its decode_steps across the
window, read through /v1/stats."""

from gpubench.metrics._read import stats_delta


def read(layer):
    steps = stats_delta(layer, "decode_steps")
    if not steps:
        return None
    return 1e3 * stats_delta(layer, "decode_seconds") / steps
