"""Model step: the host's time a decode step from its start to the
sampled ids' copy (the forward's launches, sampling, the commit), its
decode_launch_seconds over its decode_steps across the window, read
through /v1/stats."""

from gpubench.metrics._engine import ratio


def read(layer):
    return ratio(layer, "decode_launch_seconds", "decode_steps", 1e3)
