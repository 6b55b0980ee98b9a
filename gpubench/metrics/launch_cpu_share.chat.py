"""Engine host thread: the share of the decode launches' wall time the
scheduler's thread ran on a core (its thread_time); the rest it waited
for the GIL or a core. decode_launch_cpu_seconds over
decode_launch_seconds across the window, read through /v1/stats."""

from gpubench.metrics._engine import ratio


def read(layer):
    return ratio(layer, "decode_launch_cpu_seconds", "decode_launch_seconds",
                 100.0)
