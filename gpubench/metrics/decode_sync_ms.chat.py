"""Model step: the host's wait a decode step in the sampled ids' copy to
the host (the device's unfinished work), its decode_sync_seconds over its
decode_steps across the window, read through /v1/stats."""

from gpubench.metrics._engine import ratio


def read(layer):
    return ratio(layer, "decode_sync_seconds", "decode_steps", 1e3)
