"""Engine scheduler: the live rows a decode step, decode_slot_steps over
decode_steps across the window, read through /v1/stats."""

from gpubench.metrics._engine import ratio


def read(layer):
    return ratio(layer, "decode_slot_steps", "decode_steps", 1.0)
