"""Engine scheduler: the mean share of the decode slots a decode step
ran live rows in, over the window (decode_slot_steps over decode_steps,
over max_slots)."""

from gpubench.metrics._read import stats_delta


def read(layer):
    steps = stats_delta(layer, "decode_steps")
    if not steps:
        return None
    return 100.0 * stats_delta(layer, "decode_slot_steps") / steps \
        / layer["after"]["max_slots"]
