"""Train runtime: the mean time of a train.report call in the window,
timed by the benchmark's loop around each call."""


def read(layer):
    return layer.get("report_ms")
