"""Device: the share of the trace slice in which no kernel ran (the
union of the kernel intervals against the slice's length)."""


def read(layer):
    tr = layer.get("trace")
    if not tr or not tr["kernels"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
