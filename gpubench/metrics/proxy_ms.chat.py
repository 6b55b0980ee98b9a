"""Serve front: the HTTP proxy's own time a request (its parse, route and
accept phases), from ray_tpu_serve_proxy_phase_seconds's sums over the
window, per parsed request."""

from gpubench.metrics._read import hist_delta

METRIC = "ray_tpu_serve_proxy_phase_seconds"


def read(layer):
    s, _ = hist_delta(layer, METRIC, ("parse", "route", "accept"))
    _, n = hist_delta(layer, METRIC, ("parse",))
    return 1e3 * s / n if n > 0 else None
