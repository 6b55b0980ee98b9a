"""Model step: the engine's prefill seconds (prefill and its first
token's trip to the host) between the counters' two readings, per
thousand prompt tokens of the requests whose first token came between
them."""

from gpubench.metrics._read import served_in, stats_delta


def read(layer):
    if not layer.get("before"):
        return None
    prompts, _ = served_in(layer, layer["before"]["t"], layer["after"]["t"])
    sec = stats_delta(layer, "prefill_seconds")
    if not prompts or sec is None:
        return None
    return 1e6 * sec / sum(prompts)
