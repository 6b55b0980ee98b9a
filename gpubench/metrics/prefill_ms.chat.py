"""Model step: the mean time from the pass that starts a request's
admission to its first token on the stream (the prompt's forward, its
sampling and sync), from ray_tpu_llm_engine_phase_seconds{phase=prefill}
over the window."""

from gpubench.metrics._read import hist_delta


def read(layer):
    s, n = hist_delta(layer, "ray_tpu_llm_engine_phase_seconds",
                      ("prefill",))
    return 1e3 * s / n if n > 0 else None
