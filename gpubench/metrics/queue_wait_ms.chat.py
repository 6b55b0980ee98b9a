"""Engine scheduler: the mean wait from submit to the scheduler pass that
starts the request's admission, from
ray_tpu_llm_engine_phase_seconds{phase=queue_wait} over the window (its
prefill is ``prefill_ms.chat``)."""

from gpubench.metrics._read import hist_delta


def read(layer):
    s, n = hist_delta(layer, "ray_tpu_llm_engine_phase_seconds",
                      ("queue_wait",))
    return 1e3 * s / n if n > 0 else None
