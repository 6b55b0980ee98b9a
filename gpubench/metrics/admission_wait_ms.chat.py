"""Engine scheduler: the mean wait from submit to a decode slot, from
ray_tpu_llm_engine_phase_seconds{phase=admission_wait} over the window."""

from gpubench.metrics._read import hist_delta


def read(layer):
    s, n = hist_delta(layer, "ray_tpu_llm_engine_phase_seconds",
                      ("admission_wait",))
    return 1e3 * s / n if n > 0 else None
