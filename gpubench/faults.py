"""Faults planted under the timed path, for the checks that show the
correctness comparison fails them. A run takes one only from the hidden
``--fault`` option (its tests and calibration runs); the benchmark's own
runs never do.

- ``token_altered``: every 16th decode step's sampled tokens are shifted
  by one id where the engine produces them.
- ``state_unchanged``: a decode step leaves the rows' lengths as they
  were, so the next step writes over the same position; a training step
  leaves the params as they were.
- ``half_batch``: the training loss is the mean over half of the batch's
  rows, the rest left out.
"""

from __future__ import annotations

SERVE = ("token_altered", "state_unchanged")
TRAIN = ("half_batch", "state_unchanged")


def plant_serving(name: str | None) -> None:
    """Patch the port's decode path in this process (the engine's)."""
    if not name:
        return
    if name not in SERVE:
        raise ValueError(f"no serving fault {name!r}")
    from ray_tpu_torch.models import decoding
    from ray_tpu_torch.models import decoding_paged as dp

    if name == "token_altered":
        real = decoding.sample_per_row
        calls = [0]

        def altered(logits, *a, **kw):
            toks = real(logits, *a, **kw)
            calls[0] += 1
            if calls[0] % 16 == 0:
                toks = (toks + 1) % logits.shape[-1]
            return toks

        decoding.sample_per_row = altered
    else:
        real_step = dp.decode_step_paged_ragged

        def unchanged(params, state, *a, **kw):
            length = state["length"].clone()
            state, logits = real_step(params, state, *a, **kw)
            state["length"].copy_(length)
            return state, logits

        dp.decode_step_paged_ragged = unchanged


def training_loss(name: str | None, loss_fn):
    """The loss the train step runs, with a fault planted."""
    if name == "half_batch":
        return lambda p, b: loss_fn(p, b[: b.shape[0] // 2])
    if name in (None, "", "state_unchanged"):
        return loss_fn
    raise ValueError(f"no training fault {name!r}")
