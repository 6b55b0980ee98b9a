"""Measurements of the port on a CUDA card (``train_step.measure``)."""

from ray_tpu_torch import _device  # noqa: F401 — numerics settings first
