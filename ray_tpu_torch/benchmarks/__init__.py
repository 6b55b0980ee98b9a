"""Measurements of the port on a CUDA card (``train_step.measure``)."""
