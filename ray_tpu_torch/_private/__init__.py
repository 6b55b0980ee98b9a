"""Internal modules of ray_tpu_torch (the port's own copies of the pieces
of ray_tpu/_private it needs)."""
