"""ray_tpu_torch.experimental — the port's counterpart of
ray_tpu.experimental: channels and device objects."""
