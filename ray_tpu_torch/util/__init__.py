"""ray_tpu_torch.util — host utilities of the port (metrics)."""
