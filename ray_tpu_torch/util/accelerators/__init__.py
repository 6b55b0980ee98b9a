from ray_tpu_torch.util.accelerators import gpu

__all__ = ["gpu"]
