"""Training on one device: optimizers and the train step.

Counterpart of the single-device part of ray_tpu/train (``optim.py`` and
``spmd.make_train_step``); the model's loss is
``ray_tpu_torch.models.transformer.loss_fn``.
"""

from ray_tpu_torch.train.optim import (AdamWInt8, adamw, adamw_int8,
                                       optimizer_state_bytes, param_leaves)
from ray_tpu_torch.train.spmd import make_train_step

__all__ = [
    "AdamWInt8",
    "adamw",
    "adamw_int8",
    "make_train_step",
    "optimizer_state_bytes",
    "param_leaves",
]
