"""Training: optimizers and the train steps, on one device or over a mesh.

Counterpart of ray_tpu/train's ``optim.py``, ``spmd.py`` and the rules and
device planes of ``zero.py``; the model's loss is
``ray_tpu_torch.models.transformer.loss_fn``.
"""

from ray_tpu_torch import _device  # noqa: F401 — numerics settings first

from ray_tpu_torch.train import zero
from ray_tpu_torch.train.zero import (make_zero_train_step,
                                      match_partition_rules)
from ray_tpu_torch.train.optim import (AdamWInt8, adamw, adamw_int8,
                                       optimizer_state_bytes, param_leaves)
from ray_tpu_torch.train.spmd import (init_sharded, make_sp_pp_train_step,
                                      make_train_step)

__all__ = [
    "AdamWInt8",
    "adamw",
    "adamw_int8",
    "init_sharded",
    "make_sp_pp_train_step",
    "make_train_step",
    "make_zero_train_step",
    "match_partition_rules",
    "optimizer_state_bytes",
    "param_leaves",
    "zero",
]
