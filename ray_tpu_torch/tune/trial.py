"""Trial: one hyperparameter configuration's lifecycle.

(reference: python/ray/tune/experiment/trial.py — status machine
PENDING/RUNNING/TERMINATED/ERROR; checkpoints + last_result tracked per trial.)
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

PENDING = "PENDING"
RUNNING = "RUNNING"
TERMINATED = "TERMINATED"
ERROR = "ERROR"


@dataclass
class Trial:
    trial_id: str
    config: dict
    experiment_dir: str
    status: str = PENDING
    last_result: dict = field(default_factory=dict)
    iteration: int = 0
    error: str | None = None
    latest_checkpoint: object = None   # train.Checkpoint | None
    runner: object = None              # TrainWorker actor handle
    exploit_from: object = None        # set by PBT: donor Trial
    explore_config: dict | None = None
    stopping: bool = False             # stop requested, waiting for thread exit

    @property
    def trial_dir(self) -> str:
        """Per-trial storage prefix under the experiment (local path or URI)."""
        from ray_tpu_torch.train import storage as storage_mod

        d = storage_mod.join_path(self.experiment_dir, self.trial_id)
        if "://" not in d:
            os.makedirs(d, exist_ok=True)
        return d

    def summary(self) -> dict:
        return {"trial_id": self.trial_id, "config": self.config,
                "status": self.status, "last_result": self.last_result,
                "error": self.error, "iteration": self.iteration,
                "checkpoint_path": getattr(self.latest_checkpoint, "path", None)}
