"""Train configuration objects.

(reference: python/ray/air/config.py — RunConfig/ScalingConfig/FailureConfig/
CheckpointConfig; train/v2/api/config.py re-exports the same surface.)
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class ScalingConfig:
    """How many workers, and what each reserves.

    (reference: air/config.py ScalingConfig — num_workers, use_gpu,
    resources_per_worker, placement_strategy.) `use_gpu` reserves one GPU a
    worker (a "GPU" bundle resource, bound through CUDA_VISIBLE_DEVICES as
    `num_gpus` is), where the JAX package's `use_tpu` reserves a chip;
    `topology` requests a SLICE placement as the JAX package's does.
    """

    num_workers: int = 1
    use_gpu: bool = False
    resources_per_worker: dict | None = None
    placement_strategy: str = "PACK"
    topology: str | None = None  # e.g. "v5e-8": ask for a slice via SLICE strategy
    # elastic scaling: with min_workers set, each (re)start sizes the group
    # to what the cluster can actually place in [min_workers, num_workers]
    # instead of failing (reference: elastic ScalingPolicy + restart resize,
    # train/v2/.../scaling_policy/)
    min_workers: int | None = None

    def bundle(self) -> dict:
        b = dict(self.resources_per_worker or {})
        b.setdefault("CPU", 1.0)
        if self.use_gpu:
            b.setdefault("GPU", 1.0)
        return b

    def bundles(self) -> list[dict]:
        return [self.bundle() for _ in range(self.num_workers)]

    @property
    def strategy(self) -> str:
        return "SLICE" if self.topology else self.placement_strategy


@dataclass
class FailureConfig:
    """(reference: air/config.py FailureConfig; policy applied by
    train/v2/_internal/execution/failure_handling/default.py:24 —
    worker-group errors are retried `max_failures` times, -1 = infinite.)"""

    max_failures: int = 0
    # hang watchdog: kill + elastically restart the attempt when a running
    # rank makes no step progress (no session.report) for this long while
    # not cooperatively stopping — a wedged collective or deadlocked input
    # pipeline otherwise stalls the run forever. None disables. Restarts
    # triggered by the watchdog DO consume the max_failures budget (a hang
    # is a failure; a node drain is not).
    hang_timeout_s: float | None = None


@dataclass
class CheckpointConfig:
    """(reference: air/config.py CheckpointConfig — retention by recency or
    by a score attribute; applied by checkpoint/checkpoint_manager.py:71.)"""

    num_to_keep: int | None = None
    checkpoint_score_attribute: str | None = None
    checkpoint_score_order: str = "max"  # "max" | "min"


@dataclass
class RunConfig:
    """(reference: air/config.py RunConfig — name + storage_path root where
    experiment dirs and checkpoints are persisted via pyarrow.fs; here any
    URI a `ray_tpu_torch.train.storage` backend is registered for — a bare local/
    NFS path, `file://...`, or `mock://bucket/prefix?fault-knobs`.)"""

    name: str | None = None
    storage_path: str | None = None
    failure_config: FailureConfig = field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = field(default_factory=CheckpointConfig)
    verbose: int = 0
    # persist failures past the retry budget degrade to a logged warning (the
    # report's metrics still flow; the run keeps training) unless this is set
    fail_on_persist_error: bool = False
    # a live StorageBackend instance overriding URI dispatch on storage_path —
    # how nested runs (Train-in-Tune) inherit the parent's backend (with its
    # fault knobs), and an escape hatch for backends with unpicklable-into-a-
    # URI config
    storage_backend: object | None = None

    def experiment_dir(self) -> str:
        """The experiment prefix (local path or URI, query preserved)."""
        from ray_tpu_torch.train import storage as storage_mod

        root = self.storage_path or storage_mod.default_results_root()
        return storage_mod.join_path(root, self.name or "train_run")
