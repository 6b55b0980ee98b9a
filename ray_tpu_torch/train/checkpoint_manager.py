"""CheckpointManager: registration + retention of reported checkpoints.

(reference: train/v2/_internal/execution/checkpoint/checkpoint_manager.py:71
— tracks (checkpoint, metrics) pairs, keeps the latest plus the top
`num_to_keep` by `checkpoint_score_attribute`, deletes the rest from storage
through the checkpoint's storage backend, never a raw rmtree.)
"""

from __future__ import annotations

from dataclasses import dataclass

from ray_tpu_torch.train import storage as storage_mod
from ray_tpu_torch.train._checkpoint import Checkpoint
from ray_tpu_torch.train.config import CheckpointConfig

# written into a checkpoint dir when the controller registers it; recovery
# after a crash trusts marked dirs whose per-rank manifests still validate
COMPLETE_MARKER = storage_mod.COMPLETE_MARKER


@dataclass
class _Tracked:
    checkpoint: Checkpoint
    metrics: dict
    index: int


class CheckpointManager:
    def __init__(self, config: CheckpointConfig | None = None):
        self.config = config or CheckpointConfig()
        self._tracked: list[_Tracked] = []
        self._counter = 0

    def register(self, checkpoint: Checkpoint, metrics: dict) -> None:
        for t in self._tracked:
            if t.checkpoint.path == checkpoint.path:
                t.metrics = dict(metrics)  # re-registered (e.g. storage recovery)
                # a recovered dir may predate its marker (controller died
                # between persist and registration): (re)write it so the
                # checkpoint is durable for the NEXT recovery too
                self._write_complete_marker(t.checkpoint)
                return
        self._write_complete_marker(checkpoint)
        self._tracked.append(_Tracked(checkpoint, dict(metrics), self._counter))
        self._counter += 1
        self._enforce_retention()

    @staticmethod
    def _write_complete_marker(checkpoint: Checkpoint) -> None:
        """Durable completion marker for crash recovery, written through the
        checkpoint's storage backend."""
        try:
            marker = storage_mod.join_path(checkpoint.path, COMPLETE_MARKER)
            if not checkpoint.backend.exists(marker):
                storage_mod.write_complete_marker(checkpoint.backend,
                                                  checkpoint.path)
        except Exception:  # noqa: BLE001 — marker is best-effort metadata
            pass

    def _score(self, t: _Tracked):
        attr = self.config.checkpoint_score_attribute
        if attr is None:
            return (t.index, t.index)  # no attribute configured: recency
        if attr not in t.metrics:
            # configured but unreported: fall back to recency among
            # themselves, but never outrank a real score
            return (float("-inf"), t.index)
        v = t.metrics[attr]
        score = v if self.config.checkpoint_score_order == "max" else -v
        return (score, t.index)  # ties break toward the newer checkpoint

    def _enforce_retention(self) -> None:
        keep = self.config.num_to_keep
        if keep is None or len(self._tracked) <= keep:
            return
        latest = self._tracked[-1]
        by_score = sorted(self._tracked, key=self._score, reverse=True)
        keep_set = {id(t) for t in by_score[:keep]}
        keep_set.add(id(latest))  # never delete the resume point
        for t in list(self._tracked):
            if id(t) not in keep_set and len(self._tracked) > keep:
                self._tracked.remove(t)
                try:  # delete from storage via the backend, not local rmtree
                    t.checkpoint.delete()
                except Exception:  # noqa: BLE001 — retention is best-effort
                    pass

    @property
    def latest_checkpoint(self) -> Checkpoint | None:
        return self._tracked[-1].checkpoint if self._tracked else None

    @property
    def best_checkpoint(self) -> Checkpoint | None:
        if not self._tracked:
            return None
        return max(self._tracked, key=self._score).checkpoint

    @property
    def best_checkpoints(self) -> list[tuple[Checkpoint, dict]]:
        return [(t.checkpoint, t.metrics) for t in self._tracked]
