"""Binary IDs for objects, tasks, actors, workers, placement groups.

TPU-native analogue of the reference's id vocabulary
(reference: src/ray/common/id.h — JobID/ActorID/TaskID/ObjectID). We keep the
same structural idea (ObjectIDs derive from the producing TaskID + return
index, so lineage is recoverable from the ID itself) without the bit-packed
binary layout.
"""

from __future__ import annotations

import os
import threading

_HEX = "0123456789abcdef"


def _rand_hex(n: int = 16) -> str:
    return os.urandom(n).hex()


class BaseID:
    __slots__ = ("_hex",)
    _prefix = "id"

    def __init__(self, hex_str: str | None = None):
        self._hex = hex_str if hex_str is not None else _rand_hex()

    def hex(self) -> str:
        return self._hex

    def __eq__(self, other):
        return type(other) is type(self) and other._hex == self._hex

    def __hash__(self):
        return hash((self._prefix, self._hex))

    def __repr__(self):
        return f"{type(self).__name__}({self._hex[:8]}…)"

    def binary(self) -> bytes:
        return bytes.fromhex(self._hex)

    @classmethod
    def from_hex(cls, h: str):
        return cls(h)


class TaskID(BaseID):
    _prefix = "task"


class ActorID(BaseID):
    _prefix = "actor"


class WorkerID(BaseID):
    _prefix = "worker"


class NodeID(BaseID):
    _prefix = "node"


class PlacementGroupID(BaseID):
    _prefix = "pg"


class ObjectID(BaseID):
    """ObjectID = <task hex>:<return index>, or a pure random id for ray.put.

    Embedding the producing task makes lineage reconstruction possible from
    the ID alone (reference: src/ray/common/id.h object-id structure).
    """

    _prefix = "obj"

    @classmethod
    def for_task_return(cls, task_id: TaskID, index: int) -> "ObjectID":
        return cls(f"{task_id.hex()}r{index:04d}")

    @classmethod
    def for_put(cls) -> "ObjectID":
        return cls(f"{_rand_hex()}p0000")

    def task_id(self) -> TaskID | None:
        if self._hex.endswith("p0000"):
            return None
        base, _, _ = self._hex.rpartition("r")
        return TaskID(base) if base else None

    def return_index(self) -> int:
        _, _, idx = self._hex.rpartition("r")
        try:
            return int(idx)
        except ValueError:
            return 0


_local_counter = threading.local()
