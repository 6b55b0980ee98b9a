"""Worker-group synchronization: barrier + broadcast without device collectives.

(reference: train/v2/_internal/execution/collective_impl.py —
broadcast_from_rank_zero:16, barrier:32. These are host-side control-plane
collectives between the actor workers of one group; device-tensor collectives
live inside the jitted program as XLA collectives instead.)

Implementation note: actor methods execute serially per actor, so a barrier
must never block inside the sync actor — workers `arrive` (non-blocking) and
then poll `done`.
"""

from __future__ import annotations

import time

import ray_tpu_torch


@ray_tpu_torch.remote
class SyncActor:
    """Rendezvous state shared by the workers of one worker group."""

    def __init__(self, world_size: int):
        self.n = world_size
        self._arrivals: dict[str, set[int]] = {}
        self._kv: dict[str, bytes] = {}

    def arrive(self, key: str, rank: int) -> None:
        self._arrivals.setdefault(key, set()).add(rank)

    def done(self, key: str) -> bool:
        return len(self._arrivals.get(key, ())) >= self.n

    def put(self, key: str, blob: bytes) -> None:
        self._kv[key] = blob

    def get(self, key: str):
        return self._kv.get(key)

    def clear(self, key: str) -> None:
        self._arrivals.pop(key, None)
        self._kv.pop(key, None)


def barrier(sync_actor, key: str, rank: int, *, timeout: float = 300.0,
            poll_s: float = 0.01) -> None:
    sync_actor.arrive.remote(key, rank)
    deadline = time.monotonic() + timeout
    while not ray_tpu_torch.get(sync_actor.done.remote(key)):
        if time.monotonic() > deadline:
            raise TimeoutError(f"barrier {key!r} timed out after {timeout}s")
        time.sleep(poll_s)


def broadcast_from_rank_zero(sync_actor, key: str, rank: int, data=None, *,
                             timeout: float = 300.0, poll_s: float = 0.01):
    from ray_tpu_torch._private import serialization as ser

    if rank == 0:
        ray_tpu_torch.get(sync_actor.put.remote(key, ser.dumps(data)))
        return data
    deadline = time.monotonic() + timeout
    while True:
        blob = ray_tpu_torch.get(sync_actor.get.remote(key))
        if blob is not None:
            return ser.loads(blob)
        if time.monotonic() > deadline:
            raise TimeoutError(f"broadcast {key!r} timed out after {timeout}s")
        time.sleep(poll_s)
