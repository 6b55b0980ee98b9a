"""Fixed-pool actor work distribution.

(reference: python/ray/util/actor_pool.py:13 — ActorPool schedules
``fn(actor, value)`` calls onto whichever pooled actor is free, with
ordered ``map`` / completion-ordered ``map_unordered`` iteration and the
submit/get_next streaming protocol. API-compatible surface.)
"""

from __future__ import annotations

from typing import Any, Callable, List, TypeVar

import ray_tpu_torch

V = TypeVar("V")


class ActorPool:
    """Operate on a fixed pool of actors.

    Example::

        @ray_tpu_torch.remote
        class Worker:
            def double(self, v):
                return 2 * v

        pool = ActorPool([Worker.remote(), Worker.remote()])
        list(pool.map(lambda a, v: a.double.remote(v), [1, 2, 3, 4]))
        # -> [2, 4, 6, 8]
    """

    def __init__(self, actors: list):
        self._idle_actors = list(actors)
        self._future_to_actor: dict = {}
        self._index_to_future: dict = {}
        self._next_task_index = 0
        self._next_return_index = 0
        self._pending_submits: list = []

    # ------------------------------------------------------------- mapping

    def map(self, fn: Callable[[Any, V], Any], values: List[V]):
        """Apply fn to each value; yields results in SUBMISSION order."""
        # fully consume any streaming leftovers so ordering restarts clean
        while self.has_next():
            try:
                self.get_next_unordered(timeout=0)
            except TimeoutError:
                break
        for v in values:
            self.submit(fn, v)

        def results():
            while self.has_next():
                yield self.get_next()

        return results()

    def map_unordered(self, fn: Callable[[Any, V], Any], values: List[V]):
        """Apply fn to each value; yields results in COMPLETION order."""
        while self.has_next():
            try:
                self.get_next_unordered(timeout=0)
            except TimeoutError:
                break
        for v in values:
            self.submit(fn, v)

        def results():
            while self.has_next():
                yield self.get_next_unordered()

        return results()

    # ----------------------------------------------------------- streaming

    def submit(self, fn: Callable[[Any, V], Any], value: V) -> None:
        """Schedule fn(actor, value) on the next free actor (queued if the
        whole pool is busy)."""
        if self._idle_actors:
            actor = self._idle_actors.pop()
            future = fn(actor, value)
            self._future_to_actor[future] = (self._next_task_index, actor)
            self._index_to_future[self._next_task_index] = future
            self._next_task_index += 1
        else:
            self._pending_submits.append((fn, value))

    def has_next(self) -> bool:
        return bool(self._future_to_actor)

    def has_free(self) -> bool:
        return bool(self._idle_actors) and not self._pending_submits

    def get_next(self, timeout: float | None = None,
                 ignore_if_timedout: bool = False):
        """Next result in submission order."""
        if not self.has_next():
            raise StopIteration("No more results to get")
        future = self._index_to_future[self._next_return_index]
        done, _ = ray_tpu_torch.wait([future], timeout=timeout)
        if not done:
            if ignore_if_timedout:
                return None
            raise TimeoutError("Timed out waiting for result")
        del self._index_to_future[self._next_return_index]
        self._next_return_index += 1
        _, actor = self._future_to_actor.pop(future)
        self._return_actor(actor)
        return ray_tpu_torch.get(future)

    def get_next_unordered(self, timeout: float | None = None,
                           ignore_if_timedout: bool = False):
        """Next result in completion order."""
        if not self.has_next():
            raise StopIteration("No more results to get")
        done, _ = ray_tpu_torch.wait(list(self._future_to_actor),
                               num_returns=1, timeout=timeout)
        if not done:
            if ignore_if_timedout:
                return None
            raise TimeoutError("Timed out waiting for result")
        future = done[0]
        i, actor = self._future_to_actor.pop(future)
        self._index_to_future.pop(i, None)
        # keep ordered retrieval consistent after unordered consumption
        # (reference actor_pool.py does the same max-advance): a later
        # get_next() must not look up an index already taken here
        self._next_return_index = max(self._next_return_index, i + 1)
        self._return_actor(actor)
        return ray_tpu_torch.get(future)

    def _return_actor(self, actor) -> None:
        self._idle_actors.append(actor)
        while self._pending_submits and self._idle_actors:
            fn, value = self._pending_submits.pop(0)
            self.submit(fn, value)

    # ------------------------------------------------------------- scaling

    def pop_idle(self):
        """Remove and return an idle actor (None if all are busy)."""
        return self._idle_actors.pop() if self.has_free() else None

    def push(self, actor) -> None:
        """Add an actor to the pool."""
        busy = {a for _, a in self._future_to_actor.values()}
        if actor in self._idle_actors or actor in busy:
            raise ValueError("Actor already belongs to current ActorPool")
        self._return_actor(actor)
