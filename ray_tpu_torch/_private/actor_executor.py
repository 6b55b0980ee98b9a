"""Per-actor execution engine: concurrency groups, threaded + async methods.

Reference capability: the core_worker task-execution stack —
`ConcurrencyGroupManager` routing methods to named thread pools
(src/ray/core_worker/task_execution/concurrency_group_manager.h), fiber
support for `async def` actor methods (fiber.h), and the per-actor
scheduling queues (actor_scheduling_queue.h).

Semantics:
- plain actor, max_concurrency=1 → methods run inline on the exec loop
  thread (strict ordering, as before);
- max_concurrency>1 → a default thread pool of that size;
- concurrency_groups={"name": limit} → one pool per group; methods pick a
  group via `@ray_tpu_torch.method(concurrency_group="name")`, others use the
  default pool;
- `async def` methods → a dedicated asyncio event loop thread; the group
  limit is enforced with an asyncio.Semaphore per group, so thousands of
  coroutines can interleave on one loop (reference: async actors).
"""

from __future__ import annotations

import asyncio
import inspect
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Optional

from ray_tpu_torch._private.constants import CONCURRENCY_GROUP_ATTR


def method_concurrency_group(instance, method_name: str) -> Optional[str]:
    fn = getattr(type(instance), method_name, None)
    return getattr(fn, CONCURRENCY_GROUP_ATTR, None)


class ActorExecutor:
    def __init__(self, instance, *, max_concurrency: int = 1,
                 concurrency_groups: Optional[Dict[str, int]] = None):
        self.instance = instance
        self.max_concurrency = max(1, int(max_concurrency))
        self.groups = {str(k): max(1, int(v))
                       for k, v in (concurrency_groups or {}).items()}
        self._pools: Dict[str, ThreadPoolExecutor] = {}
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._loop_started = threading.Event()
        self._sems: Dict[str, asyncio.Semaphore] = {}
        self._lock = threading.Lock()
        # async detection: any coroutine method on the class
        self.has_async = any(
            inspect.iscoroutinefunction(m)
            for _, m in inspect.getmembers(type(instance),
                                           predicate=inspect.isfunction))
        if self.has_async:
            t = threading.Thread(target=self._run_loop, daemon=True,
                                 name="actor-asyncio")
            t.start()
            self._loop_started.wait(10)

    # -- async plumbing ----------------------------------------------------

    def _run_loop(self):
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop
        self._loop_started.set()
        loop.run_forever()

    def _sem_for(self, group: Optional[str]) -> asyncio.Semaphore:
        key = group or "_default"
        sem = self._sems.get(key)
        if sem is None:
            limit = (self.groups.get(group) if group else None) \
                or self.max_concurrency
            sem = self._sems[key] = asyncio.Semaphore(limit)
        return sem

    def run_coroutine_sync(self, coro):
        """Execute a coroutine on the actor's loop, blocking the calling
        thread until it resolves (used when execute_task runs an async
        method from a pool thread)."""
        fut = asyncio.run_coroutine_threadsafe(coro, self._loop)
        return fut.result()

    # -- dispatch ----------------------------------------------------------

    def _pool_for(self, group: Optional[str]) -> Optional[ThreadPoolExecutor]:
        """Thread pool for sync methods (None → run inline, ordered)."""
        if group is not None and group in self.groups:
            with self._lock:
                pool = self._pools.get(group)
                if pool is None:
                    pool = self._pools[group] = ThreadPoolExecutor(
                        max_workers=self.groups[group],
                        thread_name_prefix=f"actor-{group}")
            return pool
        if self.max_concurrency > 1 or self.groups:
            with self._lock:
                pool = self._pools.get("_default")
                if pool is None:
                    pool = self._pools["_default"] = ThreadPoolExecutor(
                        max_workers=self.max_concurrency,
                        thread_name_prefix="actor-exec")
            return pool
        return None

    def submit(self, spec: dict, execute: Callable[[dict], None]) -> None:
        """Route one actor_task spec: async methods onto the event loop
        (bounded by their group's semaphore), sync methods onto their
        group's thread pool (or inline for plain actors)."""
        method_name = spec.get("method", "")
        fn = getattr(type(self.instance), method_name, None)
        group = getattr(fn, CONCURRENCY_GROUP_ATTR, None)
        if self.has_async and fn is not None and inspect.iscoroutinefunction(fn):
            sem = self._sem_for(group)

            async def bounded():
                async with sem:
                    # execute() resolves args and serializes results; the
                    # coroutine itself runs via run_coroutine_sync on THIS
                    # loop — so run execute in a thread to avoid blocking
                    # the loop on non-async work
                    await asyncio.get_event_loop().run_in_executor(
                        self._exec_pool(), execute, spec)

            asyncio.run_coroutine_threadsafe(bounded(), self._loop)
            return
        pool = self._pool_for(group)
        if pool is not None:
            pool.submit(execute, spec)
        else:
            execute(spec)

    def _exec_pool(self) -> ThreadPoolExecutor:
        with self._lock:
            pool = self._pools.get("_async_exec")
            if pool is None:
                # one thread per admitted call: the GCS gates dispatch at the
                # total concurrency bound, so sizing the pool to that bound
                # guarantees every in-flight call owns a thread — a smaller
                # pool deadlocks coordination actors (a send() queued behind
                # blocked wait()ers would never run)
                width = self.max_concurrency + sum(self.groups.values())
                pool = self._pools["_async_exec"] = ThreadPoolExecutor(
                    max_workers=max(4, width), thread_name_prefix="actor-async")
            return pool

    def shutdown(self):
        for pool in self._pools.values():
            pool.shutdown(wait=False)
        if self._loop is not None:
            self._loop.call_soon_threadsafe(self._loop.stop)
