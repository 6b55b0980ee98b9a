"""@serve.batch — transparent dynamic request batching.

(reference: python/ray/serve/batching.py — queued requests are flushed to the
wrapped function as a list when max_batch_size is reached or
batch_wait_timeout_s elapses; each caller gets its own element back. The
reference is asyncio; here callers are replica threads (max_concurrency > 1)
blocking on futures, flushed by a dedicated thread per wrapped function.)
"""

from __future__ import annotations

import functools
import threading
from concurrent.futures import Future


class _BatchQueue:
    def __init__(self, fn, max_batch_size: int, batch_wait_timeout_s: float):
        self.fn = fn
        self.max_batch_size = max_batch_size
        self.timeout_s = batch_wait_timeout_s
        self.items: list[tuple[object, Future]] = []
        self.lock = threading.Lock()
        self.not_empty = threading.Condition(self.lock)
        self.thread = threading.Thread(target=self._flush_loop, daemon=True,
                                       name="serve-batch")
        self.thread.start()

    def submit(self, instance, item) -> Future:
        fut: Future = Future()
        with self.lock:
            self.items.append((instance, item, fut))
            self.not_empty.notify()
        return fut

    def _flush_loop(self):
        while True:
            with self.not_empty:
                while not self.items:
                    self.not_empty.wait()
                # wait for more work up to the batch window; only items for
                # the instance at the head of the queue count toward a full
                # batch (that's all the flush below will take)
                head = self.items[0][0]

                def _head_count():
                    return sum(1 for inst, _, _ in self.items if inst is head)

                if _head_count() < self.max_batch_size:
                    self.not_empty.wait_for(
                        lambda: _head_count() >= self.max_batch_size,
                        timeout=self.timeout_s)
                # flush only items bound to the same instance — a queue is
                # per-function per-process, but a decorated method may be
                # called on several instances, and a batch must run against
                # the instance its callers used
                inst0 = self.items[0][0]
                batch, rest = [], []
                for tup in self.items:
                    if len(batch) < self.max_batch_size and tup[0] is inst0:
                        batch.append(tup)
                    else:
                        rest.append(tup)
                self.items = rest
                if rest:
                    self.not_empty.notify()
            instance = batch[0][0]
            inputs = [item for _, item, _ in batch]
            futures = [f for _, _, f in batch]
            try:
                outputs = (self.fn(instance, inputs) if instance is not None
                           else self.fn(inputs))
                if len(outputs) != len(inputs):
                    raise ValueError(
                        f"batch function returned {len(outputs)} results "
                        f"for {len(inputs)} inputs")
                for f, out in zip(futures, outputs):
                    f.set_result(out)
            except Exception as e:  # noqa: BLE001 — propagate to all callers
                for f in futures:
                    f.set_exception(e)


# lazy-creation guard: module-level so wrapped functions stay picklable
# (closures must hold only plain data — they ship to replicas by value)
_create_lock = threading.Lock()


def batch(_fn=None, *, max_batch_size: int = 8, batch_wait_timeout_s: float = 0.01,
          result_timeout_s: float | None = None):
    """Decorator for methods/functions taking a single request; the wrapped
    implementation receives a list and returns a list. `result_timeout_s`
    bounds each caller's wait (None = wait for the batch however long)."""

    def wrap(fn):
        state: dict = {"queue": None}  # per-process queue, created on first call

        def get_queue():
            # import at call time: this closure ships to replicas by value,
            # so it must not capture locks/classes as globals
            from ray_tpu_torch.serve import batching as _b

            q = state["queue"]
            if q is None:
                with _b._create_lock:
                    q = state["queue"]
                    if q is None:
                        q = state["queue"] = _b._BatchQueue(
                            fn, max_batch_size, batch_wait_timeout_s)
            return q

        @functools.wraps(fn)
        def method_wrapper(self, item):
            return get_queue().submit(self, item).result(timeout=result_timeout_s)

        @functools.wraps(fn)
        def fn_wrapper(item):
            return get_queue().submit(None, item).result(timeout=result_timeout_s)

        import inspect

        params = list(inspect.signature(fn).parameters)
        wrapper = method_wrapper if params and params[0] == "self" else fn_wrapper
        wrapper._is_serve_batch = True  # noqa: SLF001
        return wrapper

    if _fn is not None:
        return wrap(_fn)
    return wrap
