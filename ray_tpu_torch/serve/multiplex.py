"""Model multiplexing: many models per replica with LRU eviction.

(reference: python/ray/serve/multiplex.py _ModelMultiplexWrapper + api.py
`multiplexed` — the decorated loader caches up to max_num_models_per_replica
models; the router prefers replicas that already hold the requested model.)
"""

from __future__ import annotations

import collections
import functools
import threading

# module-level: wrapped loaders ship to replicas by value and must not
# capture locks in their closure
_mux_lock = threading.Lock()


def multiplexed(_fn=None, *, max_num_models_per_replica: int = 3):
    def wrap(load_fn):
        cache: collections.OrderedDict = collections.OrderedDict()
        loading: dict = {}  # key → threading.Event (load in progress)

        @functools.wraps(load_fn)
        def get_model(self_or_id, model_id=None):
            from ray_tpu_torch.serve.multiplex import _mux_lock as lock

            # supports both method (self, model_id) and function (model_id)
            key = model_id if model_id is not None else self_or_id
            while True:
                with lock:
                    if key in cache:
                        cache.move_to_end(key)
                        return cache[key]
                    ev = loading.get(key)
                    if ev is None:
                        import threading as _t

                        loading[key] = _t.Event()
                        break  # this thread loads
                ev.wait(timeout=120.0)  # another thread is loading this model
            try:
                model = (load_fn(self_or_id, key) if model_id is not None
                         else load_fn(key))
                with lock:
                    cache[key] = model
                    cache.move_to_end(key)
                    while len(cache) > max_num_models_per_replica:
                        evicted_id, evicted = cache.popitem(last=False)
                        del_fn = getattr(evicted, "__del__", None)
                        if del_fn is not None:
                            try:
                                del_fn()
                            except Exception:
                                pass
            finally:
                with lock:
                    loading.pop(key).set()
            return model

        get_model._is_multiplexed = True  # noqa: SLF001
        return get_model

    if _fn is not None:
        return wrap(_fn)
    return wrap
