"""RemoteFunction: the @ray_tpu_torch.remote wrapper for functions.

(reference: python/ray/remote_function.py:41 — options plumbing mirrors
_remote at remote_function.py:313.)
"""

from __future__ import annotations

import functools
from typing import Any

from ray_tpu_torch._private import serialization as ser

_UNSET = object()


def _build_resources(num_cpus, num_gpus, resources) -> dict:
    out = {"CPU": 1.0 if num_cpus is None else float(num_cpus)}
    if num_gpus:
        from ray_tpu_torch._private.accelerators import validate_num_gpus

        validate_num_gpus(num_gpus)
        out["GPU"] = float(num_gpus)
    if resources:
        out.update({k: float(v) for k, v in resources.items()})
    if out.get("CPU") == 0.0:
        out.pop("CPU")
    return out


class RemoteFunction:
    def __init__(self, func, *, num_cpus=None, num_gpus=None, resources=None,
                 num_returns=1, max_retries=None, scheduling_strategy=None,
                 runtime_env=None):
        self._func = func
        self._num_returns = num_returns
        if max_retries is None:
            from ray_tpu_torch._private.ray_config import RayConfig

            max_retries = RayConfig.get("default_max_retries")
        self._max_retries = max_retries
        self._opts = {"num_cpus": num_cpus, "num_gpus": num_gpus, "resources": resources}
        self._resources = _build_resources(num_cpus, num_gpus, resources)
        self._strategy = scheduling_strategy
        self._runtime_env = runtime_env
        self._blob: bytes | None = None
        self._blob_sha: str | None = None
        functools.update_wrapper(self, func)

    def _get_blob(self) -> bytes:
        if self._blob is None:
            import hashlib

            blob = ser.dumps(self._func)
            # sha assigned BEFORE _blob: a racing reader seeing _blob set is
            # then guaranteed to see the sha too
            self._blob_sha = hashlib.sha1(blob).hexdigest()[:20]
            self._blob = blob
        return self._blob

    def options(self, *, num_cpus=None, num_gpus=None, resources=None,
                num_returns=None, max_retries=None, scheduling_strategy=_UNSET,
                runtime_env=_UNSET, **_ignored) -> "RemoteFunction":
        rf = RemoteFunction(
            self._func,
            num_cpus=self._opts["num_cpus"] if num_cpus is None else num_cpus,
            num_gpus=self._opts["num_gpus"] if num_gpus is None else num_gpus,
            resources=self._opts["resources"] if resources is None else resources,
            num_returns=self._num_returns if num_returns is None else num_returns,
            max_retries=self._max_retries if max_retries is None else max_retries,
            scheduling_strategy=(self._strategy if scheduling_strategy is _UNSET
                                 else scheduling_strategy),
            runtime_env=(self._runtime_env if runtime_env is _UNSET
                         else runtime_env),
        )
        rf._blob = self._blob
        rf._blob_sha = self._blob_sha
        return rf

    def remote(self, *args, **kwargs):
        from ray_tpu_torch._private.api import _get_worker
        from ray_tpu_torch.util.scheduling_strategies import strategy_to_spec

        worker = _get_worker()
        refs = worker.submit_task(
            self._get_blob() if worker.kind != "local" else self._func,
            args,
            kwargs,
            func_sha=self._blob_sha,
            num_returns=self._num_returns,
            resources=self._resources,
            max_retries=self._max_retries,
            name=getattr(self._func, "__name__", "task"),
            strategy=strategy_to_spec(self._strategy),
            runtime_env=self._runtime_env,
        )
        if self._num_returns == "streaming":
            return refs  # an ObjectRefGenerator (reference: _raylet.pyx:299)
        return refs[0] if self._num_returns == 1 else refs

    def __call__(self, *args, **kwargs):
        raise TypeError(
            "Remote functions cannot be called directly; use .remote() "
            "(or access the original function via .func)."
        )

    @property
    def func(self):
        return self._func
