"""Entry point for worker subprocesses.

(reference: the worker main loop in python/ray/_private/workers/default_worker.py
+ the execute-task callback _raylet.pyx:1823.)
"""

from __future__ import annotations

import os
import sys


def main():
    # head-host workers get the session unix socket; follower-host workers
    # (spawned by a node agent) get the GCS TCP address instead
    address = os.environ.get("RAY_TPU_TORCH_ADDRESS") or f"unix:{os.environ['RAY_TPU_TORCH_SOCKET']}"
    session_id = os.environ["RAY_TPU_TORCH_SESSION"]
    from ray_tpu_torch._private.worker import CoreWorker, set_global_worker

    worker = CoreWorker(address, session_id, kind="worker")
    set_global_worker(worker)
    renv_json = os.environ.get("RAY_TPU_TORCH_RUNTIME_ENV")
    if renv_json:
        # materialize working_dir / py_modules from the GCS package cache
        # before any task runs (reference: worker start through the
        # runtime-env agent, runtime_env_agent.py:303)
        import json

        from ray_tpu_torch import runtime_env as _renv

        _renv.apply_to_process(json.loads(renv_json), worker.kv_get)
    code = 0
    try:
        worker.exec_loop()
    except BaseException:
        import traceback

        traceback.print_exc()  # worker log captures stderr
        code = 1
    finally:
        worker.disconnect()
        # hard exit: concurrent-actor pool threads are non-daemon and may be
        # mid-task (or blocked on a dead GCS); threading._shutdown would join
        # them forever and leak this process past driver death
        os._exit(code)


if __name__ == "__main__":
    sys.exit(main())
