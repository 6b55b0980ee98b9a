"""Worker bootstrap shim: build the pip/conda runtime env, then exec worker_main.

The port's copy of ray_tpu/_private/worker_boot.py. Spawned instead of
worker_main when the runtime env carries a "pip" or "conda" field: the
(possibly slow) env creation happens HERE, in the worker process (through
the host's runtime-env agent where one runs), so the scheduler thread never
blocks on pip; the process then re-execs under the env's interpreter with
ray_tpu_torch's location pinned on PYTHONPATH. The shim imports no torch,
so nothing creates a CUDA context before the exec, and the exec keeps the
process env: a GPU worker's CUDA_VISIBLE_DEVICES grant reaches the
interpreter that runs its tasks.

(reference: the runtime-env agent materializes envs before worker start,
_private/runtime_env/agent/runtime_env_agent.py:165.)
"""

from __future__ import annotations

import json
import os
import sys

from ray_tpu_torch._private.runtime_env_container import WORKER_MAIN


def _reexec_under(python: str) -> None:
    # ray_tpu_torch itself isn't installed into the env: pin its parent dir
    pkg_parent = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    pp = os.environ.get("PYTHONPATH", "")
    parts = [p for p in pp.split(os.pathsep) if p]
    if pkg_parent not in parts:
        parts.insert(0, pkg_parent)
    os.environ["PYTHONPATH"] = os.pathsep.join(parts)
    os.execv(python, [python, "-m", WORKER_MAIN])


def main():
    renv = json.loads(os.environ.get("RAY_TPU_TORCH_RUNTIME_ENV") or "{}")
    conda_spec = renv.get("conda")
    pip_spec = renv.get("pip")
    if conda_spec and pip_spec:
        raise SystemExit(
            "runtime_env cannot combine 'conda' and 'pip' — put pip "
            "packages under the conda spec's dependencies instead")
    agent_sock = os.environ.get("RAY_TPU_TORCH_RENV_AGENT_SOCK")
    if agent_sock and (conda_spec or pip_spec):
        # per-host runtime-env agent: concurrent workers needing the same
        # env share ONE build and a broken env fails fast with the agent's
        # error; fall back to the local build path if the agent is gone
        reply = None
        try:
            from ray_tpu_torch._private import runtime_env_agent
            from ray_tpu_torch._private.protocol import ConnectionClosed

            reply = runtime_env_agent.get_or_create(agent_sock, renv)
        except (OSError, ConnectionError, ConnectionClosed):
            # agent unreachable: local fallback below. An agent-REPORTED
            # build failure (RuntimeError) propagates — retrying the same
            # broken build locally would just boot-loop the worker.
            pass
        # _reexec_under runs OUTSIDE the try: a KeyError/OSError raised
        # from inside the exec path must surface, not be misread as
        # "agent unreachable" and silently fall through to a second
        # build under the wrong interpreter assumption
        if reply is not None and reply.get("python"):
            _reexec_under(reply["python"])
    if conda_spec:
        from ray_tpu_torch._private.runtime_env_conda import ensure_conda_env

        _reexec_under(ensure_conda_env(conda_spec))
    if pip_spec:
        from ray_tpu_torch._private.runtime_env_pip import ensure_venv

        _reexec_under(ensure_venv(pip_spec))
    from ray_tpu_torch._private import worker_main

    sys.exit(worker_main.main())


if __name__ == "__main__":
    main()
