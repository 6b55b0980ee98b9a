"""The worker spawn argv.

The port's copy of the argv builder of ray_tpu/_private/runtime_env_container.py:
every worker boots ``python -m ray_tpu_torch._private.worker_main`` (never
the JAX package's). Container runtime envs (``image_uri``, a worker under
``podman run``) and the pip/conda boot shim are not ported yet (ROADMAP.md
Queue 1 item 18): ``runtime_env.package`` refuses them, and so does this
builder for a container env.
"""

from __future__ import annotations

import sys

from ray_tpu_torch.exceptions import _not_ported

WORKER_MAIN = "ray_tpu_torch._private.worker_main"


def build_worker_argv(runtime_env: dict | None) -> list:
    """The spawn argv for one worker given its runtime env."""
    if runtime_env and runtime_env.get("image_uri"):
        raise _not_ported("runtime_env['image_uri'] (container workers)",
                          "item 18")
    return [sys.executable, "-m", WORKER_MAIN]
