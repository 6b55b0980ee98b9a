"""Cross-language (C++) workers: not ported yet.

The JAX package's ``cross_lang.py`` builds a C++ worker binary that joins a
session and runs registered functions by name over a JSON codec. The port
has no C++ worker yet (ROADMAP.md Queue 1 item 22): both entry points
raise, naming that item.
"""

from __future__ import annotations

from ray_tpu_torch.exceptions import _not_ported


def cpp_function(name: str):
    """Handle to a registered C++ function (not ported)."""
    raise _not_ported(f"cpp_function({name!r}) (C++ workers)", "item 22")


def start_cpp_worker(address: str | None = None):
    """Start a C++ worker process (not ported)."""
    raise _not_ported("start_cpp_worker (C++ workers)", "item 22")
