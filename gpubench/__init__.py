"""The benchmark of the PyTorch and CUDA port (``ray_tpu_torch``).

``python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything a cell needs is found by name: its configuration in
``configs/<config>.json``, its traffic mix in ``traffic/<traffic>.json``
(which names the driver in ``drivers/``), its correctness limits in
``limits/<cell>.json`` and each per-layer metric's reader in
``metrics/<metric>.py``. ``reference/`` holds the plain float32 models the
served and trained results are judged against; ``ops/`` the FLOP and byte
counts of each operation and the kernels that implement it.

Nothing here imports ``jax`` or the JAX package ``ray_tpu``.
"""
