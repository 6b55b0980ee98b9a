"""The JAX package's MARWIL against the port's, seed by seed, on the CPU.

    JAX_PLATFORMS=cpu python tests/rllib_marwil_seeds.py write-init \
        tests/data/marwil_init_seed0.npz
    JAX_PLATFORMS=cpu python tests/rllib_marwil_seeds.py sweep 10

``write-init`` saves the JAX package's MARWIL initial params at seed 0, on
tests/test_rllib_offline.py's config, through its checkpoint_io: the start
chip_smoke.py's phase 23d gives the port's MARWIL on the card, which has no
JAX. ``sweep`` prints, as JSON lines, each package's evaluation return
after each of the 12 iterations of that config for seeds 0..n-1 (each from
its own package's init: a torch generator draws other weights than JAX's
PRNG from the same seed), then the port's from the reference's seed-0
init.
"""

from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ITERS = 12


def _setup():
    sys.path[:0] = [HERE, os.path.dirname(HERE)]
    import jax

    jax.config.update("jax_platforms", "cpu")
    import torch

    torch.set_num_threads(1)


def _config(pkg: str, rows, seed: int):
    import importlib

    cfg = (importlib.import_module(f"{pkg}.rllib").MARWILConfig()
           .offline(offline_data=rows, obs_dim=4, num_actions=2,
                    train_batch_size=256, beta=1.0)
           .training(lr=3e-3).debugging(seed=seed))
    return cfg.learners(device="cpu") if pkg == "ray_tpu_torch" else cfg


def reference_init(rows, seed: int = 0) -> dict:
    """The JAX package's MARWIL params at `seed`, as numpy leaves."""
    import jax

    return jax.device_get(_config("ray_tpu", rows, seed).build().params)


def _curve(algo) -> list:
    from test_rllib_offline import _eval_discrete

    out = []
    for _ in range(ITERS):
        algo.train()
        out.append(_eval_discrete(algo))
    return out


def main(argv) -> int:
    _setup()
    from test_rllib_offline import _cartpole_mixed_dataset

    rows = _cartpole_mixed_dataset()
    if argv[:1] == ["write-init"] and len(argv) == 2:
        from ray_tpu.llm import checkpoint_io

        checkpoint_io.save_params(reference_init(rows), argv[1])
        return 0
    if argv[:1] == ["sweep"] and len(argv) == 2:
        from ray_tpu_torch.rllib.algorithm import _merge

        for seed in range(int(argv[1])):
            for pkg in ("ray_tpu", "ray_tpu_torch"):
                print(json.dumps({"package": pkg, "seed": seed,
                                  "eval_returns": _curve(
                                      _config(pkg, rows, seed).build())}),
                      flush=True)
        algo = _config("ray_tpu_torch", rows, 0).build()
        _merge(algo.params, reference_init(rows))
        print(json.dumps({"package": "ray_tpu_torch", "seed": 0,
                          "init": "ray_tpu seed 0",
                          "eval_returns": _curve(algo)}), flush=True)
        return 0
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
