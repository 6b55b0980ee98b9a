"""Both packages' DreamerV3 on tests/test_rllib_dreamer.py's config, on the
CPU, curve by curve.

    JAX_PLATFORMS=cpu python tests/rllib_dreamer_curves.py [--seeds 0 ...]
        [--packages ray_tpu ray_tpu_torch]

For each package and seed, prints one JSON line: the mean return after
each of the 40 iterations, the last ``wm_loss``, whether the reference
test's bar holds (``max(rets[-10:]) > 60`` and ``wm_loss < 2.0``) and the
run's seconds. Each package starts from its own init: a torch generator
draws other weights than JAX's PRNG from the same seed.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ITERS = 40


def curve(pkg: str, seed: int) -> dict:
    import importlib

    rt = importlib.import_module(pkg)
    cfg = (importlib.import_module(f"{pkg}.rllib").DreamerV3Config()
           .environment("CartPole-v1")
           .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                        rollout_fragment_length=64)
           .training(learning_starts=512, num_updates_per_step=8)
           .debugging(seed=seed))
    if pkg == "ray_tpu_torch":
        cfg = cfg.learners(device="cpu")
    rt.shutdown()
    rt.init(num_cpus=16, num_workers=2, max_workers=10)
    t0 = time.perf_counter()
    try:
        algo = cfg.build()
        rets, res = [], {}
        for _ in range(ITERS):
            res = algo.train()
            r = res["env_runners"]["episode_return_mean"]
            if not math.isnan(r):
                rets.append(r)
        algo.stop()
    finally:
        rt.shutdown()
    wm = res["learners"]["wm_loss"]
    return {"package": pkg, "seed": seed, "returns": rets, "wm_loss": wm,
            "bar": bool(rets) and max(rets[-10:]) > 60.0 and wm < 2.0,
            "s": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--packages", nargs="+",
                    default=["ray_tpu", "ray_tpu_torch"])
    args = ap.parse_args(argv)
    sys.path[:0] = [os.path.dirname(HERE)]
    import jax

    jax.config.update("jax_platforms", "cpu")
    import torch

    torch.set_num_threads(1)
    for seed in args.seeds:
        for pkg in args.packages:
            print(json.dumps(curve(pkg, seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
