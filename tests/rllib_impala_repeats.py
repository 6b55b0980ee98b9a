"""IMPALA and APPO at the reference tests' config, run again and again:
how often their bar (the max of the last 4 mean returns > 40 after 16
iterations, tests/test_rllib_impala.py and tests/test_rllib_appo_sac.py)
holds, for each number of batches a runner's stream may hold ahead of the
learner (``impala.STREAM_AHEAD``; the runtime's default is 16).

    python tests/rllib_impala_repeats.py --runs 6 --ahead 16 2
    python tests/rllib_impala_repeats.py --runs 6 --ahead 16 2 \\
        --device cpu --delay-ms 12

The learner is on the card unless ``--device cpu``; ``--delay-ms`` adds a
sleep after each learner update (a slower learner, as the card's
launch-bound one is beside two CPU runners). Prints one JSON line a run,
then one a setting.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=6)
    ap.add_argument("--ahead", type=int, nargs="+", default=[16, 2])
    ap.add_argument("--algos", nargs="+", default=["IMPALA", "APPO"])
    ap.add_argument("--device", default=None)
    ap.add_argument("--delay-ms", type=float, default=0.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch import rllib
    from ray_tpu_torch.rllib.algorithms import impala

    torch.set_num_threads(1)
    update = impala.ImpalaLearner.update

    def delayed(self, batch):
        out = update(self, batch)
        time.sleep(args.delay_ms / 1e3)
        return out

    if args.delay_ms:
        impala.ImpalaLearner.update = delayed
    rt.init(num_cpus=16, num_workers=2, max_workers=10)
    try:
        for name in args.algos:
            for ahead in args.ahead:
                impala.STREAM_AHEAD = ahead
                best = []
                for k in range(args.runs):
                    cfg = (getattr(rllib, f"{name}Config")()
                           .environment("CartPole-v1")
                           .env_runners(num_env_runners=2,
                                        num_envs_per_env_runner=8,
                                        rollout_fragment_length=48)
                           .training(lr=3e-3, **({"clip_param": 0.3}
                                                 if name == "APPO" else {}))
                           .learners(device=args.device)
                           .debugging(seed=0))
                    algo = cfg.build()
                    rets = []
                    for _ in range(16):
                        r = algo.train()["env_runners"]["episode_return_mean"]
                        if r == r:
                            rets.append(round(r, 2))
                    algo.stop()
                    best.append(max(rets[-4:]))
                    print(json.dumps({"algo": name, "ahead": ahead,
                                      "delay_ms": args.delay_ms, "run": k,
                                      "best_last4": best[-1],
                                      "returns": rets}), flush=True)
                print(json.dumps({"algo": name, "ahead": ahead,
                                  "delay_ms": args.delay_ms,
                                  "device": args.device or "cuda",
                                  "passed": sum(b > 40.0 for b in best),
                                  "runs": args.runs, "best_last4": best}),
                      flush=True)
    finally:
        rt.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
