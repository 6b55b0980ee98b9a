"""The port's TPE searcher and elastic train scaling against the JAX
package's.

Twins of tests/test_tune_search_elastic.py: TPE as a unit (both packages in
turn, the same seeds give the same suggestions), a Tuner driven by TPE,
and a trainer sized down to what a 4-CPU cluster can place, on both
runtimes (one module-scoped session each).
"""

from __future__ import annotations

import numpy as np
import pytest

from torch_twins import pair, same, start_sessions, sub


@pytest.fixture(scope="module")
def pkgs():
    pkgs = start_sessions(num_cpus=4, num_workers=1, max_workers=8)
    yield pkgs
    for rt in pkgs:
        rt.shutdown()


def test_tpe_searcher_beats_random_on_quadratic():
    def scn(rt):
        search = sub(rt, "tune.search")
        space = {"x": search.uniform(-10, 10), "y": search.uniform(-10, 10)}
        s = search.TPESearcher(space, num_samples=60, n_startup=10, seed=0)
        s.set_search_properties("loss", "min")
        early, late = [], []
        for i in range(60):
            cfg = s.suggest(f"t{i}")
            val = (cfg["x"] - 3) ** 2 + (cfg["y"] + 1) ** 2
            (early if i < 10 else late).append(val)
            s.on_trial_complete(f"t{i}", {"loss": val})
        return (s.suggest("t61"),
                bool(np.mean(sorted(late)[:10]) < np.mean(sorted(early)[:10])),
                early + late)

    assert pair(scn)[:2] == (None, True)


def test_tpe_with_categorical_and_int():
    def scn(rt):
        search = sub(rt, "tune.search")
        space = {"act": search.choice(["relu", "tanh"]),
                 "width": search.randint(8, 64)}
        s = search.TPESearcher(space, num_samples=20, n_startup=5, seed=1)
        s.set_search_properties("score", "max")
        for i in range(20):
            cfg = s.suggest(f"t{i}")
            score = (1.0 if cfg["act"] == "tanh" else 0.0) + \
                cfg["width"] / 64.0
            s.on_trial_complete(f"t{i}", {"score": score})
        tanh_late = [c for (c, v) in s._history[10:] if c["act"] == "tanh"]
        return len(tanh_late) >= len(s._history[10:]) // 2, s._history

    assert pair(scn)[0] is True


def test_tuner_runs_with_tpe(pkgs, tmp_path):
    def scn(rt):
        pkg, tune = rt.__name__, sub(rt, "tune")
        space = {"lr": sub(rt, "tune.search").uniform(0.001, 1.0)}

        def objective(config):
            import importlib

            importlib.import_module(pkg + ".train").report(
                {"loss": (config["lr"] - 0.3) ** 2})

        results = tune.Tuner(
            objective, param_space=space,
            tune_config=tune.TuneConfig(
                metric="loss", mode="min",
                search_alg=tune.TPESearcher(space, num_samples=8,
                                            n_startup=3, seed=0)),
            run_config=sub(rt, "train").RunConfig(
                name="tpe", storage_path=str(tmp_path / pkg))).fit()
        best = results.get_best_result(metric="loss", mode="min")
        return best.metrics["loss"] < 1.0, len(results)

    same(pkgs, scn, (True, 8), serve_cleanup=False)


def test_elastic_trainer_downsizes_to_available(pkgs, tmp_path):
    """num_workers=8 with min_workers=1 on a 4-CPU cluster: the controller
    sizes the group to what fits instead of hanging or failing."""
    def scn(rt):
        pkg, train = rt.__name__, sub(rt, "train")

        def train_fn(config):
            import importlib

            tr = importlib.import_module(pkg + ".train")
            ctx = tr.get_context()
            tr.report({"world": ctx.get_world_size(),
                       "rank": ctx.get_world_rank()})

        result = train.DataParallelTrainer(
            train_fn,
            scaling_config=train.ScalingConfig(
                num_workers=8, min_workers=1,
                resources_per_worker={"CPU": 1}),
            run_config=train.RunConfig(name="elastic_test",
                                       storage_path=str(tmp_path / pkg)),
        ).fit()
        return result.error, 1 <= result.metrics["world"] < 8

    same(pkgs, scn, (None, True), serve_cleanup=False, sequential=True)


def test_fixed_scaling_unchanged(pkgs, tmp_path):
    def scn(rt):
        pkg, train = rt.__name__, sub(rt, "train")

        def train_fn(config):
            import importlib

            tr = importlib.import_module(pkg + ".train")
            tr.report({"world": tr.get_context().get_world_size()})

        return train.DataParallelTrainer(
            train_fn, scaling_config=train.ScalingConfig(num_workers=2),
            run_config=train.RunConfig(name="fixed_test",
                                       storage_path=str(tmp_path / pkg)),
        ).fit().metrics["world"]

    same(pkgs, scn, 2, serve_cleanup=False, sequential=True)
