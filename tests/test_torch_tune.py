"""The port's Tune against the JAX package's.

Twins of tests/test_tune.py: grid and random search, ASHA, stop criteria,
errored trials, PBT and PB2 exploiting checkpoints, the searchers as
units, and restoring an interrupted experiment. Each scenario runs through
both runtimes (one module-scoped session each, tests/torch_twins.py) and
returns what the reference test asserts; the timed schedulers run one
runtime after the other. Objectives reach their package by name, so a
worker unpickles them by value and never imports this file.
"""

from __future__ import annotations

import json
import os

import pytest

from torch_twins import pair, same, start_sessions, sub


@pytest.fixture(scope="module")
def pkgs():
    pkgs = start_sessions(num_cpus=16, num_workers=2, max_workers=12)
    yield pkgs
    for rt in pkgs:
        rt.shutdown()


@pytest.fixture
def fresh_pkgs():
    """Both runtimes started anew, as the reference's per-test cluster: the
    PBT tests need both trials' runners up at once, on the pre-started
    workers, before the weak trial's 12 paced steps are over. It replaces
    the module's sessions, so the tests that take it come last."""
    pkgs = start_sessions(num_cpus=16, num_workers=2, max_workers=12)
    yield pkgs
    for rt in pkgs:
        rt.shutdown()


def _same(pkgs, scn, want=None, **kw):
    return same(pkgs, scn, want, serve_cleanup=False, **kw)


def _run_config(rt, name, tmp_path):
    return sub(rt, "train").RunConfig(
        name=name, storage_path=str(tmp_path / rt.__name__))


def test_grid_search_finds_best(pkgs, tmp_path):
    def scn(rt):
        pkg, tune = rt.__name__, sub(rt, "tune")

        def objective(config):
            import importlib

            importlib.import_module(pkg + ".tune").report(
                {"score": -(config["x"] - 3) ** 2})

        results = tune.Tuner(
            objective, param_space={"x": tune.grid_search([1, 2, 3, 4])},
            tune_config=tune.TuneConfig(metric="score", mode="max"),
            run_config=_run_config(rt, "grid", tmp_path)).fit()
        best = results.get_best_result()
        return (len(results), best.config["x"], best.metrics["score"],
                os.path.exists(tmp_path / pkg / "grid"
                               / "experiment_state.json"))

    _same(pkgs, scn, (4, 3, 0, True))


def test_random_search_num_samples(pkgs, tmp_path):
    def scn(rt):
        pkg, tune = rt.__name__, sub(rt, "tune")

        def objective(config):
            import importlib

            importlib.import_module(pkg + ".tune").report({"y": config["lr"]})

        results = tune.Tuner(
            objective, param_space={"lr": tune.loguniform(1e-4, 1e-1)},
            tune_config=tune.TuneConfig(metric="y", mode="min",
                                        num_samples=5,
                                        max_concurrent_trials=3),
            run_config=_run_config(rt, "rand", tmp_path)).fit()
        return len(results), all(1e-4 <= results[i].config["lr"] <= 1e-1
                                 for i in range(len(results)))

    _same(pkgs, scn, (5, True))


def test_asha_stops_bad_trials(pkgs, tmp_path):
    def scn(rt):
        pkg, tune = rt.__name__, sub(rt, "tune")

        def objective(config):
            import importlib
            import time

            t = importlib.import_module(pkg + ".tune")
            for i in range(1, 9):
                time.sleep(0.05)
                t.report({"acc": config["q"] * i})

        results = tune.Tuner(
            objective,
            param_space={"q": tune.grid_search([2.0, 1.0, 0.1, 0.0])},
            tune_config=tune.TuneConfig(
                metric="acc", mode="max",
                scheduler=tune.AsyncHyperBandScheduler(
                    grace_period=2, reduction_factor=2, max_t=8),
                max_concurrent_trials=1),
            run_config=_run_config(rt, "asha", tmp_path)).fit()
        worst = next(results[i] for i in range(len(results))
                     if results[i].config["q"] == 0.0)
        return (results.get_best_result().config["q"],
                worst.metrics["training_iteration"] < 8)

    _same(pkgs, scn, (2.0, True), sequential=True)


def test_stop_criteria(pkgs, tmp_path):
    def scn(rt):
        pkg, tune = rt.__name__, sub(rt, "tune")

        def objective(config):
            import importlib

            t = importlib.import_module(pkg + ".tune")
            for i in range(100):
                t.report({"i": i})

        results = tune.Tuner(
            objective, param_space={},
            tune_config=tune.TuneConfig(metric="i", mode="max",
                                        stop={"training_iteration": 5}),
            run_config=_run_config(rt, "stop", tmp_path)).fit()
        return results[0].metrics["training_iteration"] <= 6

    _same(pkgs, scn, True)


def test_errored_trial_reported(pkgs, tmp_path):
    def scn(rt):
        pkg, tune = rt.__name__, sub(rt, "tune")

        def objective(config):
            import importlib

            if config["x"] == 1:
                raise RuntimeError("bad trial")
            importlib.import_module(pkg + ".tune").report({"ok": 1})

        results = tune.Tuner(
            objective, param_space={"x": tune.grid_search([0, 1])},
            tune_config=tune.TuneConfig(metric="ok", mode="max"),
            run_config=_run_config(rt, "err", tmp_path)).fit()
        return (len(results.errors), "bad trial" in results.errors[0],
                results.get_best_result().config["x"])

    _same(pkgs, scn, (1, True, 0))


def _exploiter(pkg, started: str):
    """The weight-accumulating objective of the PBT and PB2 tests. The
    scheduler can only exploit while both trials run, so each trial's
    first start waits (30 s at most) until both have started: under load
    a trial runner's imports can take longer than the other trial's 12
    paced steps. A restarted trial finds both marks and does not wait."""
    def objective(config):
        import importlib
        import tempfile
        import time

        t = importlib.import_module(pkg + ".tune")
        Checkpoint = importlib.import_module(pkg + ".train").Checkpoint
        open(os.path.join(started, repr(config["lr"])), "a").close()
        deadline = time.monotonic() + 30.0
        while len(os.listdir(started)) < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        w = 0.0
        ckpt = t.get_checkpoint()
        if ckpt is not None:
            with ckpt.as_directory() as d:
                w = float(open(os.path.join(d, "rank_0", "w.txt")).read())
        for _ in range(1, 13):
            time.sleep(0.05)
            w += config["lr"]
            with tempfile.TemporaryDirectory() as d:
                open(os.path.join(d, "w.txt"), "w").write(str(w))
                t.report({"w": w}, checkpoint=Checkpoint.from_directory(d))

    return objective


def _started(tmp_path, rt) -> str:
    d = tmp_path / rt.__name__ / "started"
    d.mkdir(parents=True)
    return str(d)


def _same_sides(pkgs, scn):
    from torch_twins import twin

    return twin(pkgs, scn, sequential=True, serve_cleanup=False)


def test_searcher_unit_variant_counts():
    def scn(rt):
        tune = sub(rt, "tune")
        gen = tune.BasicVariantGenerator(
            {"a": tune.grid_search([1, 2]), "b": tune.choice([10]), "c": 7},
            num_samples=3)
        seen = [gen.suggest(str(i)) for i in range(6)]
        return (gen.total_trials, gen.suggest("x"),
                all(v["c"] == 7 and v["b"] == 10 for v in seen),
                sorted(v["a"] for v in seen))

    pair(scn, (6, None, True, [1, 1, 1, 2, 2, 2]))


def test_concurrency_limiter_unit():
    def scn(rt):
        tune = sub(rt, "tune")
        inner = tune.BasicVariantGenerator({"x": tune.uniform(0, 1)},
                                           num_samples=4)
        lim = tune.ConcurrencyLimiter(inner, max_concurrent=2)
        a, b = lim.suggest("t1"), lim.suggest("t2")
        third = lim.suggest("t3")
        lim.on_trial_complete("t1", {"x": 1})
        return (isinstance(a, dict), isinstance(b, dict), third,
                isinstance(lim.suggest("t3"), dict))

    pair(scn, (True, True, "PENDING", True))


def _scorer(pkg):
    def objective(config):
        import importlib

        importlib.import_module(pkg + ".tune").report(
            {"score": config["x"] * 10})

    return objective


def test_tuner_restore_resumes_unfinished(pkgs, tmp_path):
    def scn(rt):
        tune, objective = sub(rt, "tune"), _scorer(rt.__name__)
        first = len(tune.Tuner(
            objective, param_space={"x": tune.grid_search([1, 2, 3])},
            tune_config=tune.TuneConfig(metric="score", mode="max"),
            run_config=_run_config(rt, "resume", tmp_path)).fit())
        exp_dir = str(tmp_path / rt.__name__ / "resume")
        state_path = os.path.join(exp_dir, "experiment_state.json")
        with open(state_path) as f:
            state = json.load(f)
        state[1]["status"] = "RUNNING"
        interrupted = state[1]["config"]
        with open(state_path, "w") as f:
            json.dump(state, f)
        results = tune.Tuner.restore(exp_dir, objective).fit()
        rerun = [results[i] for i in range(len(results))
                 if results[i].config == interrupted]
        return (first, len(results),
                sorted(results[i].metrics["score"]
                       for i in range(len(results))),
                bool(rerun) and rerun[0].metrics["score"]
                == interrupted["x"] * 10)

    _same(pkgs, scn, (3, 3, [10, 20, 30], True))


def test_tuner_restore_runs_never_created_grid_trials(pkgs, tmp_path):
    def scn(rt):
        tune, objective = sub(rt, "tune"), _scorer(rt.__name__)
        first = len(tune.Tuner(
            objective, param_space={"x": tune.grid_search([1, 2, 3])},
            tune_config=tune.TuneConfig(metric="score", mode="max"),
            run_config=_run_config(rt, "resume2", tmp_path)).fit())
        exp_dir = str(tmp_path / rt.__name__ / "resume2")
        state_path = os.path.join(exp_dir, "experiment_state.json")
        with open(state_path) as f:
            state = json.load(f)[:2]
        with open(state_path, "w") as f:
            json.dump(state, f)
        results = tune.Tuner.restore(exp_dir, objective).fit()
        return first, len(results), sorted(
            results[i].metrics["score"] for i in range(len(results)))

    _same(pkgs, scn, (3, 3, [10, 20, 30]))


def test_pb2_gp_steers_toward_optimum():
    def scn(rt):
        tune = sub(rt, "tune")
        sched = tune.PB2(hyperparam_bounds={"lr": (0.0, 1.0)},
                         perturbation_interval=2, quantile_fraction=0.5,
                         seed=0)
        sched.set_search_properties("score", "max")
        rows = []
        for t in range(2, 13):
            for lr in (0.05, 0.2, 0.45, 0.75, 0.95):
                rows.append((float(t), {"lr": lr}, 1.0 - abs(lr - 0.6)))
        sched._data = rows
        sched._t_max = 12.0
        return [sched._explore({"lr": 0.5})["lr"] for _ in range(8)]

    picks = pair(scn)
    assert all(0.0 <= p <= 1.0 for p in picks)
    assert sum(1 for p in picks if 0.35 <= p <= 0.85) >= 6, picks


def test_pb2_end_to_end_exploits(fresh_pkgs, tmp_path):
    def scn(rt):
        tune = sub(rt, "tune")
        results = tune.Tuner(
            _exploiter(rt.__name__, _started(tmp_path, rt)),
            param_space={"lr": tune.grid_search([0.05, 1.0])},
            tune_config=tune.TuneConfig(
                metric="w", mode="max",
                scheduler=tune.PB2(hyperparam_bounds={"lr": (0.05, 2.0)},
                                   perturbation_interval=4,
                                   quantile_fraction=0.5, seed=0),
                stop={"training_iteration": 30}),
            run_config=_run_config(rt, "pb2", tmp_path)).fit()
        ws = sorted(results[i].metrics["w"] for i in range(len(results)))
        return ws[0] > 0.1, ws

    for rt, (ok, ws) in zip(fresh_pkgs, _same_sides(fresh_pkgs, scn)):
        assert ok, f"{rt.__name__}: weak trial never exploited under PB2: {ws}"


def test_pbt_exploits_checkpoint(fresh_pkgs, tmp_path):
    def scn(rt):
        tune = sub(rt, "tune")
        results = tune.Tuner(
            _exploiter(rt.__name__, _started(tmp_path, rt)),
            param_space={"lr": tune.grid_search([0.001, 1.0])},
            tune_config=tune.TuneConfig(
                metric="w", mode="max",
                scheduler=tune.PopulationBasedTraining(
                    perturbation_interval=4,
                    hyperparam_mutations={"lr": [0.5, 1.0, 2.0]},
                    quantile_fraction=0.5, seed=0),
                stop={"training_iteration": 30}),
            run_config=_run_config(rt, "pbt", tmp_path)).fit()
        ws = sorted(results[i].metrics["w"] for i in range(len(results)))
        return ws[0] > 0.1, ws

    for rt, (ok, ws) in zip(fresh_pkgs, _same_sides(fresh_pkgs, scn)):
        assert ok, f"{rt.__name__}: weak trial never exploited: {ws}"
