"""Trial schedulers: early stopping + population-based training.

(reference: python/ray/tune/schedulers/ — ASHA in async_hyperband.py,
HyperBand in hyperband.py, PBT in pbt.py, median stopping in
median_stopping_rule.py; decisions CONTINUE/STOP/PAUSE from trial_scheduler.py.)
"""

from __future__ import annotations

import math
import random

CONTINUE = "CONTINUE"
STOP = "STOP"


class TrialScheduler:
    def set_search_properties(self, metric: str, mode: str):
        self.metric, self.mode = metric, mode

    def on_result(self, trial, result: dict) -> str:
        return CONTINUE

    def on_complete(self, trial, result: dict) -> None:
        pass

    def _score(self, result: dict) -> float:
        v = result.get(self.metric, float("-inf") if self.mode == "max" else float("inf"))
        return v if self.mode == "max" else -v


class FIFOScheduler(TrialScheduler):
    """(reference: tune/schedulers/trial_scheduler.py FIFOScheduler.)"""


class AsyncHyperBandScheduler(TrialScheduler):
    """ASHA: asynchronous successive halving.
    (reference: tune/schedulers/async_hyperband.py — rungs at
    grace_period * reduction_factor^k; a trial reaching a rung stops unless
    it is in the top 1/reduction_factor of results recorded at that rung.)"""

    def __init__(self, *, time_attr: str = "training_iteration",
                 grace_period: int = 1, reduction_factor: int = 4,
                 max_t: int = 100):
        self.time_attr = time_attr
        self.grace = grace_period
        self.rf = reduction_factor
        self.max_t = max_t
        self._rungs: dict[int, list[float]] = {}
        r = grace_period
        while r < max_t:
            self._rungs[r] = []
            r *= reduction_factor

    def on_result(self, trial, result) -> str:
        t = result.get(self.time_attr, 0)
        score = self._score(result)
        decision = CONTINUE
        for rung_t, recorded in self._rungs.items():
            if t == rung_t:
                recorded.append(score)
                k = max(1, len(recorded) // self.rf)
                cutoff = sorted(recorded, reverse=True)[k - 1]
                if score < cutoff:
                    decision = STOP
        if t >= self.max_t:
            decision = STOP
        return decision


class HyperBandScheduler(AsyncHyperBandScheduler):
    """Synchronous HyperBand approximated by its asynchronous variant — the
    reference's own docs recommend ASHA over sync HyperBand (better rung
    utilization, no stragglers); kept as a named alias for API parity.
    (reference: tune/schedulers/hyperband.py.)"""


class MedianStoppingRule(TrialScheduler):
    """(reference: tune/schedulers/median_stopping_rule.py — stop when the
    trial's best score is worse than the median of other trials' running
    averages at the same point.)"""

    def __init__(self, *, time_attr: str = "training_iteration",
                 grace_period: int = 1, min_samples_required: int = 3):
        self.time_attr = time_attr
        self.grace = grace_period
        self.min_samples = min_samples_required
        self._avgs: dict[str, tuple[float, int]] = {}  # trial → (sum, n)
        self._best: dict[str, float] = {}

    def on_result(self, trial, result) -> str:
        t = result.get(self.time_attr, 0)
        s = self._score(result)
        acc, n = self._avgs.get(trial.trial_id, (0.0, 0))
        self._avgs[trial.trial_id] = (acc + s, n + 1)
        self._best[trial.trial_id] = max(self._best.get(trial.trial_id, -math.inf), s)
        if t <= self.grace or len(self._avgs) < self.min_samples:
            return CONTINUE
        others = [a / m for tid, (a, m) in self._avgs.items() if tid != trial.trial_id and m]
        if not others:
            return CONTINUE
        median = sorted(others)[len(others) // 2]
        return STOP if self._best[trial.trial_id] < median else CONTINUE


class PopulationBasedTraining(TrialScheduler):
    """PBT: bottom-quantile trials exploit a top-quantile trial's checkpoint
    and explore a perturbed config.
    (reference: tune/schedulers/pbt.py — _exploit/_explore, perturbation by
    factor 1.2/0.8 or resample from hyperparam_mutations.)"""

    def __init__(self, *, time_attr: str = "training_iteration",
                 perturbation_interval: int = 4,
                 hyperparam_mutations: dict | None = None,
                 quantile_fraction: float = 0.25, seed: int | None = None):
        self.time_attr = time_attr
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self._rng = random.Random(seed)
        self._last_perturb: dict[str, int] = {}
        self._latest: dict[str, tuple[float, object]] = {}  # trial_id → (score, trial)

    def on_result(self, trial, result) -> str:
        t = result.get(self.time_attr, 0)
        score = self._score(result)
        self._latest[trial.trial_id] = (score, trial)
        last = self._last_perturb.get(trial.trial_id, 0)
        if t - last < self.interval or len(self._latest) < 2:
            return CONTINUE
        self._last_perturb[trial.trial_id] = t
        ranked = sorted(self._latest.values(), key=lambda x: x[0])
        k = max(1, int(len(ranked) * self.quantile))
        bottom = [tr for _, tr in ranked[:k]]
        top = [tr for _, tr in ranked[-k:]]
        if trial in bottom and top and trial not in top:
            donor = self._rng.choice(top)
            trial.exploit_from = donor          # picked up by the controller
            trial.explore_config = self._explore(donor.config)
        return CONTINUE

    def _explore(self, config: dict) -> dict:
        new = dict(config)
        for k, spec in self.mutations.items():
            if isinstance(spec, list):
                new[k] = self._rng.choice(spec)
            elif callable(spec):
                new[k] = spec()
            elif isinstance(spec, dict) and "lower" in spec:
                new[k] = self._rng.uniform(spec["lower"], spec["upper"])
            elif k in new and isinstance(new[k], (int, float)):
                new[k] = new[k] * self._rng.choice([0.8, 1.2])
        return new


class PB2(PopulationBasedTraining):
    """Population Based Bandits: PBT's exploit step, but exploration picks
    new continuous hyperparameters with a time-varying GP-UCB bandit fit on
    the population's observed (time, config) → reward-change data instead
    of random perturbation — far more sample-efficient at small population
    sizes (reference: tune/schedulers/pb2.py, Parker-Holder et al. 2020).

    `hyperparam_bounds` maps continuous keys to (lower, upper); keys in
    `hyperparam_mutations` (categoricals) keep PBT-style resampling.
    """

    def __init__(self, *, hyperparam_bounds: dict,
                 time_attr: str = "training_iteration",
                 perturbation_interval: int = 4,
                 hyperparam_mutations: dict | None = None,
                 quantile_fraction: float = 0.25, seed: int | None = None,
                 ucb_beta: float = 2.0):
        super().__init__(time_attr=time_attr,
                         perturbation_interval=perturbation_interval,
                         hyperparam_mutations=hyperparam_mutations,
                         quantile_fraction=quantile_fraction, seed=seed)
        if not hyperparam_bounds:
            raise ValueError("PB2 needs hyperparam_bounds for its GP")
        self.bounds = {k: (float(lo), float(hi))
                       for k, (lo, hi) in hyperparam_bounds.items()}
        self.ucb_beta = ucb_beta
        self._data: list = []  # rows: (t, {hp: v}, reward_delta)
        self._prev_score: dict[str, tuple[float, float]] = {}  # tid → (t, score)
        self._t_max = 1.0

    def on_result(self, trial, result) -> str:
        t = float(result.get(self.time_attr, 0))
        score = self._score(result)
        prev = self._prev_score.get(trial.trial_id)
        if prev is not None and t > prev[0]:
            self._data.append((t, {k: float(trial.config.get(k, 0.0))
                                   for k in self.bounds}, score - prev[1]))
            if len(self._data) > 500:
                del self._data[:100]
        self._prev_score[trial.trial_id] = (t, score)
        self._t_max = max(self._t_max, t)
        decision = super().on_result(trial, result)
        if trial.exploit_from is not None:
            # the next report's score includes the donor checkpoint's jump —
            # attributing that delta to the explored config would poison the
            # GP (reference pb2.py resets the baseline on exploit)
            self._prev_score.pop(trial.trial_id, None)
        return decision

    # -- GP machinery ------------------------------------------------------

    def _xy(self):
        import numpy as np

        X = np.asarray([[t / self._t_max]
                        + [(cfg[k] - lo) / (hi - lo or 1.0)
                           for k, (lo, hi) in self.bounds.items()]
                        for t, cfg, _ in self._data])
        y = np.asarray([d for _, _, d in self._data], dtype=float)
        if y.std() > 1e-12:
            y = (y - y.mean()) / y.std()
        return X, y

    def _explore(self, config: dict) -> dict:
        import numpy as np

        new = super()._explore(config)  # categoricals via PBT mutations
        if len(self._data) < 4:
            # cold start: uniform sample inside the bounds
            for k, (lo, hi) in self.bounds.items():
                new[k] = self._rng.uniform(lo, hi)
            return new
        X, y = self._xy()
        n, d = X.shape
        ell, jitter = 0.3, 1e-4
        sq = ((X[:, None, :] - X[None, :, :]) ** 2).sum(-1)
        K = np.exp(-sq / (2 * ell * ell)) + jitter * np.eye(n)
        alpha = np.linalg.solve(K, y)
        # candidates at the CURRENT (normalized) time
        m = 256
        cand = np.empty((m, d))
        cand[:, 0] = 1.0
        for j, (k, (lo, hi)) in enumerate(self.bounds.items()):
            cand[:, 1 + j] = np.asarray(
                [self._rng.random() for _ in range(m)])
        sq_c = ((cand[:, None, :] - X[None, :, :]) ** 2).sum(-1)
        Ks = np.exp(-sq_c / (2 * ell * ell))
        mu = Ks @ alpha
        v = np.linalg.solve(K, Ks.T)
        var = np.maximum(1.0 - (Ks * v.T).sum(-1), 1e-9)
        ucb = mu + np.sqrt(self.ucb_beta) * np.sqrt(var)
        best = cand[int(np.argmax(ucb))]
        for j, (k, (lo, hi)) in enumerate(self.bounds.items()):
            new[k] = lo + float(best[1 + j]) * (hi - lo)
        return new
