"""Search spaces + search algorithms.

(reference: python/ray/tune/search/ — sample.py domains, variant generation
in basic_variant.py BasicVariantGenerator, Searcher base in searcher.py,
ConcurrencyLimiter in concurrency_limiter.py.)
"""

from __future__ import annotations

import itertools
import random
from typing import Any, Callable


class Domain:
    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


class Categorical(Domain):
    def __init__(self, categories):
        self.categories = list(categories)

    def sample(self, rng):
        return rng.choice(self.categories)


class Float(Domain):
    def __init__(self, lower, upper, log=False):
        self.lower, self.upper, self.log = lower, upper, log

    def sample(self, rng):
        if self.log:
            import math

            return math.exp(rng.uniform(math.log(self.lower), math.log(self.upper)))
        return rng.uniform(self.lower, self.upper)


class Integer(Domain):
    def __init__(self, lower, upper):
        self.lower, self.upper = lower, upper

    def sample(self, rng):
        return rng.randrange(self.lower, self.upper)


class Function(Domain):
    def __init__(self, fn: Callable):
        self.fn = fn

    def sample(self, rng):
        return self.fn(None)


class GridSearch:
    def __init__(self, values):
        self.values = list(values)


# public constructors (reference: tune/search/sample.py + tune/__init__.py)

def choice(categories) -> Categorical:
    return Categorical(categories)


def uniform(lower, upper) -> Float:
    return Float(lower, upper)


def loguniform(lower, upper) -> Float:
    return Float(lower, upper, log=True)


def randint(lower, upper) -> Integer:
    return Integer(lower, upper)


def sample_from(fn) -> Function:
    return Function(fn)


def grid_search(values) -> GridSearch:
    return GridSearch(values)


def _split_space(space: dict):
    grids, domains, constants = {}, {}, {}
    for k, v in space.items():
        if isinstance(v, GridSearch) or (isinstance(v, dict) and v.get("grid_search")):
            grids[k] = v.values if isinstance(v, GridSearch) else v["grid_search"]
        elif isinstance(v, Domain):
            domains[k] = v
        else:
            constants[k] = v
    return grids, domains, constants


class Searcher:
    """(reference: tune/search/searcher.py — suggest/on_trial_complete.)"""

    metric: str | None = None
    mode: str = "max"

    def set_search_properties(self, metric, mode):
        self.metric, self.mode = metric, mode

    def suggest(self, trial_id: str) -> dict | None:
        raise NotImplementedError

    def on_trial_complete(self, trial_id: str, result: dict | None = None,
                          error: bool = False) -> None:
        pass


class BasicVariantGenerator(Searcher):
    """Grid cross-product × num_samples random sampling.
    (reference: tune/search/basic_variant.py.)"""

    def __init__(self, space: dict, num_samples: int = 1, seed: int | None = None):
        self._rng = random.Random(seed)
        grids, domains, constants = _split_space(space)
        keys = list(grids)
        combos = list(itertools.product(*grids.values())) if keys else [()]
        self._variants = []
        for _ in range(num_samples):
            for combo in combos:
                cfg = dict(constants)
                cfg.update(dict(zip(keys, combo)))
                for k, d in domains.items():
                    cfg[k] = d.sample(self._rng)
                self._variants.append(cfg)
        self._i = 0

    @property
    def total_trials(self) -> int:
        return len(self._variants)

    def suggest(self, trial_id: str) -> dict | None:
        if self._i >= len(self._variants):
            return None
        cfg = self._variants[self._i]
        self._i += 1
        return cfg


class ConcurrencyLimiter(Searcher):
    """(reference: tune/search/concurrency_limiter.py — caps in-flight
    suggestions from the wrapped searcher.)"""

    def __init__(self, searcher: Searcher, max_concurrent: int):
        self.searcher = searcher
        self.max_concurrent = max_concurrent
        self._live: set[str] = set()

    def set_search_properties(self, metric, mode):
        self.searcher.set_search_properties(metric, mode)

    def suggest(self, trial_id: str) -> dict | None:
        if len(self._live) >= self.max_concurrent:
            return "PENDING"  # sentinel: try again later
        cfg = self.searcher.suggest(trial_id)
        if cfg is not None and cfg != "PENDING":
            self._live.add(trial_id)
        return cfg

    def on_trial_complete(self, trial_id, result=None, error=False):
        self._live.discard(trial_id)
        self.searcher.on_trial_complete(trial_id, result, error)


class TPESearcher(Searcher):
    """Tree-structured Parzen Estimator (independent per-dimension):
    completed trials split into good/bad by metric quantile; candidates are
    scored by the ratio of good/bad kernel densities and the best of
    `n_candidates` is suggested. Covers the reference's model-based
    searchers (Optuna's default sampler is TPE; reference: tune/search/optuna/)
    without the external dependency.
    """

    def __init__(self, space: dict, num_samples: int = 32, *,
                 gamma: float = 0.25, n_candidates: int = 24,
                 n_startup: int = 8, seed: int | None = None):
        self._rng = random.Random(seed)
        grids, domains, constants = _split_space(space)
        if grids:
            raise ValueError("TPESearcher does not take grid_search dims; "
                             "use choice(...) instead")
        self._domains = domains
        self._constants = constants
        self._num_samples = num_samples
        self._gamma = gamma
        self._n_candidates = n_candidates
        self._n_startup = n_startup
        self._suggested = 0
        self._configs: dict[str, dict] = {}
        self._history: list[tuple[dict, float]] = []

    @property
    def total_trials(self) -> int:
        return self._num_samples

    def _random_config(self) -> dict:
        cfg = dict(self._constants)
        for k, d in self._domains.items():
            cfg[k] = d.sample(self._rng)
        return cfg

    def _split_history(self):
        ordered = sorted(self._history, key=lambda t: t[1],
                         reverse=(self.mode == "max"))
        n_good = max(1, int(len(ordered) * self._gamma))
        good = [c for c, _ in ordered[:n_good]]
        bad = [c for c, _ in ordered[n_good:]] or good
        return good, bad

    def _dim_score(self, key, domain, value, good, bad) -> float:
        """log(density under good) - log(density under bad), per dimension."""
        import math

        gvals = [c[key] for c in good]
        bvals = [c[key] for c in bad]
        if isinstance(domain, Categorical):
            eps = 0.5
            pg = (gvals.count(value) + eps) / (len(gvals) + eps * len(domain.categories))
            pb = (bvals.count(value) + eps) / (len(bvals) + eps * len(domain.categories))
            return math.log(pg) - math.log(pb)
        # numeric: gaussian KDE with Silverman-ish bandwidth
        def kde(vals):
            if not vals:
                return 1e-12
            lo = min(vals); hi = max(vals)
            bw = max((hi - lo) / max(len(vals) ** 0.5, 1.0), 1e-9)
            s = sum(math.exp(-0.5 * ((value - v) / bw) ** 2) / bw for v in vals)
            return max(s / len(vals), 1e-12)

        return math.log(kde(gvals)) - math.log(kde(bvals))

    def suggest(self, trial_id: str) -> dict | None:
        if self.metric is None:
            raise ValueError(
                "TPESearcher needs TuneConfig(metric=..., mode=...) — "
                "without a metric it can only sample at random")
        if self._suggested >= self._num_samples:
            return None
        self._suggested += 1
        if len(self._history) < self._n_startup:
            cfg = self._random_config()
        else:
            good, bad = self._split_history()
            best_cfg, best_score = None, None
            for _ in range(self._n_candidates):
                cand = self._random_config()
                score = sum(
                    self._dim_score(k, d, cand[k], good, bad)
                    for k, d in self._domains.items())
                if best_score is None or score > best_score:
                    best_cfg, best_score = cand, score
            cfg = best_cfg
        self._configs[trial_id] = cfg
        return cfg

    def on_trial_complete(self, trial_id, result=None, error=False):
        cfg = self._configs.pop(trial_id, None)
        if cfg is None or error or not result:
            return
        val = result.get(self.metric)
        if val is not None:
            self._history.append((cfg, float(val)))
