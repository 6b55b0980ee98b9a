"""ray_tpu_torch.tune — hyperparameter tuning (counterpart of ray_tpu.tune).

(reference: python/ray/tune/ — Tuner/TuneConfig at tuner.py:43, search spaces
in search/sample.py, schedulers in schedulers/, the trial-driving loop in
execution/tune_controller.py:68.)
"""

from ray_tpu_torch.train.session import get_checkpoint, report
from ray_tpu_torch.tune.schedulers import (
    AsyncHyperBandScheduler,
    FIFOScheduler,
    HyperBandScheduler,
    MedianStoppingRule,
    PB2,
    PopulationBasedTraining,
    TrialScheduler,
)
from ray_tpu_torch.tune.search import (
    BasicVariantGenerator,
    TPESearcher,
    ConcurrencyLimiter,
    Searcher,
    choice,
    grid_search,
    loguniform,
    randint,
    sample_from,
    uniform,
)
from ray_tpu_torch.tune.tuner import ResultGrid, TuneConfig, TuneResult, Tuner

__all__ = [
    "AsyncHyperBandScheduler",
    "BasicVariantGenerator",
    "TPESearcher",
    "ConcurrencyLimiter",
    "FIFOScheduler",
    "HyperBandScheduler",
    "MedianStoppingRule",
    "PB2",
    "PopulationBasedTraining",
    "ResultGrid",
    "Searcher",
    "TrialScheduler",
    "TuneConfig",
    "TuneResult",
    "Tuner",
    "choice",
    "get_checkpoint",
    "grid_search",
    "loguniform",
    "randint",
    "report",
    "sample_from",
    "uniform",
]
