"""ray_tpu_torch.tune: experiment runner (Tuner/TuneController) with
ASHA/HyperBand/Median/PBT schedulers and grid/random search over trial
actors. Reference surface: python/ray/tune [SURVEY.md §2.4]. The port's
copy of ``ray_tpu/tune/__init__.py``."""

from ray_tpu_torch.train._session import get_checkpoint, report
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.tune.schedulers import (
    ASHAScheduler,
    FIFOScheduler,
    HyperBandScheduler,
    MedianStoppingRule,
    PB2,
    PopulationBasedTraining,
    TrialScheduler,
)
from ray_tpu_torch.tune.search import (
    BasicVariantGenerator,
    Searcher,
    TPESearch,
    choice,
    grid_search,
    loguniform,
    quniform,
    randint,
    sample_from,
    uniform,
)
from ray_tpu_torch.tune.tuner import ResultGrid, Trial, TuneConfig, Tuner

__all__ = [
    "ASHAScheduler", "BasicVariantGenerator", "Checkpoint",
    "FIFOScheduler", "HyperBandScheduler", "MedianStoppingRule",
    "PB2", "PopulationBasedTraining", "ResultGrid", "Searcher", "TPESearch",
    "Trial", "TrialScheduler", "TuneConfig", "Tuner", "choice",
    "get_checkpoint", "grid_search", "loguniform", "quniform", "randint",
    "report", "sample_from", "uniform",
]
