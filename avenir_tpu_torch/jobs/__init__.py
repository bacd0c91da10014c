"""Job registry — reference Tool class names → the port's jobs.

Jobs are addressable by the reference's fully-qualified class name
(``org.avenir.bayesian.BayesianDistribution``; the chombo jobs the runbooks
call between avenir jobs as ``org.chombo.mr.<Name>``) or the simple name.
"""

from __future__ import annotations

from typing import Dict, Type

from avenir_tpu_torch.jobs.base import Job
from avenir_tpu_torch.jobs.bayesian import BayesianDistribution, BayesianPredictor
from avenir_tpu_torch.jobs.chombo import NumericalAttrStats, Projection, RunningAggregator
from avenir_tpu_torch.jobs.explore import (
    BaggingSampler,
    CramerCorrelation,
    HeterogeneityReductionCorrelation,
    MutualInformation,
    UnderSamplingBalancer,
)
from avenir_tpu_torch.jobs.knn import (
    FeatureCondProbJoiner,
    NearestNeighbor,
    SameTypeSimilarity,
)
from avenir_tpu_torch.jobs.markov import (
    HiddenMarkovModelBuilder,
    MarkovStateTransitionModel,
    ViterbiStatePredictor,
)
from avenir_tpu_torch.jobs.regress import FisherDiscriminant, LogisticRegressionJob
from avenir_tpu_torch.jobs.reinforce import (
    AuerDeterministic,
    GreedyRandomBandit,
    RandomFirstGreedyBandit,
    SoftMaxBandit,
)
from avenir_tpu_torch.jobs.text import WordCounter
from avenir_tpu_torch.jobs.tree import (
    ClassPartitionGenerator,
    DataPartitioner,
    DecisionTreeBuilder,
    SplitGenerator,
)
from avenir_tpu_torch.serving.replay import ScoringPlane

# reference package of each job's counterpart (for fully-qualified lookup)
_PACKAGES: Dict[str, str] = {
    "BayesianDistribution": "bayesian",
    "BayesianPredictor": "bayesian",
    "MutualInformation": "explore",
    "CramerCorrelation": "explore",
    "HeterogeneityReductionCorrelation": "explore",
    "BaggingSampler": "explore",
    "UnderSamplingBalancer": "explore",
    "ClassPartitionGenerator": "explore",
    "SplitGenerator": "tree",
    "DataPartitioner": "tree",
    "DecisionTreeBuilder": "tree",
    "SameTypeSimilarity": "knn",
    "FeatureCondProbJoiner": "knn",
    "NearestNeighbor": "knn",
    "FisherDiscriminant": "discriminant",
    "MarkovStateTransitionModel": "markov",
    "HiddenMarkovModelBuilder": "markov",
    "ViterbiStatePredictor": "markov",
    "LogisticRegressionJob": "regress",
    "GreedyRandomBandit": "reinforce",
    "AuerDeterministic": "reinforce",
    "SoftMaxBandit": "reinforce",
    "RandomFirstGreedyBandit": "reinforce",
    "WordCounter": "text",
}

# chombo sibling-library jobs, addressable by their org.chombo.mr names
_CHOMBO_JOBS = {"RunningAggregator", "Projection", "NumericalAttrStats"}

JOB_CLASSES = [BayesianDistribution, BayesianPredictor, MutualInformation,
               CramerCorrelation, HeterogeneityReductionCorrelation,
               ClassPartitionGenerator, SplitGenerator, DataPartitioner,
               DecisionTreeBuilder, SameTypeSimilarity, FeatureCondProbJoiner,
               NearestNeighbor, FisherDiscriminant, BaggingSampler,
               UnderSamplingBalancer, MarkovStateTransitionModel,
               HiddenMarkovModelBuilder, ViterbiStatePredictor,
               LogisticRegressionJob, GreedyRandomBandit, AuerDeterministic,
               SoftMaxBandit, RandomFirstGreedyBandit, WordCounter,
               RunningAggregator, Projection, NumericalAttrStats,
               # the serving plane's replay stage (no reference analog)
               ScoringPlane]

REGISTRY: Dict[str, Type[Job]] = {}
for _cls in JOB_CLASSES:
    REGISTRY[_cls.name] = _cls
    if _cls.name in _CHOMBO_JOBS:
        REGISTRY[f"org.chombo.mr.{_cls.name}"] = _cls
    elif _cls.name in _PACKAGES:
        REGISTRY[f"org.avenir.{_PACKAGES[_cls.name]}.{_cls.name}"] = _cls


def get_job(name: str) -> Job:
    try:
        return REGISTRY[name]()
    except KeyError:
        raise ValueError(
            f"unknown job {name!r}; known: "
            f"{sorted(k for k in REGISTRY if '.' not in k)}") from None


# the continuous-analytics plane's replay stage.  A bare MODULE import,
# placed last: stream/job.py registers itself into REGISTRY/JOB_CLASSES at
# the end of its own body, which is the only wiring that survives every
# entry point of the import cycle — jobs-first (this line triggers the
# registration), stream-first (stream/job.py is mid-import above us on the
# stack, so this line binds the partial module without touching its
# names, and the registration runs when its body completes).  A
# ``from ... import StreamAnalytics`` here would crash any stream-first
# import.
import avenir_tpu_torch.stream.job  # noqa: E402,F401
