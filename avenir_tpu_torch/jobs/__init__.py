"""Job registry — reference Tool class names → the port's jobs.

Jobs are addressable by the reference's fully-qualified class name
(``org.avenir.bayesian.BayesianDistribution``) or the simple name.
"""

from __future__ import annotations

from typing import Dict, Type

from avenir_tpu_torch.jobs.base import Job
from avenir_tpu_torch.jobs.bayesian import BayesianDistribution, BayesianPredictor
from avenir_tpu_torch.jobs.explore import MutualInformation
from avenir_tpu_torch.jobs.tree import (
    ClassPartitionGenerator,
    DataPartitioner,
    DecisionTreeBuilder,
    SplitGenerator,
)

# reference package of each job's counterpart (for fully-qualified lookup)
_PACKAGES: Dict[str, str] = {
    "BayesianDistribution": "bayesian",
    "BayesianPredictor": "bayesian",
    "MutualInformation": "explore",
    "ClassPartitionGenerator": "explore",
    "SplitGenerator": "tree",
    "DataPartitioner": "tree",
    "DecisionTreeBuilder": "tree",
}

JOB_CLASSES = [BayesianDistribution, BayesianPredictor, MutualInformation,
               ClassPartitionGenerator, SplitGenerator, DataPartitioner,
               DecisionTreeBuilder]

REGISTRY: Dict[str, Type[Job]] = {}
for _cls in JOB_CLASSES:
    REGISTRY[_cls.name] = _cls
    REGISTRY[f"org.avenir.{_PACKAGES[_cls.name]}.{_cls.name}"] = _cls


def get_job(name: str) -> Job:
    try:
        return REGISTRY[name]()
    except KeyError:
        raise ValueError(
            f"unknown job {name!r}; known: "
            f"{sorted(k for k in REGISTRY if '.' not in k)}") from None
