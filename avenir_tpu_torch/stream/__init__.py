"""StreamGraft — the continuous-analytics plane; port of
``avenir_tpu/stream/``.

Sliding-window SharedScan consumers over row streams
(:mod:`~avenir_tpu_torch.stream.windows`), count-distribution drift
detection (:mod:`~avenir_tpu_torch.stream.drift`), and the
drift→retrain→hot-swap controller closing the train→deploy loop through
the serving plane (:mod:`~avenir_tpu_torch.stream.controller`).
``StreamAnalytics`` (:mod:`~avenir_tpu_torch.stream.job`) is the
pipeline-stage face.
"""

from avenir_tpu_torch.stream.controller import (RETRAIN_JOBS,
                                                DriftRetrainController)
from avenir_tpu_torch.stream.drift import DriftDetector, DriftEvent
from avenir_tpu_torch.stream.job import StreamAnalytics, consumers_from_conf
from avenir_tpu_torch.stream.windows import (
    ClassDistributionConsumer,
    WindowCheckpointer,
    WindowedScan,
    WindowResult,
)

__all__ = [
    "ClassDistributionConsumer",
    "DriftDetector",
    "DriftEvent",
    "DriftRetrainController",
    "RETRAIN_JOBS",
    "StreamAnalytics",
    "WindowCheckpointer",
    "WindowedScan",
    "WindowResult",
    "consumers_from_conf",
]
