"""Pipelines: the staged driver, the SharedScan that fuses count stages
over one artifact, and the in-process RL serving loop."""

from avenir_tpu_torch.pipeline.driver import (Pipeline, Stage,
                                              decision_tree_pipeline,
                                              knn_pipeline)
from avenir_tpu_torch.pipeline.streaming import (
    InProcQueue,
    QueueActionWriter,
    QueueEventSource,
    QueueRewardReader,
    ReinforcementLearnerServer,
)

__all__ = ["InProcQueue", "Pipeline", "QueueActionWriter", "QueueEventSource",
           "QueueRewardReader", "ReinforcementLearnerServer", "Stage",
           "decision_tree_pipeline", "knn_pipeline"]
