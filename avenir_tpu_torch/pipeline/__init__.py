"""Pipelines: the staged driver and the SharedScan that fuses count
stages over one artifact."""

from avenir_tpu_torch.pipeline.driver import (Pipeline, Stage,
                                              decision_tree_pipeline,
                                              knn_pipeline)

__all__ = ["Pipeline", "Stage", "decision_tree_pipeline", "knn_pipeline"]
