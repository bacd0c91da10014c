"""The online scoring plane — port of ``avenir_tpu/serving/``.

A :class:`ModelRegistry` loads any trained artifact the batch jobs produce
and holds its parameters on one device (``cuda`` unless the CPU is asked
for); a :class:`BucketedMicrobatcher` folds concurrent requests into padded
batch buckets whose shapes are all warmed at start; a :class:`ReplicaPool`
runs several batchers on the one card with failover; HTTP and in-process
queue front ends expose them (the queue one also over Redis);
``ScoringPlane`` replays a file through them as a job or a pipeline stage;
``global_pool.py`` fronts a fleet of serving processes with one router.
"""

from avenir_tpu_torch.serving.batcher import (BucketedMicrobatcher,
                                              PendingRequest)
from avenir_tpu_torch.serving.errors import (
    ReplicaDownError,
    RequestError,
    RequestTimeout,
    ServingError,
    ShedError,
    UnknownModelError,
)
from avenir_tpu_torch.serving.frontend import (
    QueueScoreFrontend,
    ScoreHTTPServer,
    redis_score_frontend,
)
from avenir_tpu_torch.serving.pool import PoolRequest, ReplicaPool
from avenir_tpu_torch.serving.registry import (FAMILIES, ModelRegistry,
                                               ServableModel)
from avenir_tpu_torch.serving.replay import ScoringPlane

__all__ = [
    "BucketedMicrobatcher", "PendingRequest",
    "ServingError", "UnknownModelError", "ShedError", "RequestTimeout",
    "RequestError", "ReplicaDownError",
    "QueueScoreFrontend", "ScoreHTTPServer", "redis_score_frontend",
    "FAMILIES", "ModelRegistry", "ServableModel",
    "ReplicaPool", "PoolRequest",
    "ScoringPlane",
]
