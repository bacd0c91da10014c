"""The port's parallel plane on local devices (``avenir_tpu/parallel``):
the mesh and batch staging (``mesh.py``), the ``shard.*`` plan
(``shard.py``), the per-shard folds and their reductions
(``collectives.py``) and the straggler probe (``skew.py``)."""

from avenir_tpu_torch.parallel.mesh import (
    Blocks,
    Mesh,
    device_put_sharded_batch,
    local_devices,
    make_mesh,
    pad_batch,
    shard_pad_target,
)
from avenir_tpu_torch.parallel.shard import ShardSpec

__all__ = [
    "Blocks",
    "Mesh",
    "device_put_sharded_batch",
    "local_devices",
    "make_mesh",
    "pad_batch",
    "shard_pad_target",
    "ShardSpec",
]
