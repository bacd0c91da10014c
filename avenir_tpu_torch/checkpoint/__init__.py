"""The elastic restore — port of ``avenir_tpu/checkpoint/``.

``checkpoint/reshard.py`` re-keys checkpointed accumulator state for a
new topology (kill under 8 shards, resume under 4 or unsharded, byte for
byte) or refuses it with a typed :class:`ReshardError`;
``utils/checkpoint.py`` stays the snapshot store it works on.
"""

from avenir_tpu_torch.checkpoint.reshard import (  # noqa: F401
    MESH_TAG,
    ReshardError,
    journal_reshard,
    rekey_state,
    reshard_state_tree,
    snapshot_suffix,
    spec_suffix,
    split_mesh_key,
    state_suffix,
)
