"""GraftPool — multi-tenant admission control, fair queueing and
per-tenant SLO isolation over one device pool; port of
``avenir_tpu/tenancy/``.

- :mod:`~avenir_tpu_torch.tenancy.contract` parses the ``tenant.*`` conf
  family into per-tenant contracts (queue share, in-flight quota,
  priority, queue depth/deadline, per-tenant ``slo.*`` rules);
- :mod:`~avenir_tpu_torch.tenancy.arbiter` is the weighted
  deficit-round-robin device arbiter every dispatch seam draws from —
  batch SharedScan chunk folds and stream pane folds
  (``pipeline/scan.py::ChunkFolder.fold``) and serving batch dispatches
  (``serving/batcher.py``) all acquire a slot, so one noisy tenant is
  throttled then shed while the others keep their contracted share.

Off-is-free: with no ``tenant.<id>.share`` key configured, every seam
pays one attribute check and a shared null context manager.
"""

from avenir_tpu_torch.tenancy.arbiter import (  # noqa: F401
    GraftPool,
    configure,
    pool,
    reset,
    tenant_scope,
)
from avenir_tpu_torch.tenancy.contract import (  # noqa: F401
    TenantContract,
    contracts_from_conf,
    tenant_slo_rules,
)
