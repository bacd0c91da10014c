"""Tenant contracts — the declarative ``tenant.*`` conf family; port of
``avenir_tpu/tenancy/contract.py`` (its ``split_contracts``, which slices
the contracts across a fleet of serving processes, waits with that fleet:
ROADMAP.md, Queue 1 item 7h-ii).

Grammar (properties file, the reference's ``-D`` contract), mirroring the
``slo.<name>.*`` rule family — the ``share`` key is the
existence marker, everything else defaults::

    tenant.analytics.share=4           # weighted fair-queueing share
    tenant.analytics.max.inflight=2    # quota: concurrent device slots
    tenant.analytics.queue.depth=64    # waiters bound (admission control)
    tenant.analytics.priority=0        # strict tiers; shares arbitrate
                                       #   WITHIN a tier
    tenant.analytics.queue.timeout.ms=5000   # deadline while queued
    tenant.analytics.slo.p99.metric=p99.latency.ms   # per-tenant SLO
    tenant.analytics.slo.p99.target=50               #   rules (the
                                                     #   slo.* grammar)

Pool-wide keys: ``tenant.pool.concurrency`` (device slots the arbiter
hands out at once, default 1 — the accelerator serializes dispatches
anyway), ``tenant.queue.depth`` / ``tenant.queue.timeout.ms`` (per-tenant
defaults), and ``tenant.id`` (the tenant a conf's OWN workload runs as —
read by the driver, the job layer and the serving batcher, stamped onto
every journal event the workload emits).

Per-tenant SLO rules reuse the ``slo.*`` declarative grammar verbatim:
:func:`tenant_slo_rules` strips the ``tenant.<id>.`` prefix and hands the
remainder to ``telemetry.slo.rules_from_conf``, so every metric/op/window
feature — and every future one — works per tenant for free.  Post-hoc
verdicts pair them with ``telemetry slo <journal> --label tenant=<id>``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Optional

_SHARE_KEY_RE = re.compile(r"^tenant\.([A-Za-z0-9_-]+)\.share$")
# every per-tenant subkey the grammar knows; anything else under
# tenant.<id>. is a typo that must fail loudly (see contracts_from_conf)
_TENANT_KEY_RE = re.compile(
    r"^tenant\.([A-Za-z0-9_-]+)\.(share|max\.inflight|queue\.depth|"
    r"priority|queue\.timeout\.ms|slo\..+)$")
# pool-wide keys that are NOT per-tenant contracts
_POOL_WIDE_RE = re.compile(
    r"^tenant\.(id|pool\..+|queue\.depth|queue\.timeout\.ms)$")

# segment names the pool-wide tenant.* keys claim — a tenant id colliding
# with one would make the grammar ambiguous (tenant.queue.depth is the
# DEFAULT depth, not tenant "queue"'s), so it is refused loudly
RESERVED_IDS = frozenset({"id", "pool", "queue"})


@dataclass(frozen=True)
class TenantContract:
    """One tenant's admission contract on the shared device pool."""

    tenant: str
    share: float                     # DRR weight (queue share)
    max_inflight: int = 0            # 0 = unbounded (pool capacity bounds)
    queue_depth: int = 64            # waiting dispatches before shedding
    priority: int = 0                # strict tiers, higher first
    queue_timeout_s: Optional[float] = None   # deadline while queued


def contracts_from_conf(conf) -> Dict[str, TenantContract]:
    """Every ``tenant.<id>.share`` contract in the conf (bare or
    prefix-namespaced), keyed by tenant id.  A non-positive share, a
    reserved id, or an unparsable quota raises ConfigError — a silent
    mis-parsed contract would hand a tenant the wrong slice of the pool."""
    from avenir_tpu_torch.core.config import ConfigError

    names = set()
    bare_keys = []
    for key in conf.props:
        bare = key[len(conf.prefix) + 1:] if key.startswith(
            conf.prefix + ".") else key
        bare_keys.append(bare)
        m = _SHARE_KEY_RE.match(bare)
        if m:
            names.add(m.group(1))
    # a tenant.* key the grammar does not know is a typo, not a no-op: a
    # silently-dropped contract key hands a tenant the wrong slice of the
    # pool (or no arbitration at all — the exact starvation this family
    # exists to prevent), so refuse it loudly
    for bare in bare_keys:
        if not bare.startswith("tenant."):
            continue
        if _POOL_WIDE_RE.match(bare):
            continue
        m = _TENANT_KEY_RE.match(bare)
        if m is None:
            raise ConfigError(
                f"unrecognized tenant.* key {bare!r} — per-tenant keys "
                f"are tenant.<id>.{{share,max.inflight,queue.depth,"
                f"priority,queue.timeout.ms,slo.*}} with <id> one dotted "
                f"segment, pool-wide keys tenant.{{id,pool.*,queue.*}}")
        if m.group(1) not in names and m.group(1) not in RESERVED_IDS:
            raise ConfigError(
                f"{bare!r} names tenant {m.group(1)!r} which has no "
                f"tenant.{m.group(1)}.share contract — a quota without "
                f"a share arbitrates nothing")
    default_depth = conf.get_int("tenant.queue.depth", 64)
    default_timeout = conf.get_float("tenant.queue.timeout.ms")
    out: Dict[str, TenantContract] = {}
    for name in sorted(names):
        if name in RESERVED_IDS:
            raise ConfigError(
                f"tenant id {name!r} collides with the pool-wide tenant.* "
                f"key family (reserved: {sorted(RESERVED_IDS)})")
        share = conf.get_float(f"tenant.{name}.share")
        if share is None or share <= 0:
            raise ConfigError(
                f"tenant.{name}.share={share!r} must be a positive weight")
        timeout_ms = conf.get_float(f"tenant.{name}.queue.timeout.ms",
                                    default_timeout)
        out[name] = TenantContract(
            tenant=name,
            share=float(share),
            max_inflight=conf.get_int(f"tenant.{name}.max.inflight", 0) or 0,
            queue_depth=max(
                conf.get_int(f"tenant.{name}.queue.depth", default_depth), 1),
            priority=conf.get_int(f"tenant.{name}.priority", 0) or 0,
            queue_timeout_s=(float(timeout_ms) / 1e3
                             if timeout_ms is not None else None),
        )
    return out


def tenant_slo_rules(conf, tenant: str) -> List:
    """The tenant's own SLO rule set: every ``tenant.<id>.slo.<name>.*``
    key re-read through the ``slo.*`` grammar (``slo.* `` semantics —
    metric/target/op/window — apply verbatim).  Evaluate them post-hoc
    over a merged journal with ``telemetry slo --conf ... --label
    tenant=<id>`` so the verdict sees only this tenant's events."""
    from avenir_tpu_torch.core.config import JobConfig
    from avenir_tpu_torch.telemetry.slo import rules_from_conf

    prefix = f"tenant.{tenant}."
    sub: Dict[str, str] = {}
    for key, value in conf.props.items():
        bare = key[len(conf.prefix) + 1:] if key.startswith(
            conf.prefix + ".") else key
        if bare.startswith(prefix):
            sub[bare[len(prefix):]] = value
    return rules_from_conf(JobConfig(sub, prefix=conf.prefix))
