"""The golden journal-event schema; a copy of ``avenir_tpu/telemetry/schema.py``.

The port journals in the JAX package's schema, so either package's reader
and CLI read the other's journals.  ``tests/test_torch_telemetry.py``
holds these dicts equal to the JAX package's and every event the port
emits in its tests against :func:`event_shapes`.

Each entry maps an event name to its exact journal key set, excluding
the writer-identity stamp (:data:`STAMP_KEYS`) that rides every record.
Events with more than one legitimate producer shape (``checkpoint.save``
/ ``checkpoint.restore`` are written by both the stream checkpointer and
the RL supervisor with different fields) list the extra shapes in
:data:`EVENT_SHAPE_VARIANTS`; consumers should use :func:`event_shapes`.
Stdlib only.
"""

from typing import Dict, FrozenSet, Set, Tuple

GOLDEN_EVENT_KEYS: Dict[str, Set[str]] = {
    "span.open": {"ev", "ts", "trace", "span", "parent", "name", "attrs"},
    "span.close": {"ev", "ts", "trace", "span", "name", "dur_ms", "status",
                   "attrs"},
    "counters": {"ev", "ts", "trace", "span", "scope", "groups"},
    "gauge": {"ev", "ts", "trace", "span", "name", "value"},
    "recompile": {"ev", "ts", "trace", "span", "scope", "keys"},
    "checkpoint.save": {"ev", "ts", "trace", "span", "dir", "run", "rows",
                        "chunk"},
    # the stream checkpointer's restore record (stream/windows.py and
    # jobs/base.py share the shape) — the RL supervisor's variant lives
    # in EVENT_SHAPE_VARIANTS
    "checkpoint.restore": {"ev", "ts", "trace", "span", "dir", "run",
                           "rows", "chunk"},
    # the RL supervisor's restart record (pipeline/streaming.py): which
    # scope restarted, the cumulative restart count, and the error that
    # killed the previous incarnation
    "server.restart": {"ev", "ts", "trace", "span", "scope", "restarts",
                       "error"},
    # skipped-stage reporting (pipeline/driver.py): a stage whose output
    # artifact already exists is skipped, journaled with the artifact path
    "stage.skipped": {"ev", "ts", "trace", "span", "stage", "output"},
    # serving-plane replay (serving/replay.py): one record per replayed
    # request log
    "serve.replay": {"ev", "ts", "trace", "span", "model", "rows",
                     "max_inflight"},
    # a rig canary reading (utils/rig_canary.py's matmul canary), timed
    # beside the measured work so interference shows up in the journal;
    # journaled by chip_smoke.py's telemetry phase, read by the telemetry
    # CLI's profile view (the MFU column's peak)
    "canary": {"ev", "ts", "trace", "span", "ms", "when"},
    # GraftFleet: per-device straggler probes
    # (parallel/skew.py — flagged when max/min exceeds the threshold),
    # cross-process collective-wait attribution (parallel/mesh.py), and
    # the SLO evaluator's transition-into-violation record
    # (telemetry/slo.py) — docs/observability.md event table
    "shard.skew": {"ev", "ts", "trace", "span", "chunk", "device_ms",
                   "max_ms", "min_ms", "ratio", "threshold", "slowest",
                   "flagged"},
    "collective.wait": {"ev", "ts", "trace", "span", "site", "wall_ms",
                        "bytes", "procs"},
    "slo.violation": {"ev", "ts", "trace", "span", "slo", "metric",
                      "value", "target", "burn_rate"},
    # the StreamGraft lifecycle: windowed drift scoring, the
    # sustained-drift firing, the retrain completion, and the serving
    # plane's hot swap — docs/observability.md event table
    "drift.window": {"ev", "ts", "trace", "span", "window", "divergence",
                     "threshold", "streak"},
    "drift.detected": {"ev", "ts", "trace", "span", "window", "divergence",
                       "threshold", "windows"},
    "drift.retrain": {"ev", "ts", "trace", "span", "window", "model",
                      "version", "rows", "dur_ms"},
    "drift.retrain.failed": {"ev", "ts", "trace", "span", "window", "model",
                             "error"},
    "model.swap": {"ev", "ts", "trace", "span", "model", "version",
                   "family", "warmed"},
    # ShardGraft: the run's hardware identity — journaled at
    # run start so every bench/journal artifact self-describes what it
    # ran on (device kind, mesh shape, axis names; CrossGraft added the
    # process count — a global mesh's axes carry the proc axis too)
    "shard.topology": {"ev", "ts", "trace", "span", "devices",
                       "device_kind", "mesh", "axes", "procs"},
    # CrossGraft: one coordinator-join record per worker —
    # the hardened bounded join (parallel/mesh.py::journal_fleet_join);
    # proc/host identity rides the GraftFleet stamp
    "fleet.join": {"ev", "ts", "trace", "span", "coordinator", "nprocs",
                   "attempts", "wall_ms"},
    # GraftProf: the compiled-program registry (one event per
    # distinct (site, compile key) with AOT cost fields — null when the
    # backend degrades to shapes-only), the cumulative per-program wall
    # totals, device-memory gauges, the bench sentinel's verdict, and the
    # per-stage XProf capture path — docs/observability.md event table
    "program.compiled": {"ev", "ts", "trace", "span", "key", "site",
                         "flops", "bytes_accessed", "output_bytes",
                         "temp_bytes", "source", "shapes"},
    "program.profile": {"ev", "ts", "trace", "span", "key", "site",
                        "dispatches", "wall_ms"},
    "device.memory": {"ev", "ts", "trace", "span", "site", "device",
                      "bytes_in_use", "peak_bytes"},
    "bench.regression": {"ev", "ts", "trace", "span", "verdict", "compared",
                         "regressed", "skipped", "missing", "baseline"},
    "xla.trace": {"ev", "ts", "trace", "span", "stage", "dir"},
    # ElasticGraft: a restore-time topology crossing — the
    # suffix a snapshot was written under, the one it was redistributed
    # onto, and how many accumulator entries moved
    # (checkpoint/reshard.py::journal_reshard) — and the conf-driven
    # fault family's injected-kill record (utils/retry.py::FaultPlan,
    # journaled BEFORE the raise so a killed run's journal explains
    # itself) — docs/observability.md event table
    "checkpoint.reshard": {"ev", "ts", "trace", "span", "dir", "run",
                           "src", "dst", "keys"},
    "fault.injected": {"ev", "ts", "trace", "span", "site", "hit"},
    # FleetServe: the replica pool's lifecycle — a replica
    # leaving rotation (died / heartbeat / breaker / scale.down, with how
    # many stranded requests were failed over), a replica entering it
    # (start / probe / replace / scale-up), an autoscaler decision over
    # the burn/queue gauges, and one request's failover hop — the events
    # docs/runbooks/replica_loss_triage.md walks (serving/pool.py)
    "pool.replica.down": {"ev", "ts", "trace", "span", "replica",
                          "reason", "pending"},
    "pool.replica.up": {"ev", "ts", "trace", "span", "replica", "reason"},
    "pool.scale": {"ev", "ts", "trace", "span", "direction", "ready",
                   "total", "burn", "queue_frac", "reason"},
    "pool.failover": {"ev", "ts", "trace", "span", "rid", "model",
                      "from", "to", "attempt"},
    # GlobalServe: the FleetServe lifecycle one level up —
    # worker PROCESSES joining/leaving the serving fleet (died/breaker/
    # retire vs spawn/probe), the burn-rate autoscaler at process
    # granularity, per-request failover hops ACROSS processes (`rid` is
    # the router's attempt-qualified id — the zero-lost/zero-double key
    # of the merged-journal accounting), and the rolling fleet-wide swap
    # with the ready-capacity floor it held (serving/global_pool.py).
    "fleet.pool.worker.down": {"ev", "ts", "trace", "span", "worker",
                               "reason", "pending"},
    "fleet.pool.worker.up": {"ev", "ts", "trace", "span", "worker",
                             "reason"},
    "fleet.pool.scale": {"ev", "ts", "trace", "span", "direction", "ready",
                         "total", "burn", "queue_frac", "reason"},
    "fleet.pool.failover": {"ev", "ts", "trace", "span", "rid", "model",
                            "from", "to", "attempt"},
    "fleet.pool.swap": {"ev", "ts", "trace", "span", "worker", "model",
                        "version", "ready", "floor"},
    # GraftPool: the tenant-arbitration lifecycle — a tenant's
    # contract admitted onto the pool (once per journal), the throttle
    # latch firing per excursion (quota/priority/share/backlog pacing),
    # and a tenant-scoped shed carrying the quota that fired plus the
    # queue drain estimate the HTTP 429's Retry-After renders
    # (tenancy/arbiter.py + serving/batcher.py's door shed — same shape)
    "tenant.admitted": {"ev", "ts", "trace", "span", "tenant", "share",
                        "priority", "max_inflight", "queue_depth"},
    "tenant.throttled": {"ev", "ts", "trace", "span", "tenant", "reason",
                         "waiting", "inflight"},
    "tenant.shed": {"ev", "ts", "trace", "span", "tenant", "quota",
                    "waiting", "inflight", "retry_after_ms"},
    # GraftBox: the forensics plane — one record per
    # finalized crash/hang/signal bundle (self-journaled by the dying
    # process when tracing is on, else appended by the teardown sweep's
    # shard — telemetry/blackbox.py), and the progress watchdog's trip
    # record naming the oldest silent seam — docs/observability.md
    # event table, docs/runbooks/postmortem_triage.md
    "bundle.written": {"ev", "ts", "trace", "span", "dir", "reason",
                       "events"},
    "hang.detected": {"ev", "ts", "trace", "span", "site", "silent_s",
                      "threshold"},
    # PlanGraft: the planner's one record of what it decided
    # before anything executed — unit/stage shape, which rewrites fired,
    # and the summed AOT estimate (null when the backend degraded to
    # shapes-only) — pipeline/plan.py::journal_plan
    "plan.compiled": {"ev", "ts", "trace", "span", "units", "stages",
                      "fused", "rewrites", "source", "est_flops",
                      "est_bytes"},
}

# Extra legitimate shapes for events with more than one producer: the RL
# serving supervisor (pipeline/streaming.py) checkpoints its restart
# ledger with {scope, events} where the stream checkpointer writes
# {dir, run, rows, chunk}.
EVENT_SHAPE_VARIANTS: Dict[str, Tuple[FrozenSet[str], ...]] = {
    "checkpoint.save": (
        frozenset({"ev", "ts", "trace", "span", "scope", "events"}),),
    "checkpoint.restore": (
        frozenset({"ev", "ts", "trace", "span", "scope", "events"}),),
}

# GraftFleet: EVERY journaled event additionally carries the
# writer-identity stamp — process index + host (and `replica` when a
# writer suffix is set) — so a merged fleet view attributes each event
# without parsing shard filenames
STAMP_KEYS: Set[str] = {"proc", "host"}

# Events documented as once-per-run (per journal): their producers must
# go through ``Tracer.event_once`` (or an equivalent latch) so restarts,
# retries, and per-chunk paths can't spam duplicates.  graftlint's GL011
# flags plain ``.event()`` emissions of these names.
EVENT_ONCE: Set[str] = {"shard.topology", "fleet.join", "tenant.admitted"}


def event_shapes(ev: str) -> Tuple[FrozenSet[str], ...]:
    """Every allowed key set for ``ev`` (stamp keys excluded)."""
    base = (frozenset(GOLDEN_EVENT_KEYS[ev]),)
    return base + EVENT_SHAPE_VARIANTS.get(ev, ())
