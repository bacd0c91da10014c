"""Telemetry of the port; a copy of ``avenir_tpu/telemetry/`` that journals
in the same schema, so either package's reader and CLI read the other's
journals.

- ``spans``: the process :class:`Tracer` (free until ``trace.on``),
  contextvar-propagated spans, and :class:`CompileKeyMonitor`;
- ``journal``: the append-only JSONL run journal (single-writer,
  rotation-bounded, torn-tail tolerant) and the shard merge;
- ``profile``: the program registry (``profile.on``): analytic costs for
  the hand-written kernels' sites, shapes elsewhere, per-program host
  walls, and ``torch.cuda`` memory gauges;
- ``blackbox``: the flight ring, crash/hang bundles and the watchdog
  (``blackbox.*``);
- ``export``, ``slo``, ``sentinel``: Prometheus text, SLO rules and the
  bench-artifact regression gate;
- ``python -m avenir_tpu_torch.telemetry``: the journal CLI (``tree``,
  ``merge``, ``skew``, ``slo``, ``profile``, ``metrics``, ``regress``,
  ``diff``, ``bundle``), whose output equals the JAX package's on the
  same journal.
"""

from avenir_tpu_torch.telemetry.journal import (
    Journal,
    find_shards,
    latest_journal,
    merge_journals,
    merge_shards,
    read_events,
)
from avenir_tpu_torch.telemetry.profile import (
    CompiledProgramRegistry,
    Profiler,
    profiler,
)
from avenir_tpu_torch.telemetry.spans import (
    NOOP_SPAN,
    CompileKeyMonitor,
    Span,
    Tracer,
    configure,
    fleet_run_id,
    tracer,
)

__all__ = [
    "CompileKeyMonitor",
    "CompiledProgramRegistry",
    "Journal",
    "NOOP_SPAN",
    "Profiler",
    "Span",
    "Tracer",
    "configure",
    "find_shards",
    "fleet_run_id",
    "latest_journal",
    "merge_journals",
    "merge_shards",
    "profiler",
    "read_events",
    "tracer",
]
