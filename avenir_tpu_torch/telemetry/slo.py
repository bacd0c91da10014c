"""GraftFleet SLO evaluator — declarative service-level objectives over
the observability planes the framework already publishes.

The north-star serving claim ("heavy traffic from millions of users",
ROADMAP item 2) needs a machine-checkable gate, not prose: this module
turns ``slo.<name>.*`` config rules into pass/fail verdicts over the
SAME counter/gauge/latency state GraftTrace journals and ``/metrics``
exposes, evaluated two ways:

- **live** — :class:`SloEvaluator` runs at every ``/metrics`` scrape
  against the batcher's in-process state; each rule renders an
  ``avenir_slo_burn_rate{slo=...,metric=...}`` gauge (observed/target —
  > 1 means the objective is burning) and a transition INTO violation
  journals one golden-schema'd ``slo.violation`` event (re-armed when
  the rule recovers, so a flapping SLO journals each excursion once);
- **post-hoc** — ``python -m avenir_tpu_torch.telemetry slo <journal>``
  evaluates the same rules over a run journal's events (``serve.request``
  span closes for latency percentiles, ``counters`` snapshots for
  shed/recompile totals, ``gauge`` events for queue depths) within each
  rule's trailing window, and exits 0/1 — the CI gate the item-2 soak
  harness closes on.

Rule grammar (properties file, the reference's ``-D`` contract)::

    slo.p99.metric=p99.latency.ms     # what to measure
    slo.p99.target=50                 # the objective
    slo.p99.op=max                    # max (default): value <= target
                                      # min: value >= target
    slo.p99.window.sec=300            # trailing window (post-hoc; default
                                      #   slo.window.sec, else whole run)

Built-in metrics — exactly the four the item-2 soak harness must gate
on, plus generic escapes:

- ``p99.latency.ms`` / ``p50.latency.ms`` — percentile over
  ``serve.request`` wall times (the shared percentile definition,
  ``utils/metrics.percentile_of``, with a stdlib fallback so the journal
  CLI stays runnable without numpy);
- ``shed.rate`` — shed / (requests + shed) across ``Serving.*`` groups;
- ``queue.depth`` — max pending-queue depth observed (live: the
  batcher's queues; post-hoc: ``serve.queue.*`` gauge events);
- ``recompiles.total`` — the steady-state recompile total (every
  ``recompiles`` counter summed; target 0 is the serving invariant —
  the ``steady_state_recompiles_total`` gate);
- ``counter:<Group>:<name>`` / ``gauge:<name>`` — any raw counter or
  journaled gauge.

A rule whose metric has no data (e.g. a p99 rule over a run that served
nothing) reports ``no_data`` and does NOT fail the gate — absence of
traffic is not an SLO violation; the soak harness guarantees traffic.

Stdlib-only at import (``core.config`` is stdlib; numpy is reached for
lazily) so ``python -m avenir_tpu_torch.telemetry`` keeps working on a machine
with no JAX/numpy installed.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional

_RULE_KEY_RE = re.compile(r"^slo\.([A-Za-z0-9_-]+)\.metric$")

# burn rate reported when the target is 0 and the value is not (a
# violated zero-target rule has no finite observed/target ratio)
_BURN_CAP = 1e9


def _percentile(values: List[float], q: float) -> float:
    """numpy's linear-interpolation percentile (the one definition,
    ``utils/metrics.percentile_of``) with a stdlib fallback computing the
    same formula — the CLI must run without numpy installed."""
    if not values:
        return 0.0
    try:
        from avenir_tpu_torch.utils.metrics import percentile_of

        return percentile_of(values, q)
    except ImportError:                            # pragma: no cover
        s = sorted(float(v) for v in values)
        k = (len(s) - 1) * q / 100.0
        lo, hi = math.floor(k), math.ceil(k)
        if lo == hi:
            return s[int(k)]
        return s[lo] + (s[hi] - s[lo]) * (k - lo)


@dataclass(frozen=True)
class SloRule:
    """One declarative objective: measure ``metric``, require it ``op``
    (max: <=, min: >=) ``target`` over the trailing ``window_sec``."""

    name: str
    metric: str
    target: float
    op: str = "max"
    window_sec: Optional[float] = None

    def check(self, value: Optional[float]) -> dict:
        """The rule's verdict row for one observed value (None = the
        metric had no data)."""
        row = {"slo": self.name, "metric": self.metric, "value": value,
               "target": self.target, "op": self.op,
               "window_sec": self.window_sec, "burn_rate": None}
        if value is None:
            row["verdict"] = "no_data"
            return row
        value = float(value)
        row["value"] = round(value, 6)
        if self.op == "min":
            violated = value < self.target
            burn = (self.target / value if value > 0
                    else (0.0 if self.target <= 0 else _BURN_CAP))
        else:
            violated = value > self.target
            burn = (value / self.target if self.target > 0
                    else (0.0 if value <= 0 else _BURN_CAP))
        row["burn_rate"] = round(min(burn, _BURN_CAP), 6)
        row["verdict"] = "violation" if violated else "pass"
        return row


def rules_from_conf(conf) -> List[SloRule]:
    """Every ``slo.<name>.metric`` rule in the conf (bare or
    prefix-namespaced — ``avenir.slo.x.metric`` == ``slo.x.metric``),
    sorted by name.  A rule without a numeric ``slo.<name>.target``
    raises ConfigError — a silent unbounded objective gates nothing."""
    from avenir_tpu_torch.core.config import ConfigError

    default_window = conf.get_float("slo.window.sec")
    names = set()
    for key in conf.props:
        bare = key[len(conf.prefix) + 1:] if key.startswith(
            conf.prefix + ".") else key
        m = _RULE_KEY_RE.match(bare)
        if m:
            names.add(m.group(1))
    rules: List[SloRule] = []
    for name in sorted(names):
        metric = conf.get(f"slo.{name}.metric")
        target = conf.get_float(f"slo.{name}.target")
        if target is None:
            raise ConfigError(
                f"slo.{name}.metric={metric!r} has no numeric "
                f"slo.{name}.target — an SLO without a target gates "
                f"nothing")
        op = (conf.get(f"slo.{name}.op", "max") or "max").strip().lower()
        if op not in ("max", "min"):
            raise ConfigError(
                f"slo.{name}.op={op!r} must be 'max' (value <= target) "
                f"or 'min' (value >= target)")
        rules.append(SloRule(
            name=name, metric=metric, target=float(target), op=op,
            window_sec=conf.get_float(f"slo.{name}.window.sec",
                                      default_window)))
    return rules


def parse_rule_spec(spec: str) -> SloRule:
    """CLI inline rule: ``NAME=METRIC<=TARGET`` or ``NAME=METRIC>=TARGET``
    (the ``--rule`` escape so CI can gate without a properties file)."""
    name, eq, body = spec.partition("=")
    m = re.match(r"^(.*?)(<=|>=)([-+0-9.eE]+)$", body) if eq else None
    if not name or m is None:
        raise ValueError(
            f"--rule expects NAME=METRIC<=TARGET or NAME=METRIC>=TARGET, "
            f"got {spec!r}")
    return SloRule(name=name, metric=m.group(1),
                   target=float(m.group(3)),
                   op="max" if m.group(2) == "<=" else "min")


def filter_events_by_labels(events: List[dict],
                            labels: Mapping[str, str]) -> List[dict]:
    """Events carrying EVERY given label — matched against the record's
    top-level fields (the GraftPool ``label_scope`` stamp / the
    per-process ``tenant.id`` journal stamp) or its span ``attrs``.

    The ``telemetry slo --label tenant=<id>`` seam: one
    merged fleet journal holds every tenant's events, and a per-tenant
    verdict evaluates the same rules over just that tenant's slice —
    unlabeled events (another tenant's, or infrastructure outside any
    scope) are excluded, so tenant A's shed storm can never fail tenant
    B's gate."""
    def match(event: dict) -> bool:
        attrs = event.get("attrs") or {}
        for key, value in labels.items():
            if str(event.get(key)) == value:
                continue
            if str(attrs.get(key)) == value:
                continue
            return False
        return True

    return [e for e in events if match(e)]


# ---------------------------------------------------------------------------
# metric extraction — post-hoc (journal events)
# ---------------------------------------------------------------------------

def _last_counter_groups(events: List[dict]) -> Dict[str, Dict[str, int]]:
    """The LAST ``counters`` snapshot per WRITER, groups summed across
    writers.

    One snapshot per writer — not per scope: a single traced pipeline
    journals the same totals under several scopes (per-stage snapshots,
    the per-job snapshot, and the run-level ``pipeline`` rollup which is
    already the ``merge_add`` sum of every stage), so summing scopes
    would read a clean run as 2-3x its real counts and fail a counter
    SLO falsely.  A writer's chronologically last snapshot is its most
    complete view (the pipeline rollup for driver runs, the job
    snapshot for standalone runs); across DIFFERENT writers of a merged
    fleet journal the totals are disjoint and add."""
    last: Dict[tuple, dict] = {}
    for e in events:
        if e.get("ev") != "counters":
            continue
        key = (e.get("proc"), e.get("host"), e.get("replica"))
        last[key] = e.get("groups", {})
    out: Dict[str, Dict[str, int]] = {}
    for groups in last.values():
        for group, vals in groups.items():
            g = out.setdefault(group, {})
            for name, value in vals.items():
                if isinstance(value, (int, float)):
                    g[name] = g.get(name, 0) + value
    return out


def _shed_rate(groups: Mapping[str, Mapping[str, float]]) -> Optional[float]:
    requests = shed = 0.0
    seen = False
    for group, vals in groups.items():
        if not group.startswith("Serving."):
            continue
        seen = True
        requests += float(vals.get("requests", 0))
        shed += float(vals.get("shed", 0))
    if not seen:
        return None
    total = requests + shed
    return shed / total if total > 0 else 0.0


def _recompiles_total(groups: Mapping[str, Mapping[str, float]]
                      ) -> Optional[float]:
    if not groups:
        return None
    return float(sum(vals.get("recompiles", 0) for vals in groups.values()))


def metric_from_events(metric: str, events: List[dict]) -> Optional[float]:
    """One metric's value over a (window-filtered) event list; None when
    the journal carries no data for it."""
    if metric in ("p99.latency.ms", "p50.latency.ms"):
        durs = [e["dur_ms"] for e in events
                if e.get("ev") == "span.close"
                and e.get("name") == "serve.request"
                and isinstance(e.get("dur_ms"), (int, float))]
        if not durs:
            return None
        return _percentile(durs, 99.0 if metric.startswith("p99") else 50.0)
    if metric == "queue.depth":
        depths = [e.get("value") for e in events
                  if e.get("ev") == "gauge"
                  and str(e.get("name", "")).startswith("serve.queue.")
                  and isinstance(e.get("value"), (int, float))]
        return max(depths) if depths else None
    if metric == "shed.rate":
        return _shed_rate(_last_counter_groups(events))
    if metric == "recompiles.total":
        return _recompiles_total(_last_counter_groups(events))
    if metric.startswith("counter:"):
        parts = metric.split(":", 2)
        if len(parts) != 3:
            return None
        groups = _last_counter_groups(events)
        if parts[1] not in groups:
            return None
        return float(groups[parts[1]].get(parts[2], 0))
    if metric.startswith("gauge:"):
        name = metric.split(":", 1)[1]
        vals = [e.get("value") for e in events
                if e.get("ev") == "gauge" and e.get("name") == name
                and isinstance(e.get("value"), (int, float))]
        return float(vals[-1]) if vals else None
    return None


def evaluate_events(events: List[dict], rules: List[SloRule]) -> dict:
    """Post-hoc verdict over a journal's events: per rule, filter to its
    trailing window (anchored at the journal's LAST event — a crashed
    run's window ends where the run died) and check the target.  Returns
    ``{"verdict", "rules"}`` where verdict is ``violation`` when any
    rule fails, ``pass`` when at least one evaluates clean and none
    fail, ``no_data`` when nothing was measurable, ``no_rules`` when
    the rule set is empty."""
    if not rules:
        return {"verdict": "no_rules", "rules": []}
    t_end = max((float(e.get("ts", 0.0) or 0.0) for e in events),
                default=0.0)
    rows = []
    for rule in rules:
        if rule.window_sec:
            cutoff = t_end - float(rule.window_sec)
            windowed = [e for e in events
                        if float(e.get("ts", 0.0) or 0.0) >= cutoff]
        else:
            windowed = events
        rows.append(rule.check(metric_from_events(rule.metric, windowed)))
    if any(r["verdict"] == "violation" for r in rows):
        verdict = "violation"
    elif any(r["verdict"] == "pass" for r in rows):
        verdict = "pass"
    else:
        verdict = "no_data"
    return {"verdict": verdict, "rules": rows}


# ---------------------------------------------------------------------------
# live evaluation — the serving /metrics seam
# ---------------------------------------------------------------------------

class SloEvaluator:
    """Scrape-time rule evaluation over the batcher's in-process state.

    Stateless per scrape except the violation latch: a rule journals
    ``slo.violation`` exactly once per excursion (on the transition into
    violation; recovery re-arms it), so a scraped-every-15s violating SLO
    does not flood the journal."""

    def __init__(self, rules: List[SloRule]):
        import threading

        self.rules = list(rules)
        # the latch is shared across ThreadingHTTPServer handler threads:
        # without the lock, two concurrent scrapes on the transition tick
        # would both journal the same excursion
        self._lock = threading.Lock()
        self._violating: set = set()

    @classmethod
    def from_conf(cls, conf) -> Optional["SloEvaluator"]:
        rules = rules_from_conf(conf)
        return cls(rules) if rules else None

    def _live_value(self, metric: str, counters, latency,
                    queue_depths: Mapping[str, int],
                    gauges: Optional[Mapping[str, float]] = None
                    ) -> Optional[float]:
        if metric in ("p99.latency.ms", "p50.latency.ms"):
            q = 99.0 if metric.startswith("p99") else 50.0
            vals = [t.percentile(q) * 1e3 for t in latency.values()
                    if t.count > 0]
            return max(vals) if vals else None
        if metric == "queue.depth":
            return float(max(queue_depths.values())) if queue_depths else None
        groups = counters.as_dict()
        if metric == "shed.rate":
            return _shed_rate(groups)
        if metric == "recompiles.total":
            return _recompiles_total(groups)
        if metric.startswith("counter:"):
            parts = metric.split(":", 2)
            if len(parts) != 3 or parts[1] not in groups:
                return None
            return float(groups[parts[1]].get(parts[2], 0))
        if metric.startswith("gauge:"):
            # any gauge the scrape computes (the frontend passes its full
            # gauge page: serve.queue.<model>, uptime.sec); bare callers
            # without a gauges map still resolve the queue-depth family
            name = metric.split(":", 1)[1]
            if gauges is not None and name in gauges:
                return float(gauges[name])
            if name.startswith("serve.queue."):
                depth = queue_depths.get(name[len("serve.queue."):])
                return float(depth) if depth is not None else None
            return None
        return None

    def evaluate_live(self, counters, latency,
                      queue_depths: Mapping[str, int],
                      gauges: Optional[Mapping[str, float]] = None
                      ) -> List[dict]:
        """Verdict rows against live serving state; journals
        ``slo.violation`` on each rule's transition into violation
        (latched under a lock — concurrent scrapes journal one event per
        excursion, not one per scraper)."""
        from avenir_tpu_torch.telemetry import spans as tel

        rows = []
        fire: List[dict] = []
        for rule in self.rules:
            row = rule.check(self._live_value(
                rule.metric, counters, latency, queue_depths,
                gauges=gauges))
            rows.append(row)
            with self._lock:
                if row["verdict"] == "violation":
                    if rule.name not in self._violating:
                        self._violating.add(rule.name)
                        fire.append(row)
                else:
                    self._violating.discard(rule.name)
        for row in fire:
            tel.tracer().event(
                "slo.violation", slo=row["slo"], metric=row["metric"],
                value=row["value"], target=row["target"],
                burn_rate=row["burn_rate"])
        return rows

    @staticmethod
    def render_prometheus(rows: List[dict], lines: List[str],
                          labels: Optional[Mapping[str, str]] = None
                          ) -> None:
        """``avenir_slo_burn_rate`` gauges for the ``/metrics`` page —
        observed/target per rule (> 1 = violating; ``no_data`` rules are
        omitted, absence of traffic is not a burn)."""
        from avenir_tpu_torch.telemetry.export import _escape, _label_text

        base = _label_text(labels)
        lines.append("# HELP avenir_slo_burn_rate Observed/target per SLO "
                     "rule (> 1 = violating).")
        lines.append("# TYPE avenir_slo_burn_rate gauge")
        for row in rows:
            if row["burn_rate"] is None:
                continue
            lines.append(
                f'avenir_slo_burn_rate{{{base}slo="{_escape(row["slo"])}",'
                f'metric="{_escape(row["metric"])}"}} {row["burn_rate"]:g}')


# ---------------------------------------------------------------------------
# bench.py embedding — the post-run verdict next to the sentinel's
# ---------------------------------------------------------------------------

def bench_verdict(journal_path: Optional[str],
                  conf_path: Optional[str]) -> dict:
    """The SLO summary bench.py embeds in its artifact: rules from the
    ``AVENIR_SLO_CONF`` properties file evaluated over the capture's own
    journal.  No rules configured → ``no_rules``; an unreadable or
    malformed rules file → ``rules_error``; rules but no journal
    (``AVENIR_TRACE_DIR`` unset) → ``no_journal`` — the capture publishes
    in every case, mirroring the sentinel's never-fail-the-capture
    contract.  Violated rules journal ``slo.violation`` (the bench owns
    its journal; no-op when tracing is off)."""
    if not conf_path:
        return {"verdict": "no_rules", "rules": []}
    from avenir_tpu_torch.core.config import ConfigError, JobConfig

    try:
        rules = rules_from_conf(JobConfig.from_file(conf_path))
    except (OSError, ConfigError) as exc:
        # an unreadable OR malformed rules file must not kill the
        # capture after all its measurement — surface it as a verdict
        return {"verdict": "rules_error", "error": str(exc), "rules": []}
    if not rules:
        return {"verdict": "no_rules", "rules": []}
    if not journal_path:
        return {"verdict": "no_journal", "rules": []}
    from avenir_tpu_torch.telemetry import spans as tel
    from avenir_tpu_torch.telemetry.journal import read_events

    summary = evaluate_events(read_events(journal_path), rules)
    for row in summary["rules"]:
        if row["verdict"] == "violation":
            tel.tracer().event(
                "slo.violation", slo=row["slo"], metric=row["metric"],
                value=row["value"], target=row["target"],
                burn_rate=row["burn_rate"])
    return summary
