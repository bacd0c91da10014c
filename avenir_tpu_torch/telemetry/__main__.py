"""The journal CLI, ``python -m avenir_tpu_torch.telemetry``; a copy of
``avenir_tpu/telemetry/__main__.py`` whose every verb prints the same
bytes as the JAX package's on the same journal (the footers that name
XLA included), so a journal of either package renders alike.

Subcommands (the bare ``<journal>`` form renders the span tree):

- ``<journal>`` / ``tree <journal>`` — per-trace span tree: one line per
  span with its wall duration, the slowest root→leaf path highlighted
  (``◀``), still-open spans flagged (``OPEN`` — the first place to look
  in a wedged run), counter deltas between successive snapshots of the
  same scope, a durability timeline (checkpoint saves and restores,
  restarts, fault drills), and a one-line tally of the free events.  A
  merged view of several writers attributes every span to its writer.
- ``merge <dir>`` — time-order one run's journal shards
  (``run-<id>.proc-<k>[-<sfx>].jsonl``) into one view, tolerating torn
  tails and missing shards; writes ``fleet-<id>.jsonl`` (``--stdout``
  streams it, ``--run`` picks a run).
- ``skew <journal>`` — the straggler table of ``shard.skew`` events.
- ``slo <journal>`` — evaluate ``slo.<name>.*`` rules (``--conf``
  and/or ``--rule NAME=METRIC<=TARGET``, ``--label KEY=VALUE``) over the
  journal; exits 0 clean / 1 violated.
- ``profile <journal>`` — one row per registered program
  (``program.compiled`` + cumulative ``program.profile``): dispatches,
  wall, ms per dispatch, achieved FLOP/s and bytes/s from the program's
  cost, and MFU against ``--peak-tflops`` (or a journal canary).
- ``metrics <journal>`` — the journal's last counter, gauge and
  device-memory snapshot as Prometheus text.
- ``regress <bench.json...> --baseline <artifact>`` — the bench-artifact
  regression sentinel (``telemetry/sentinel.py``); exits 0/1/3.
- ``diff <a.jsonl> <b.jsonl>`` — per-program dispatch / wall / MFU and
  per-span-name wall deltas between two runs, sorted by |Δwall|.
- ``bundle <dir>`` — render a forensics bundle
  (``bundle-<run>-<writer>/``, ``telemetry/blackbox.py``): cause, writer
  identity, the flight-ring tail, the slowest still-open span, thread
  stacks and watchdog state.

Stdlib-only: it runs without torch.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional

from avenir_tpu_torch.telemetry.journal import read_events


def _writer_of(event: dict) -> str:
    """The writer-identity tag an event's GraftFleet stamp encodes:
    ``p<proc>[-<replica>]``, or '' for pre-fleet journals."""
    if "proc" not in event:
        return ""
    tag = f"p{event.get('proc')}"
    if event.get("replica"):
        tag += f"-{event['replica']}"
    return tag


class SpanNode:
    def __init__(self, span_id: str, name: str, parent: Optional[str],
                 attrs: dict, ts: float, writer: str = ""):
        self.span_id = span_id
        self.name = name
        self.parent = parent
        self.attrs = dict(attrs or {})
        self.ts = ts
        self.writer = writer                    # GraftFleet attribution
        self.dur_ms: Optional[float] = None     # None = never closed
        self.status = "open"
        self.children: List["SpanNode"] = []


def build_traces(events: List[dict]) -> Dict[str, List[SpanNode]]:
    """trace id → roots (in open order), children attached."""
    nodes: Dict[str, SpanNode] = {}
    traces: Dict[str, List[SpanNode]] = {}
    for event in events:
        ev = event.get("ev")
        if ev == "span.open":
            node = SpanNode(event.get("span", "?"), event.get("name", "?"),
                            event.get("parent"), event.get("attrs", {}),
                            event.get("at", event.get("ts", 0.0)),
                            writer=_writer_of(event))
            nodes[node.span_id] = node
            parent = nodes.get(node.parent) if node.parent else None
            if parent is not None:
                parent.children.append(node)
            else:
                traces.setdefault(event.get("trace", "?"), []).append(node)
        elif ev == "span.close":
            node = nodes.get(event.get("span", ""))
            if node is not None:
                node.dur_ms = event.get("dur_ms")
                node.status = event.get("status", "ok")
                node.attrs.update(event.get("attrs", {}))
    return traces


def slowest_path(root: SpanNode) -> set:
    """Span ids on the root's max-duration descent — open spans sort as
    infinitely slow (a wedged child IS the slow path)."""
    marked = set()
    node = root
    while node is not None:
        marked.add(node.span_id)
        node = max(node.children, key=lambda ch: (
            ch.dur_ms is None, ch.dur_ms or 0.0), default=None)
    return marked

_INTERESTING_ATTRS = ("job", "stages", "chunks", "rows", "bucket", "model")


def _render_node(node: SpanNode, prefix: str, is_last: bool, hot: set,
                 out: List[str], show_writer: bool = False) -> None:
    connector = "" if not prefix and is_last is None else (
        "└─ " if is_last else "├─ ")
    dur = ("OPEN" if node.dur_ms is None else f"{node.dur_ms:.1f} ms")
    extra = " ".join(f"{k}={node.attrs[k]}" for k in _INTERESTING_ATTRS
                     if k in node.attrs)
    if show_writer and node.writer:
        extra = f"{node.writer}" + (f" {extra}" if extra else "")
    mark = "  ◀" if node.span_id in hot else ""
    bad = f"  [{node.status}]" if node.status not in ("ok", "open") else ""
    label = f"{prefix}{connector}{node.name}"
    pad = max(44 - len(label), 1)
    out.append(f"{label}{' ' * pad}{dur:>10}{mark}{bad}"
               + (f"  ({extra})" if extra else ""))
    child_prefix = prefix + ("" if not prefix and is_last is None else
                             ("   " if is_last else "│  "))
    for i, child in enumerate(node.children):
        _render_node(child, child_prefix, i == len(node.children) - 1,
                     hot, out, show_writer=show_writer)


def counter_deltas(events: List[dict]) -> List[str]:
    """Per-scope deltas between successive counter snapshots (the first
    snapshot of a scope reads as a delta from zero).  Scopes are keyed
    per WRITER in a merged fleet view — two processes' snapshots of the
    same scope are distinct series, not one interleaved one — with the
    ``@writer`` tag shown only when the view actually holds more than
    one writer (a plain single-process journal keeps the round-10
    rendering)."""
    writers = {_writer_of(e) for e in events if e.get("ev") == "counters"}
    tag_writers = len(writers) > 1
    prev: Dict[tuple, Dict[str, Dict[str, int]]] = {}
    out: List[str] = []
    for event in events:
        if event.get("ev") != "counters":
            continue
        writer = _writer_of(event)
        scope = event.get("scope", "?")
        label = f"{scope}@{writer}" if writer and tag_writers else scope
        groups = event.get("groups", {})
        before = prev.get((scope, writer), {})
        for group in sorted(groups):
            for name in sorted(groups[group]):
                delta = groups[group][name] - before.get(group, {}).get(
                    name, 0)
                if delta:
                    out.append(f"  [{label}] {group}::{name} +{delta}")
        prev[(scope, writer)] = groups
    return out


def durability_lines(events: List[dict]) -> List[str]:
    """The run's durability timeline in journal order: checkpoint
    lifecycle, topology crossings, injected drill faults and the replica
    pools' lifecycle, so `fault.injected → pool.replica.down →
    pool.failover → pool.scale` reads straight down."""
    out: List[str] = []
    for e in events:
        ev = e.get("ev")
        if ev in ("checkpoint.save", "checkpoint.restore"):
            detail = (f"run={e.get('run', '?')} chunk={e.get('chunk', '?')} "
                      f"rows={e.get('rows', '?')}"
                      if "chunk" in e else
                      f"scope={e.get('scope', '?')}")
            out.append(f"  {ev:<20} {detail}")
        elif ev == "checkpoint.reshard":
            out.append(f"  {ev:<20} {e.get('src', '?')} -> "
                       f"{e.get('dst', '?')} ({e.get('keys', 0)} key(s)) "
                       f"run={e.get('run', '?')}")
        elif ev == "fault.injected":
            out.append(f"  {ev:<20} site={e.get('site', '?')} "
                       f"hit={e.get('hit', '?')}")
        elif ev in ("pool.replica.down", "pool.replica.up"):
            pending = (f" pending={e['pending']}"
                       if e.get("pending") else "")
            out.append(f"  {ev:<20} replica={e.get('replica', '?')} "
                       f"reason={e.get('reason', '?')}{pending}")
        elif ev == "pool.scale":
            out.append(f"  {ev:<20} {e.get('direction', '?')} -> "
                       f"{e.get('ready', '?')} ready "
                       f"(burn={e.get('burn', '?')} "
                       f"queue_frac={e.get('queue_frac', '?')} "
                       f"reason={e.get('reason', '?')})")
        elif ev == "tenant.admitted":
            out.append(f"  {ev:<20} tenant={e.get('tenant', '?')} "
                       f"share={e.get('share', '?')} "
                       f"priority={e.get('priority', '?')}")
        elif ev == "tenant.throttled":
            out.append(f"  {ev:<20} tenant={e.get('tenant', '?')} "
                       f"reason={e.get('reason', '?')} "
                       f"waiting={e.get('waiting', '?')}")
        elif ev == "tenant.shed":
            out.append(f"  {ev:<20} tenant={e.get('tenant', '?')} "
                       f"quota={e.get('quota', '?')} "
                       f"waiting={e.get('waiting', '?')} "
                       f"retry_after_ms={e.get('retry_after_ms', '?')}")
    return out


def render(events: List[dict], trace_filter: Optional[str] = None
           ) -> List[str]:
    traces = build_traces(events)
    # writer attribution only when the view actually federates ≥2
    # writers — a single-process journal keeps its round-10 rendering
    writers = {_writer_of(e) for e in events if e.get("ev") == "span.open"}
    show_writer = len(writers) > 1
    out: List[str] = []
    for trace_id, roots in traces.items():
        if trace_filter and trace_id != trace_filter:
            continue
        for root in roots:
            total = ("OPEN" if root.dur_ms is None
                     else f"{root.dur_ms:.1f} ms")
            out.append(f"trace {trace_id}  ({root.name}, {total})")
            _render_node(root, "", None, slowest_path(root), out,
                         show_writer=show_writer)
            out.append("")
    deltas = counter_deltas(events)
    if deltas:
        out.append("counter deltas:")
        out.extend(deltas)
        out.append("")
    durability = durability_lines(events)
    if durability:
        out.append("durability timeline:")
        out.extend(durability)
        out.append("")
    tally: Dict[str, int] = {}
    for event in events:
        ev = event.get("ev", "?")
        if ev not in ("span.open", "span.close", "counters"):
            tally[ev] = tally.get(ev, 0) + 1
    if tally:
        out.append("events: " + " · ".join(
            f"{n} {ev}" for ev, n in sorted(tally.items())))
    return out


# ---------------------------------------------------------------------------
# GraftProf renderers
# ---------------------------------------------------------------------------

# one 4096³ bf16 matmul canary call = 2·4096³ FLOPs (utils/rig_canary.py)
_CANARY_FLOPS_PER_CALL = 2.0 * 4096 ** 3


def canary_peak_flops(events: List[dict]) -> Optional[float]:
    """Peak FLOP/s derived from the journal's best (lowest-ms) matmul
    canary reading — the denominator of the profile table's MFU column.
    None when the journal carries no positive canary reading."""
    best = None
    for event in events:
        if event.get("ev") != "canary":
            continue
        ms = event.get("ms")
        if isinstance(ms, (int, float)) and ms > 0:
            best = ms if best is None else min(best, ms)
    if best is None:
        return None
    return _CANARY_FLOPS_PER_CALL / (best / 1e3)


def collect_programs(events: List[dict]) -> Dict[str, dict]:
    """Program key → merged record from ``program.compiled`` (cost
    fields) + ``program.profile`` (cumulative dispatch/wall totals — the
    LAST event per program wins).  Shared by the ``profile`` table and
    the ``diff`` cross-run comparison."""
    programs: Dict[str, dict] = {}
    for event in events:
        ev = event.get("ev")
        if ev == "program.compiled":
            rec = programs.setdefault(event.get("key", "?"), {})
            rec.update(site=event.get("site", "?"),
                       flops=event.get("flops"),
                       bytes_accessed=event.get("bytes_accessed"),
                       output_bytes=event.get("output_bytes"),
                       temp_bytes=event.get("temp_bytes"),
                       source=event.get("source", "shapes"),
                       shapes=event.get("shapes", ""))
        elif ev == "program.profile":
            rec = programs.setdefault(event.get("key", "?"), {})
            rec["site"] = event.get("site", rec.get("site", "?"))
            rec["dispatches"] = event.get("dispatches", 0)
            rec["wall_ms"] = event.get("wall_ms", 0.0)
    return programs


def render_profile(events: List[dict],
                   peak_flops: Optional[float] = None) -> List[str]:
    """The per-program roofline table from ``program.compiled`` (cost
    fields) + ``program.profile`` (cumulative dispatch/wall totals — the
    LAST event per program wins) events."""
    programs = collect_programs(events)
    if not programs:
        return ["journal carries no program.compiled/profile events "
                "(profile.on unset, or the run predates GraftProf)"]
    peak_src = "--peak-tflops override"
    if peak_flops is None:
        peak_flops = canary_peak_flops(events)
        peak_src = "canary-derived; best matmul canary in this journal"
    out = [f"{'program':<12} {'site':<14} {'disp':>6} {'wall ms':>10} "
           f"{'ms/disp':>8} {'GFLOP/s':>9} {'MFU%':>6} {'GB/s':>7}  cost"]
    ordered = sorted(programs.items(),
                     key=lambda kv: -(kv[1].get("wall_ms") or 0.0))
    for key, rec in ordered:
        n = rec.get("dispatches", 0)
        wall_ms = rec.get("wall_ms") or 0.0
        flops = rec.get("flops")
        gflops = mfu = gbps = "-"
        if n and wall_ms > 0 and isinstance(flops, (int, float)):
            achieved = flops * n / (wall_ms / 1e3)
            gflops = f"{achieved / 1e9:.1f}"
            if peak_flops:
                mfu = f"{100.0 * achieved / peak_flops:.2f}"
        ba = rec.get("bytes_accessed")
        if n and wall_ms > 0 and isinstance(ba, (int, float)):
            gbps = f"{ba * n / (wall_ms / 1e3) / 1e9:.2f}"
        out.append(f"{key:<12} {rec.get('site', '?'):<14} {n:>6} "
                   f"{wall_ms:>10.1f} "
                   f"{(wall_ms / n if n else 0.0):>8.2f} {gflops:>9} "
                   f"{mfu:>6} {gbps:>7}  {rec.get('source', 'shapes')}")
    if peak_flops:
        out.append(f"peak: {peak_flops / 1e12:.2f} TFLOP/s ({peak_src})")
    else:
        out.append("peak: unknown — no matmul canary event in this journal "
                   "(pass --peak-tflops); MFU column empty")
    out.append("flops/bytes are XLA cost-model ESTIMATES captured at "
               "compile time, not hardware counters")
    return out


# ---------------------------------------------------------------------------
# GraftBox renderers: cross-run diff + forensics bundles
# ---------------------------------------------------------------------------

def stage_walls(events: List[dict]) -> Dict[str, List[float]]:
    """Span name → [count, total wall ms] over every closed span — the
    per-stage half of the cross-run diff (``fold``/``pane``/``dispatch``
    spans are the pipeline stages)."""
    names: Dict[str, str] = {}
    agg: Dict[str, List[float]] = {}
    for e in events:
        ev = e.get("ev")
        if ev == "span.open":
            names[e.get("span", "?")] = e.get("name", "?")
        elif ev == "span.close":
            dur = e.get("dur_ms")
            if isinstance(dur, (int, float)):
                name = names.get(e.get("span", ""), e.get("name", "?"))
                row = agg.setdefault(name, [0, 0.0])
                row[0] += 1
                row[1] += float(dur)
    return agg


def _program_mfu(rec: dict, peak_flops: Optional[float]) -> Optional[float]:
    n = rec.get("dispatches", 0)
    wall_ms = rec.get("wall_ms") or 0.0
    flops = rec.get("flops")
    if n and wall_ms > 0 and isinstance(flops, (int, float)) and peak_flops:
        return 100.0 * flops * n / (wall_ms / 1e3) / peak_flops
    return None


def render_diff(events_a: List[dict], events_b: List[dict],
                label_a: str = "A", label_b: str = "B") -> List[str]:
    """The cross-run regression table: per-program dispatch / wall /
    ms-per-dispatch / MFU deltas (each side's MFU against its OWN canary
    peak — a slower machine is not a regression) and per-stage span wall
    deltas, both sorted by |Δwall| so the biggest mover reads first."""
    progs_a, progs_b = collect_programs(events_a), collect_programs(events_b)
    peak_a, peak_b = canary_peak_flops(events_a), canary_peak_flops(events_b)
    out: List[str] = [f"A = {label_a}", f"B = {label_b}", ""]

    def fnum(v: Optional[float], spec: str = ".1f") -> str:
        return "-" if v is None else format(v, spec)

    keys = sorted(set(progs_a) | set(progs_b),
                  key=lambda k: -abs((progs_b.get(k, {}).get("wall_ms")
                                      or 0.0)
                                     - (progs_a.get(k, {}).get("wall_ms")
                                        or 0.0)))
    if keys:
        out.append(f"{'program':<12} {'disp A':>7} {'disp B':>7} "
                   f"{'wall A':>9} {'wall B':>9} {'Δwall ms':>9} "
                   f"{'Δms/disp':>9} {'MFU%A':>6} {'MFU%B':>6}")
        for key in keys:
            ra, rb = progs_a.get(key, {}), progs_b.get(key, {})
            na, nb = ra.get("dispatches", 0), rb.get("dispatches", 0)
            wa = ra.get("wall_ms") or 0.0
            wb = rb.get("wall_ms") or 0.0
            pa = (wa / na) if na else None
            pb = (wb / nb) if nb else None
            dper = (pb - pa) if pa is not None and pb is not None else None
            out.append(
                f"{key:<12} {na:>7} {nb:>7} {wa:>9.1f} {wb:>9.1f} "
                f"{wb - wa:>+9.1f} {fnum(dper, '+9.2f') :>9} "
                f"{fnum(_program_mfu(ra, peak_a), '.2f'):>6} "
                f"{fnum(_program_mfu(rb, peak_b), '.2f'):>6}")
        out.append("")
    else:
        out.append("no program.compiled/profile events on either side "
                   "(profile.on unset in both runs); program table empty")
        out.append("")

    stages_a, stages_b = stage_walls(events_a), stage_walls(events_b)
    names = sorted(set(stages_a) | set(stages_b),
                   key=lambda n: -abs(stages_b.get(n, [0, 0.0])[1]
                                      - stages_a.get(n, [0, 0.0])[1]))
    if names:
        out.append(f"{'stage':<28} {'n A':>6} {'n B':>6} "
                   f"{'wall A':>10} {'wall B':>10} {'Δwall ms':>10}")
        for name in names:
            ca, wa = stages_a.get(name, [0, 0.0])
            cb, wb = stages_b.get(name, [0, 0.0])
            out.append(f"{name:<28} {ca:>6} {cb:>6} {wa:>10.1f} "
                       f"{wb:>10.1f} {wb - wa:>+10.1f}")
    else:
        out.append("no closed spans on either side (trace.on unset in "
                   "both runs); stage table empty")
    out.append("")
    out.append("Δ = B - A; MFU against each side's own canary peak "
               + f"(A: {fnum(peak_a and peak_a / 1e12, '.2f')} TFLOP/s, "
               + f"B: {fnum(peak_b and peak_b / 1e12, '.2f')} TFLOP/s)")
    return out


def diff_cli(rest: List[str]) -> int:
    """``diff <a.jsonl> <b.jsonl>`` — the cross-run regression diff."""
    ap = argparse.ArgumentParser(
        prog="python -m avenir_tpu_torch.telemetry diff",
        description="Per-program / per-stage dispatch, wall and MFU "
                    "deltas between two runs' journals (Δ = B - A)")
    ap.add_argument("a", help="baseline journal (run-*.jsonl or merged "
                              "fleet view)")
    ap.add_argument("b", help="candidate journal to compare against it")
    args = ap.parse_args(rest)
    try:
        events_a = read_events(args.a)
        events_b = read_events(args.b)
    except OSError as exc:
        print(f"cannot read journal: {exc}", file=sys.stderr)
        return 2
    for line in render_diff(events_a, events_b,
                            label_a=args.a, label_b=args.b):
        print(line)
    return 0


def _load_json(path: str, default):
    try:
        with open(path, "r", encoding="utf-8") as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return default


def _read_ring(path: str) -> List[dict]:
    out: List[dict] = []
    try:
        with open(path, "r", encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if line:
                    try:
                        out.append(json.loads(line))
                    except ValueError:       # torn tail: SIGKILL mid-write
                        pass
    except OSError:
        pass
    return out


def _ring_line(rec: dict, t_end: float) -> str:
    fields = " ".join(f"{k}={rec[k]}" for k in rec
                      if k not in ("ts", "ev"))
    dt = rec.get("ts", t_end) - t_end
    return (f"  {dt:>+9.3f}s  {rec.get('ev', '?'):<22}"
            + (f"  {fields}" if fields else ""))


def open_spans_in_ring(ring: List[dict]) -> List[dict]:
    """``span.open`` entries with no matching ``span.close`` in the ring,
    oldest first — a wedged run's stuck stage.  Empty when the run traced
    nothing (``trace.on`` off records no span seams in the ring)."""
    opens: Dict[str, dict] = {}
    for rec in ring:
        ev = rec.get("ev")
        if ev == "span.open":
            opens[rec.get("span", "?")] = rec
        elif ev == "span.close":
            opens.pop(rec.get("span", ""), None)
    return sorted(opens.values(), key=lambda r: r.get("ts", 0.0))


def render_bundle(bundle_dir: str, tail: int = 20,
                  stack_lines: int = 40) -> List[str]:
    """The whole post-mortem from one forensics bundle directory: cause,
    flight-ring tail, slowest open span, in-flight requests, pool /
    breaker / watchdog state, device memory, thread stacks."""
    meta = _load_json(os.path.join(bundle_dir, "meta.json"), {})
    ring = _read_ring(os.path.join(bundle_dir, "ring.jsonl"))
    out = [f"bundle {bundle_dir}"]
    out.append(f"  reason={meta.get('reason') or '?'} "
               f"status={meta.get('status', '?')} "
               f"writer={meta.get('writer', '?')} "
               f"run={meta.get('run', '?')} pid={meta.get('pid', '?')} "
               f"journaled={meta.get('journaled', False)}")
    if meta.get("argv"):
        out.append(f"  argv: {' '.join(str(a) for a in meta['argv'])}")
    out.append("")

    t_end = ring[-1].get("ts", 0.0) if ring else 0.0
    shown = ring[-tail:]
    out.append(f"flight ring — last {len(shown)} of {len(ring)} event(s), "
               "times relative to the newest:")
    for rec in shown:
        out.append(_ring_line(rec, t_end))
    if not ring:
        out.append("  (empty)")
    out.append("")

    open_spans = open_spans_in_ring(ring)
    if open_spans:
        oldest = open_spans[0]
        age = t_end - oldest.get("ts", t_end)
        out.append(f"slowest open span: {oldest.get('name', '?')} "
                   f"(span={oldest.get('span', '?')}, open {age:.3f}s "
                   "before the ring's newest event)")
        for rec in open_spans[1:]:
            out.append(f"  also open: {rec.get('name', '?')} "
                       f"(+{t_end - rec.get('ts', t_end):.3f}s)")
        out.append("")

    inflight = _load_json(os.path.join(bundle_dir, "inflight.json"), {})
    rows = [(src, row) for src, got in sorted(inflight.items())
            for row in (got if isinstance(got, list) else [got])]
    if rows:
        out.append(f"in-flight requests ({len(rows)}):")
        for src, row in rows:
            if isinstance(row, dict):
                detail = " ".join(f"{k}={v}" for k, v in row.items())
            else:
                detail = str(row)
            out.append(f"  [{src}] {detail}")
        out.append("")

    state = _load_json(os.path.join(bundle_dir, "state.json"), {})
    dog = state.get("watchdog") or {}
    if dog.get("sec"):
        active = dog.get("active") or {}
        sites = " ".join(f"{s}({v.get('active_s', '?')}s)"
                         for s, v in sorted(active.items()))
        out.append(f"watchdog: threshold={dog.get('sec')}s "
                   f"silent={dog.get('silent_s', '?')}s "
                   f"tripped={dog.get('tripped', False)}"
                   + (f" active: {sites}" if sites else ""))
    for src in sorted(state):
        if src in ("watchdog",):
            continue
        got = state[src]
        if isinstance(got, list):
            for row in got:
                detail = (" ".join(f"{k}={v}" for k, v in row.items())
                          if isinstance(row, dict) else str(row))
                out.append(f"  [{src}] {detail}")
        elif got is not None:
            out.append(f"  [{src}] {json.dumps(got, default=repr)}")
    if dog.get("sec") or any(s != "watchdog" for s in state):
        out.append("")

    memory = _load_json(os.path.join(bundle_dir, "memory.json"), {})
    gauges = memory.get("device_memory") or {}
    if gauges:
        out.append("device memory: " + " ".join(
            f"{k}={v}" for k, v in sorted(gauges.items())))
        out.append("")

    try:
        with open(os.path.join(bundle_dir, "stacks.txt"), "r",
                  encoding="utf-8") as fh:
            stacks = fh.read().splitlines()
    except OSError:
        stacks = []
    if stacks:
        out.append("stacks:")
        for line in stacks[:stack_lines]:
            out.append(f"  {line}")
        if len(stacks) > stack_lines:
            out.append(f"  … {len(stacks) - stack_lines} more line(s) in "
                       f"{os.path.join(bundle_dir, 'stacks.txt')}")
    return out


def bundle_cli(rest: List[str]) -> int:
    """``bundle <dir>`` — render a GraftBox forensics bundle."""
    ap = argparse.ArgumentParser(
        prog="python -m avenir_tpu_torch.telemetry bundle",
        description="Render a GraftBox forensics bundle "
                    "(bundle-<run>-<writer>/) as a post-mortem: cause, "
                    "flight-ring tail, open spans, in-flight requests, "
                    "pool/breaker/watchdog state, thread stacks")
    ap.add_argument("directory", help="bundle-<run>-<writer> directory")
    ap.add_argument("--tail", type=int, default=20,
                    help="flight-ring events to show (default 20)")
    ap.add_argument("--stack-lines", type=int, default=40,
                    help="stack-trace lines to show (default 40)")
    args = ap.parse_args(rest)
    if not os.path.isfile(os.path.join(args.directory, "meta.json")):
        print(f"{args.directory!r} is not a forensics bundle "
              "(no meta.json)", file=sys.stderr)
        return 2
    for line in render_bundle(args.directory, tail=max(args.tail, 1),
                              stack_lines=max(args.stack_lines, 1)):
        print(line)
    return 0


# ---------------------------------------------------------------------------
# GraftFleet renderers
# ---------------------------------------------------------------------------

def render_skew(events: List[dict]) -> List[str]:
    """The straggler table from ``shard.skew`` events: per-device
    chunk-time distribution (count/mean/p50/max ms), the slowest device
    highlighted (``◀``), and threshold-flagged probes tallied — the
    post-hoc half of ``parallel/skew.py``."""
    probes = [e for e in events if e.get("ev") == "shard.skew"
              and isinstance(e.get("device_ms"), list)]
    if not probes:
        return ["journal carries no shard.skew events (profile.on unset, "
                "no shard.* topology, or the run predates GraftFleet)"]
    per_device: Dict[int, List[float]] = {}
    flag_count: Dict[int, int] = {}
    labels: Dict[int, str] = {}
    flagged_probes = 0
    threshold = probes[-1].get("threshold")
    for e in probes:
        ms = [float(v) for v in e["device_ms"]]
        for d, v in enumerate(ms):
            per_device.setdefault(d, []).append(v)
        if e.get("flagged"):
            flagged_probes += 1
            slow = ms.index(max(ms))
            flag_count[slow] = flag_count.get(slow, 0) + 1
            labels.setdefault(slow, str(e.get("slowest", slow)))

    # the ONE percentile definition (utils/metrics via slo's numpy-free
    # fallback) — not a third private median in the same package
    from avenir_tpu_torch.telemetry.slo import _percentile

    def p50(vals: List[float]) -> float:
        return _percentile(vals, 50.0)

    means = {d: sum(v) / len(v) for d, v in per_device.items()}
    slowest_dev = max(means, key=lambda d: means[d])
    out = [f"{'device':<14} {'probes':>7} {'mean ms':>9} {'p50 ms':>9} "
           f"{'max ms':>9} {'flags':>6}"]
    for d in sorted(per_device):
        vals = per_device[d]
        mark = "  ◀ slowest" if d == slowest_dev else ""
        out.append(f"{labels.get(d, f'dev:{d}'):<14} {len(vals):>7} "
                   f"{means[d]:>9.3f} {p50(vals):>9.3f} {max(vals):>9.3f} "
                   f"{flag_count.get(d, 0):>6}{mark}")
    out.append(f"probes: {len(probes)} · flagged: {flagged_probes}"
               + (f" (threshold max/min > {threshold:g})"
                  if isinstance(threshold, (int, float)) else ""))
    out.append("times are sampled probe dispatches of the per-device gram "
               "(parallel/skew.py) — skew RATIOS attribute stragglers; "
               "absolute ms excludes collective overlap")
    return out


def merge_cli(rest: List[str]) -> int:
    """``merge <dir>`` — reassemble one run's journal shards into a
    fleet view file (or stdout)."""
    ap = argparse.ArgumentParser(
        prog="python -m avenir_tpu_torch.telemetry merge",
        description="Merge a run's per-process journal shards into one "
                    "time-ordered fleet view")
    ap.add_argument("directory", help="directory holding run-*.jsonl shards")
    ap.add_argument("--run", default=None,
                    help="run id to merge (default: most recently written)")
    ap.add_argument("--out", default=None,
                    help="output path (default <dir>/fleet-<run>.jsonl)")
    ap.add_argument("--stdout", action="store_true",
                    help="stream merged JSONL to stdout instead of a file")
    args = ap.parse_args(rest)
    from avenir_tpu_torch.telemetry.journal import merge_journals

    run_id, shards, events = merge_journals(args.directory, run_id=args.run)
    if run_id is None:
        print(f"no run-*.jsonl journal shards under {args.directory!r}"
              + (f" for run {args.run!r}" if args.run else ""),
              file=sys.stderr)
        return 2
    lines = [json.dumps(e, separators=(",", ":")) for e in events]
    if args.stdout:
        for line in lines:
            print(line)
        return 0
    out_path = args.out or os.path.join(args.directory,
                                        f"fleet-{run_id}.jsonl")
    with open(out_path, "w", encoding="utf-8") as fh:
        fh.write("\n".join(lines) + ("\n" if lines else ""))
    writers = sorted({w for w in (_writer_of(e) for e in events) if w})
    print(f"run {run_id}: merged {len(shards)} shard(s), "
          f"{len(events)} events"
          + (f", writers {', '.join(writers)}" if writers else "")
          + f" -> {out_path}")
    return 0


def slo_cli(rest: List[str]) -> int:
    """``slo <journal>`` — the post-hoc SLO gate; exits 0 clean /
    1 violated / 2 usage."""
    from avenir_tpu_torch.telemetry import slo as slo_mod

    ap = argparse.ArgumentParser(
        prog="python -m avenir_tpu_torch.telemetry slo",
        description="Evaluate slo.<name>.* rules over a run journal "
                    "(exit 0 clean, 1 violated)")
    ap.add_argument("journal", help="run-*.jsonl or merged fleet view")
    ap.add_argument("--conf", default=None,
                    help="properties file carrying slo.<name>.* rules")
    ap.add_argument("--rule", action="append", default=[],
                    metavar="NAME=METRIC<=TARGET",
                    help="inline rule (repeatable; >= for lower bounds)")
    ap.add_argument("--label", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="evaluate only events carrying this label "
                         "(repeatable; e.g. tenant=analytics — the "
                         "per-tenant verdict over a merged fleet journal)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="print the full summary as JSON")
    args = ap.parse_args(rest)
    labels = {}
    for spec in args.label:
        key, eq, value = spec.partition("=")
        if not key or not eq:
            print(f"--label expects KEY=VALUE, got {spec!r}",
                  file=sys.stderr)
            return 2
        labels[key] = value
    rules = []
    if args.conf:
        from avenir_tpu_torch.core.config import ConfigError, JobConfig

        try:
            rules.extend(slo_mod.rules_from_conf(
                JobConfig.from_file(args.conf)))
        except (OSError, ConfigError) as exc:
            print(f"cannot load SLO rules: {exc}", file=sys.stderr)
            return 2
    for spec in args.rule:
        try:
            rules.append(slo_mod.parse_rule_spec(spec))
        except ValueError as exc:
            print(str(exc), file=sys.stderr)
            return 2
    if not rules:
        print("no SLO rules: pass --conf <properties> and/or "
              "--rule NAME=METRIC<=TARGET", file=sys.stderr)
        return 2
    try:
        events = read_events(args.journal)
    except OSError as exc:
        print(f"cannot read journal: {exc}", file=sys.stderr)
        return 2
    if labels:
        events = slo_mod.filter_events_by_labels(events, labels)
    summary = slo_mod.evaluate_events(events, rules)
    if args.as_json:
        print(json.dumps(summary))
    else:
        scope = ("".join(f" [{k}={v}]" for k, v in sorted(labels.items()))
                 if labels else "")
        print(f"{args.journal}{scope}: {summary['verdict'].upper()}")
        for row in summary["rules"]:
            burn = ("-" if row["burn_rate"] is None
                    else f"{row['burn_rate']:.3f}")
            bound = "<=" if row["op"] == "max" else ">="
            print(f"  {row['verdict']:>9}  {row['slo']:<16} "
                  f"{row['metric']:<24} {row['value']} {bound} "
                  f"{row['target']:g}  burn {burn}")
    return 1 if summary["verdict"] == "violation" else 0


class _Groups:
    """Duck-typed Counters stand-in (``as_dict`` only) so the stdlib CLI
    can reuse export.render_counters without importing numpy."""

    def __init__(self, groups: dict):
        self._groups = groups

    def as_dict(self) -> dict:
        return self._groups


def render_metrics(events: List[dict]) -> str:
    """The journal's LAST counter snapshot, gauge readings and
    device-memory samples as Prometheus text — the post-hoc ``/metrics``
    for batch-only and crashed runs."""
    from avenir_tpu_torch.telemetry.export import prometheus_text

    last_counters: Optional[dict] = None
    scope = None
    gauges: Dict[str, float] = {}
    device_bytes: Dict[tuple, float] = {}
    for event in events:
        ev = event.get("ev")
        if ev == "counters":
            last_counters = event.get("groups", {})
            scope = event.get("scope")
        elif ev == "gauge":
            gauges[str(event.get("name", "?"))] = float(
                event.get("value", 0.0))
        elif ev == "device.memory":
            dev = str(event.get("device", "?"))
            device_bytes[(dev, "bytes_in_use")] = float(
                event.get("bytes_in_use", 0))
            device_bytes[(dev, "peak_bytes")] = float(
                event.get("peak_bytes", 0))
    if last_counters is None and not gauges and not device_bytes:
        return ("# journal carries no counters/gauge/device.memory "
                "snapshots to render\n")
    head = f"# last counter snapshot scope: {scope}\n" if scope else ""
    return head + prometheus_text(
        counters=_Groups(last_counters) if last_counters is not None
        else None,
        gauges=gauges or None, device_bytes=device_bytes or None)


def main(argv: List[str]) -> int:
    # subcommand dispatch with the legacy bare-journal form preserved
    commands = ("tree", "profile", "metrics", "regress", "merge", "skew",
                "slo", "diff", "bundle")
    if argv and argv[0] in commands:
        cmd, rest = argv[0], argv[1:]
    else:
        cmd, rest = "tree", list(argv)
    if cmd == "regress":
        from avenir_tpu_torch.telemetry.sentinel import cli as regress_cli

        return regress_cli(rest)
    if cmd == "merge":
        return merge_cli(rest)
    if cmd == "slo":
        return slo_cli(rest)
    if cmd == "diff":
        return diff_cli(rest)
    if cmd == "bundle":
        return bundle_cli(rest)

    ap = argparse.ArgumentParser(
        prog=f"python -m avenir_tpu_torch.telemetry {cmd}".rstrip(),
        description="Render a GraftTrace/GraftProf run journal")
    ap.add_argument("journal", help="run-*.jsonl journal file")
    if cmd == "tree":
        ap.add_argument("--trace", default=None,
                        help="render only this trace id")
        ap.add_argument("--json", action="store_true", dest="as_json",
                        help="dump the decoded events as a JSON array")
    elif cmd == "profile":
        ap.add_argument("--peak-tflops", type=float, default=None,
                        help="override the canary-derived peak (TFLOP/s)")
    args = ap.parse_args(rest)
    try:
        events = read_events(args.journal)
    except OSError as exc:
        print(f"cannot read journal: {exc}", file=sys.stderr)
        return 2
    try:
        if cmd == "profile":
            peak = (args.peak_tflops * 1e12
                    if args.peak_tflops is not None else None)
            for line in render_profile(events, peak_flops=peak):
                print(line)
            return 0
        if cmd == "metrics":
            print(render_metrics(events), end="")
            return 0
        if cmd == "skew":
            for line in render_skew(events):
                print(line)
            return 0
        if args.as_json:
            print(json.dumps(events))
            return 0
        if not events:
            print("journal carries no decodable events", file=sys.stderr)
            return 1
        for line in render(events, trace_filter=args.trace):
            print(line)
    except BrokenPipeError:                # | head closed the pipe: fine
        sys.stderr.close()                 # suppress the shutdown warning
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
