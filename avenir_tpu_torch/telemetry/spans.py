"""Run-scoped structured tracing — spans, the process tracer, and the
recompile monitor; a copy of ``avenir_tpu/telemetry/spans.py``.

One trace id per run, one span per unit of work: ``Pipeline.run`` opens a
root span, each stage, job, scan, chunk and tree level opens a child, and
every open/close is journaled (``telemetry/journal.py``) in the JAX
package's schema, so a slow or wedged run reads as one tree
(``python -m avenir_tpu_torch.telemetry <journal>``).  Design constraints:

- **off by default is free**: the process :class:`Tracer` is a no-op until
  ``trace.on`` enables it — ``span()`` then returns a shared inert span
  object, so the hot paths pay one attribute check and no allocation.
- **contextvar propagation**: the current span rides a ``contextvars``
  variable, so nesting needs no plumbing and concurrent threads never
  share a current span.  Work that crosses threads (the DeviceFeeder's
  worker) captures the submitting context explicitly and emits its
  spans retroactively (:meth:`Tracer.emit_span`) with that parent.
- **honest wall times**: CUDA launches are asynchronous, so a span
  measuring device work registers its output via :meth:`Span.block_on`
  and the close synchronizes through ``utils/profiling.device_sync``.
- **single-writer journal shards**: a writer with a suffix
  (``trace.writer.suffix``, or ``tenant.id``) or a shared
  ``trace.run.id`` journals to its own shard
  ``run-<id>.proc-<k>[-<suffix>].jsonl``; every event is stamped with
  ``proc``/``host`` (and ``replica`` when a suffix is set), and
  ``python -m avenir_tpu_torch.telemetry merge <dir>`` time-orders the
  shards into one view.  The port runs one process, so ``proc`` is 0
  (multi-process runs are ROADMAP.md, Queue 1 item 7h).

:class:`CompileKeyMonitor` counts the dispatch shapes of a chunk loop
that differ from every shape before: each key outside the primed set
increments ``Telemetry::recompiles`` and journals a ``recompile`` event.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import os
import threading
import time
from typing import Any, Dict, Iterable, Iterator, Optional

from avenir_tpu_torch.telemetry import blackbox as _blackbox
from avenir_tpu_torch.telemetry.journal import Journal

_CURRENT: "contextvars.ContextVar[Optional[Span]]" = contextvars.ContextVar(
    "avenir_tpu_current_span", default=None)

# Ambient journal labels.  A tenant's workload runs under
# ``label_scope(tenant=...)`` and every event emitted from inside — span
# opens/closes, counter snapshots, gauges, recompiles — is stamped with
# the label at emit time, so one merged journal attributes every span to
# its tenant without per-seam plumbing.  Independent of ``trace.on``.
_LABELS: "contextvars.ContextVar[Optional[Dict[str, Any]]]" = \
    contextvars.ContextVar("avenir_tpu_trace_labels", default=None)


def current_labels() -> Dict[str, Any]:
    """A copy of the ambient label set ({} outside any scope)."""
    return dict(_LABELS.get() or {})


def current_label(key: str) -> Optional[Any]:
    """One ambient label (no dict copy)."""
    labels = _LABELS.get()
    return labels.get(key) if labels else None


@contextlib.contextmanager
def label_scope(**labels) -> Iterator[None]:
    """Attach journal labels to everything emitted inside the scope.
    Scopes nest (inner wins on a shared key); ``None`` values are
    dropped, so ``label_scope(tenant=conf.get("tenant.id"))`` is a
    no-op scope when the conf names no tenant."""
    live = {k: v for k, v in labels.items() if v is not None}
    merged = {**(_LABELS.get() or {}), **live}
    token = _LABELS.set(merged)
    try:
        yield
    finally:
        _LABELS.reset(token)


class Span:
    """One unit of work: identity (trace/span/parent ids), a name, attrs,
    and wall times.  Mutate attrs via :meth:`set`; register async device
    output via :meth:`block_on` so the close time is honest."""

    __slots__ = ("tracer", "trace_id", "span_id", "parent_id", "name",
                 "attrs", "ts", "_t0", "dur_ms", "status", "_pending")

    def __init__(self, tracer: "Tracer", trace_id: str, span_id: str,
                 parent_id: Optional[str], name: str,
                 attrs: Optional[Dict[str, Any]]):
        self.tracer = tracer
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.attrs: Dict[str, Any] = dict(attrs or {})
        self.ts = time.time()
        self._t0 = time.perf_counter()
        self.dur_ms: Optional[float] = None
        self.status = "ok"
        self._pending = None

    @property
    def enabled(self) -> bool:
        return True

    def set(self, key: str, value: Any) -> "Span":
        self.attrs[key] = value
        return self

    def block_on(self, value):
        """Register the span's device output; host-synced at close so the
        recorded duration covers the compute, not just the dispatch."""
        self._pending = value
        return value

    def event(self, ev: str, **fields) -> None:
        """Journal an event carrying this span's identity."""
        self.tracer._journal_emit(ev, trace=self.trace_id,
                                  span=self.span_id, **fields)

    def _close(self) -> None:
        if self._pending is not None:
            from avenir_tpu_torch.utils.profiling import device_sync

            device_sync(self._pending)
            self._pending = None
        self.dur_ms = (time.perf_counter() - self._t0) * 1e3


class _NoopSpan:
    """The shared inert span handed out while tracing is off — every
    operation is a no-op, so instrumented code needs no ``if`` guards."""

    __slots__ = ()
    enabled = False
    trace_id = span_id = parent_id = None
    attrs: Dict[str, Any] = {}

    def set(self, key, value):
        return self

    def block_on(self, value):
        return value

    def event(self, ev, **fields):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP_SPAN = _NoopSpan()


def _new_id(prefix: str) -> str:
    return prefix + os.urandom(6).hex()


class Tracer:
    """Process-wide span factory + journal front.  Disabled (free) until
    :meth:`enable`; ``configure(conf)`` wires it from ``trace.*`` keys."""

    def __init__(self):
        self.enabled = False
        self.journal: Optional[Journal] = None
        self._seq = itertools.count(1)           # thread-safe in CPython
        self._lock = threading.Lock()
        self._once: set = set()                  # event_once keys, per journal
        # writer identity: the journal stamp every event carries, the
        # span-id prefix that keeps ids unique across a run's shards, and
        # the shared root trace id that makes the shards ONE trace
        self.stamp: dict = {}
        self.process_index = 0
        self.writer_suffix = ""
        self._span_prefix = ""
        self._root_trace: Optional[str] = None

    # -- lifecycle -----------------------------------------------------------
    def enable(self, journal_dir: Optional[str] = None,
               max_bytes: int = 64 << 20, run_id: Optional[str] = None,
               suffix: str = "", tenant: str = "") -> "Tracer":
        """Turn tracing on; with ``journal_dir``, open the run journal
        there (single-writer, rotation-bounded).

        Plain form (no ``run_id``/``suffix``): the ``run-<random>.jsonl``
        single-writer journal.  Shard form — a shared ``run_id``
        (``configure`` derives it from the conf) or a ``suffix`` naming a
        replica or tenant — opens this writer's shard
        ``run-<id>.proc-<k>[-<suffix>].jsonl``, stamps every event with
        ``proc``/``host``/``replica``, prefixes span ids with the writer
        identity, and roots new traces at the run-derived trace id so all
        shards share one trace."""
        # one process: multi-process runs are ROADMAP.md, Queue 1 item 7h
        proc = 0
        import socket

        with self._lock:
            if self.enabled:
                return self
            self.process_index = proc
            self.writer_suffix = suffix or ""
            self.stamp = {"proc": proc, "host": socket.gethostname()}
            if suffix:
                self.stamp["replica"] = suffix
            if tenant:
                # a process dedicated to one tenant (tenant.id in its
                # conf) stamps every record
                self.stamp["tenant"] = tenant
            fleet = bool(run_id) or bool(suffix) or proc != 0
            if fleet:
                writer = f"proc-{proc}" + (f"-{suffix}" if suffix else "")
                name = f"run-{run_id or _new_id('')}.{writer}.jsonl"
                self._span_prefix = f"p{proc}" + \
                    (f"-{suffix}" if suffix else "") + "."
                self._root_trace = f"t{run_id}" if run_id else None
            else:
                name = f"run-{_new_id('')}.jsonl"
                self._span_prefix = ""
                self._root_trace = None
            if journal_dir:
                self.journal = Journal(os.path.join(journal_dir, name),
                                       max_bytes=max_bytes,
                                       stamp=self.stamp)
            self._once.clear()                   # fresh journal, fresh onces
            self.enabled = True
        return self

    def disable(self) -> None:
        """Turn tracing off and close the journal (tests, run teardown).
        The profiler flushes its cumulative program.profile totals into
        the journal FIRST (its accounting rides this journal), then drops
        its state — the two planes share one lifecycle."""
        from avenir_tpu_torch.telemetry import profile as _profile

        prof = _profile.profiler()
        prof.flush()
        prof.disable()
        with self._lock:
            self.enabled = False
            self._once.clear()
            self._span_prefix = ""
            self._root_trace = None
            self.writer_suffix = ""
            self.stamp = {}
            if self.journal is not None:
                self.journal.close()
                self.journal = None

    @property
    def journal_path(self) -> Optional[str]:
        return self.journal.path if self.journal is not None else None

    # -- span factory --------------------------------------------------------
    def current(self) -> Optional[Span]:
        """The context's live span (cross-thread parent capture), or None
        when tracing is off or no span is open."""
        return _CURRENT.get() if self.enabled else None

    def span(self, name: str, attrs: Optional[Dict[str, Any]] = None,
             parent: Optional[Span] = None):
        """Open a child of the context's current span (or of ``parent``
        when crossing a thread); a span with no parent roots a new trace.
        Disabled: returns the shared NOOP span directly — one attribute
        check, no generator frame, no allocation."""
        if not self.enabled:
            return NOOP_SPAN
        return self._live_span(name, attrs, parent)

    @contextlib.contextmanager
    def _live_span(self, name: str, attrs: Optional[Dict[str, Any]],
                   parent: Optional[Span]) -> Iterator[Span]:
        up = parent if parent is not None else _CURRENT.get()
        trace_id = (up.trace_id if up is not None
                    else self._root_trace or _new_id("t"))
        sp = Span(self, trace_id, self._next_span_id(),
                  up.span_id if up is not None else None, name, attrs)
        token = _CURRENT.set(sp)
        self._journal_emit("span.open", trace=sp.trace_id, span=sp.span_id,
                           parent=sp.parent_id, name=sp.name,
                           attrs=sp.attrs)
        try:
            yield sp
        except BaseException as exc:
            sp.status = f"error:{type(exc).__name__}"
            raise
        finally:
            _CURRENT.reset(token)
            sp._close()
            self._journal_emit("span.close", trace=sp.trace_id,
                               span=sp.span_id, name=sp.name,
                               dur_ms=round(sp.dur_ms, 3),
                               status=sp.status, attrs=sp.attrs)

    def emit_span(self, name: str, dur_s: float,
                  parent: Optional[Span] = None,
                  attrs: Optional[Dict[str, Any]] = None,
                  status: str = "ok") -> None:
        """Retroactively journal a completed span — the cross-thread form
        (the feeder's worker) where the work finished on a thread that
        never held the submitting context."""
        if not self.enabled:
            return
        trace_id = (parent.trace_id if parent is not None
                    else self._root_trace or _new_id("t"))
        span_id = self._next_span_id()
        ts = time.time()
        self._journal_emit("span.open", trace=trace_id, span=span_id,
                           parent=parent.span_id if parent else None,
                           name=name, attrs=dict(attrs or {}), ts=ts - dur_s)
        self._journal_emit("span.close", trace=trace_id, span=span_id,
                           name=name, dur_ms=round(dur_s * 1e3, 3),
                           status=status, attrs=dict(attrs or {}), ts=ts)

    def _next_span_id(self) -> str:
        """Run-unique span id: the writer prefix (``p<k>[-<suffix>].``,
        empty for a plain journal) plus the process-local sequence — two
        shards of one run never collide on a span id in the merged
        view."""
        return f"{self._span_prefix}s{next(self._seq)}"

    # -- journal shorthands --------------------------------------------------
    def _journal_emit(self, ev: str, **fields) -> None:
        # every journaled event also lands in the always-on flight ring (a dead process's last moments survive the journal's
        # file buffer); copied because the labels/ts mutation below would
        # otherwise alias the ring's stored record
        _blackbox.ring_record(ev, dict(fields))
        if self.journal is not None:
            ts = fields.pop("ts", None)
            if ts is not None:
                # retroactive events carry their own timestamp
                fields["at"] = round(ts, 6)
            labels = _LABELS.get()
            if labels:
                # ambient labels (tenant attribution) ride every record;
                # an explicit field of the same name wins
                for key, value in labels.items():
                    fields.setdefault(key, value)
            self.journal.emit(ev, **fields)

    def event(self, ev: str, **fields) -> None:
        """Journal a free event stamped with the current span's identity
        (if any) — checkpoint saves, canary readings, stage skips."""
        if not self.enabled:
            # the flight ring records this seam even with tracing off (the kwargs dict is fresh per call — safe to
            # keep without a copy); the journal still sees nothing
            _blackbox.ring_record(ev, fields)
            return
        cur = _CURRENT.get()
        if cur is not None:
            fields.setdefault("trace", cur.trace_id)
            fields.setdefault("span", cur.span_id)
        self._journal_emit(ev, **fields)

    def event_once(self, ev: str, key, **fields) -> None:
        """Journal an event at most once per journal per ``(ev, key)`` —
        for run-identity facts (e.g. ``shard.topology``) that several
        seams may announce; later duplicates are dropped, and a run
        carrying genuinely distinct facts (different keys) journals each."""
        if not self.enabled:
            _blackbox.ring_record(ev, fields)   # ring only; no once-latch
            return
        with self._lock:
            if (ev, key) in self._once:
                return
            self._once.add((ev, key))
        self.event(ev, **fields)

    def counters(self, scope: str, counters) -> None:
        """Journal a named counter snapshot (the CLI renders per-scope
        deltas between successive snapshots)."""
        if not self.enabled:
            return
        self.event("counters", scope=scope, groups=counters.as_dict())

    def gauge(self, name: str, value: float) -> None:
        """Journal a point-in-time gauge reading (queue depths)."""
        if not self.enabled:
            _blackbox.ring_record("gauge", {"name": name, "value": value})
            return
        self.event("gauge", name=name, value=value)


_TRACER = Tracer()


def tracer() -> Tracer:
    """The process tracer (disabled, hence free, until configured)."""
    return _TRACER


def fleet_run_id(conf) -> str:
    """The run identity every journal shard of one run carries: ``trace.run.id`` when set, else a fingerprint of the conf's
    workload properties.  Observability knobs (``trace.*``, ``profile.*``,
    ``slo.*`` — including the per-replica ``trace.writer.suffix``) are
    EXCLUDED: two replicas differing only in their writer suffix, or a
    relaunch that turns profiling on, must land in the same run's shard
    set.  Distinct from ``StreamCheckpointer.run_id_from_conf`` (which
    keeps these keys — a checkpoint's identity is stricter than a
    journal's)."""
    explicit = conf.get("trace.run.id")
    if explicit:
        return explicit
    import hashlib

    drop = ("trace.", "profile.", "slo.", "telemetry.")
    stable = sorted(
        (k, v) for k, v in conf.props.items()
        if not any((k[len(conf.prefix) + 1:] if k.startswith(
            conf.prefix + ".") else k).startswith(p) for p in drop))
    return hashlib.blake2s(repr(stable).encode(),
                           digest_size=6).hexdigest()


def configure(conf) -> Tracer:
    """Enable the process tracer from ``trace.*`` config keys; a no-op —
    and one dict lookup — when ``trace.on`` is unset.

    A writer suffix (``trace.writer.suffix``, else ``tenant.id``) or a
    ``trace.run.id`` makes the journal a shard of a run whose id is
    :func:`fleet_run_id`, so ``telemetry merge`` renders several writers
    as one trace.  Idempotent: a pipeline and the jobs it runs all call
    this with the same conf; the first enable wins.

    ``profile.on`` (the program registry) and ``blackbox.*`` (bundles,
    the watchdog) are configured here too, independently of ``trace.on``
    (a few dict lookups when unset)."""
    from avenir_tpu_torch.telemetry import profile as _profile

    _profile.configure(conf)
    _blackbox.configure(conf)
    t = _TRACER
    if not conf.get_bool("trace.on", False) or t.enabled:
        return t
    # a tenant-dedicated process (tenant.id) shards its journal like a
    # replica — the tenant names the writer suffix when no explicit one
    # is set — and stamps every record with the tenant
    tenant = conf.get("tenant.id", "") or ""
    suffix = conf.get("trace.writer.suffix", "") or tenant
    # one process (multi-process runs are ROADMAP.md, Queue 1 item 7h):
    # a shard only when a suffix or an explicit run id asks for one
    fleet = bool(suffix) or bool(conf.get("trace.run.id"))
    max_mb = conf.get_float("telemetry.journal.max.mb", 64.0)
    t.enable(conf.get("trace.journal.dir") or ".",
             max_bytes=int(max_mb * (1 << 20)),
             run_id=fleet_run_id(conf) if fleet else None,
             suffix=suffix, tenant=tenant)
    return t


class CompileKeyMonitor:
    """The compile-key diff of a dispatch loop: a measured ``recompiles``
    counter instead of an assumption of shape stability.

    ``prime`` registers expected keys (a stream's first chunk) without
    counting; ``observe`` counts any key outside the known
    set as a recompile, increments ``<group>::recompiles`` and journals a
    ``recompile`` event carrying the fresh keys.  With ``auto_prime`` the
    first observation primes instead of counting — the batch-stream mode,
    where the first chunk's compile is the expected one and only
    *subsequent* fresh shapes (e.g. a ragged tail chunk) are noteworthy.

    Every key that enters the known set — primed or observed — is also
    registered with the
    :class:`~avenir_tpu_torch.telemetry.profile.CompiledProgramRegistry`
    under this monitor's scope: one ``program.compiled`` event per
    distinct key (a ragged tail chunk is one recompile and one extra
    program)."""

    def __init__(self, counters=None, group: str = "Telemetry",
                 scope: str = "", auto_prime: bool = False):
        self.counters = counters
        self.group = group
        self.scope = scope
        self.auto_prime = auto_prime
        self._known: set = set()
        self._primed = False

    def prime(self, keys: Iterable) -> None:
        keys = set(keys)
        self._known |= keys
        self._primed = True
        self._register_programs(keys)

    def _register_programs(self, keys) -> None:
        """Feed keys entering the known set to the program registry (one
        attribute check when profiling is off)."""
        from avenir_tpu_torch.telemetry import profile as _profile

        prof = _profile.profiler()
        if prof.enabled:
            for key in keys:
                prof.observe(key, site=self.scope or self.group)

    @staticmethod
    def shape_key(*arrays) -> tuple:
        """A dispatch-shape key for numpy or torch operands: (shape,
        dtype) per operand, the dtype by numpy's name (``int32``, not
        ``torch.int32``), so a key — and the program id derived from it —
        equals the JAX package's for the same shapes."""
        return tuple((tuple(a.shape), str(a.dtype).replace("torch.", ""))
                     for a in arrays if a is not None)

    def observe(self, keys: Iterable) -> int:
        """Fold ``keys`` into the known set; returns (and accounts) how
        many were fresh."""
        fresh = set(keys) - self._known
        if not fresh:
            return 0
        self._known |= fresh
        self._register_programs(fresh)
        if self.auto_prime and not self._primed:
            self._primed = True
            return 0
        if self.counters is not None:
            self.counters.increment(self.group, "recompiles", len(fresh))
        _TRACER.event("recompile", scope=self.scope,
                      keys=sorted(repr(k) for k in fresh))
        return len(fresh)
