"""Bucketed microbatcher — port of ``avenir_tpu/serving/batcher.py``, the
scoring plane's shape-discipline core.

Concurrent requests for one model are folded into padded power-of-two
batch buckets (``serve.bucket.sizes``), every (model, bucket) shape runs
once at startup (``serve.warmup.on.start``), and each entry's
``compile_keys`` is diffed after every batch into a ``recompiles``
counter, so "no new shape after warmup" is measured, not assumed.

Latency and throughput policy:

- a batch dispatches as soon as a full ``max(bucket)`` is waiting, or when
  the oldest pending request ages past ``serve.flush.deadline.ms``;
- each model's pending queue is bounded by ``serve.queue.depth``; a submit
  against a full queue is rejected with a typed :class:`ShedError`;
- a request that ages past ``serve.request.timeout.ms`` before a batch
  picks it up fails with :class:`RequestTimeout`.

One dispatcher thread owns every device call of a batcher; ``submit`` may
be called from any number of frontend threads.  The servables hold their
parameters on their own device (``cuda`` unless the CPU was asked for), so
the dispatcher needs no device context; replicas of a
:class:`~avenir_tpu_torch.serving.pool.ReplicaPool` all dispatch to the
one card.

A batcher is one replica of a pool: ``name`` labels its spans, errors and
journal events; ``counters`` / ``latency`` may be shared across the pool;
the dispatcher keeps a ``heartbeat`` the pool's deadline detection reads
(:meth:`stalled`); and a conf-armed
:class:`~avenir_tpu_torch.utils.retry.FaultPlan` can kill it through two
sites — ``serve.dispatch`` (dies mid-batch: every unfinished request
fails with the retryable :class:`ReplicaDownError`) and
``serve.heartbeat`` (the dispatcher wedges silently until the pool's
heartbeat deadline reaps its queue).

``tenant.id`` names the tenant the plane belongs to: the dispatcher
journals under it, a door shed names it and carries the queue's drain
estimate, and each batch dispatch draws a slot of the tenancy arbiter
(``tenancy.pool().slot``) under the tenant's ``tenant.<id>.*`` contract,
bounded by the request timeout and ticking the heartbeat while it waits,
so a paced replica never reads as a wedged one.  Un-tenanted batchers
pass through the arbiter's shared null context.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

from avenir_tpu_torch import tenancy
from avenir_tpu_torch.core.config import ConfigError, JobConfig
from avenir_tpu_torch.serving.errors import (
    ReplicaDownError,
    RequestError,
    RequestTimeout,
    ServingError,
    ShedError,
    TenantShedError,
)
from avenir_tpu_torch.serving.registry import ModelRegistry
from avenir_tpu_torch.telemetry import blackbox
from avenir_tpu_torch.telemetry import profile as prof_mod
from avenir_tpu_torch.telemetry import spans as tel
from avenir_tpu_torch.tenancy.arbiter import (RETRY_AFTER_MAX_S,
                                              RETRY_AFTER_MIN_S)
from avenir_tpu_torch.utils.metrics import (Counters, LatencyTracker,
                                            serving_stats)
from avenir_tpu_torch.utils.retry import FaultPlan, InjectedFault


class PendingRequest:
    """One in-flight request; ``wait`` blocks until scored (or failed).

    ``trace_ctx`` captures the submitter's span (None with tracing off):
    the dispatch thread can't see the submitting context, so the request's
    span is emitted retroactively with this parent — how a serving request
    joins the pipeline trace through the ScoringPlane stage.

    ``rid``: an optional caller-assigned request id carried
    into the ``serve.request`` span, so a pool's failover dedupe — "this
    request scored exactly once, on exactly one replica" — is assertable
    from the journal.  ``probe`` marks a breaker half-open liveness probe:
    the dispatcher answers it without scoring (and without counters).

    ``tenant``: captured from the submitter's ambient labels, because the
    ``serve.request`` span is emitted by the dispatcher thread, whose own
    context never saw the tenant."""

    __slots__ = ("model", "line", "enqueued", "result", "error", "_done",
                 "trace_ctx", "rid", "probe", "tenant")

    def __init__(self, model: str, line: str, rid: Optional[str] = None,
                 probe: bool = False, tenant: Optional[str] = None):
        self.model = model
        self.line = line
        self.enqueued = time.monotonic()
        self.result: Optional[str] = None
        self.error: Optional[ServingError] = None
        self._done = threading.Event()
        self.trace_ctx = tel.tracer().current()
        self.rid = rid
        self.probe = probe
        self.tenant = tenant if tenant is not None \
            else tel.current_label("tenant")

    def finish(self, result: Optional[str] = None,
               error: Optional[ServingError] = None) -> None:
        # idempotent: a request that already scored must NEVER be
        # re-finished with a replica-death error (the at-most-once pillar
        # of pool failover — a done request is done)
        if self._done.is_set():
            return
        self.result = result
        self.error = error
        self._done.set()

    def wait(self, timeout_s: Optional[float] = None) -> str:
        if not self._done.wait(timeout_s):
            raise RequestTimeout(
                f"no response for {self.model!r} request within "
                f"{timeout_s}s (dispatcher wedged or closed?)")
        if self.error is not None:
            raise self.error
        return self.result  # type: ignore[return-value]


class BucketedMicrobatcher:
    def __init__(self, registry: ModelRegistry,
                 bucket_sizes: Sequence[int] = (1, 2, 4, 8, 16, 32, 64),
                 flush_deadline_ms: float = 5.0,
                 queue_depth: int = 1024,
                 request_timeout_ms: float = 1000.0,
                 warmup: bool = True,
                 counters: Optional[Counters] = None,
                 latency: Optional[Dict[str, LatencyTracker]] = None,
                 name: str = "",
                 tenant: str = "",
                 fault: Optional[FaultPlan] = None,
                 on_batch_ok: Optional[Callable[[], None]] = None,
                 on_batch_error: Optional[Callable[[BaseException],
                                                   None]] = None):
        self.registry = registry
        self.buckets = sorted({int(b) for b in bucket_sizes})
        if not self.buckets or self.buckets[0] < 1:
            raise ConfigError(f"invalid serve.bucket.sizes {bucket_sizes!r}")
        self.max_bucket = self.buckets[-1]
        self.flush_deadline_s = float(flush_deadline_ms) / 1e3
        self.queue_depth = max(int(queue_depth), 1)
        self.request_timeout_s = float(request_timeout_ms) / 1e3
        self.counters = counters if counters is not None else Counters()
        # ``latency`` may be a pool-shared dict: every replica
        # records into the same per-model trackers, so the pool's /metrics
        # and SLO evaluation aggregate without a merge step
        self.latency: Dict[str, LatencyTracker] = (
            latency if latency is not None else {})
        for model in registry.names():
            self.latency.setdefault(model, LatencyTracker())
        # replica identity and failure machinery: ``name`` labels
        # spans/errors/events; ``fault`` is the conf-armed kill schedule
        # (shared across a pool so site counts are pool-wide);
        # ``heartbeat`` is the dispatcher's liveness signal, updated every
        # loop wake and read by the pool's deadline checks
        self.name = name
        # the tenant this plane belongs to (``tenant.id``): the dispatcher
        # journals under it, each batch dispatch draws an arbitrated slot
        # under the tenant's contract, and a door shed names it and
        # carries the queue drain estimate the HTTP frontend renders as
        # Retry-After
        self.tenant = tenant
        self.fault = fault
        self.on_batch_ok = on_batch_ok
        self.on_batch_error = on_batch_error
        self.heartbeat = time.monotonic()
        self.failed = False
        self._dispatching = False
        # per-model EWMA of batch dispatch seconds: the queue drain
        # estimate behind a shed's Retry-After
        self._dispatch_ewma: Dict[str, float] = {}
        self._queues: Dict[str, Deque[PendingRequest]] = {
            name: deque() for name in registry.names()}
        # recompile accounting: warmup primes each monitor, any fresh key
        # afterwards counts under Serving.<name>::recompiles
        self._monitors: Dict[str, tel.CompileKeyMonitor] = {
            name: tel.CompileKeyMonitor(self.counters,
                                        group=f"Serving.{name}", scope=name)
            for name in registry.names()}
        self._cond = threading.Condition()
        self._stop = False
        # requests popped from their queues but not yet scored: with the
        # queues, the in-flight table a forensics bundle snapshots
        self._active: List[PendingRequest] = []
        self._bb_name = f"batcher-{name}" if name else \
            f"batcher-{id(self):x}"
        blackbox.register_provider(self._bb_name, self._blackbox_inflight,
                                   kind="inflight")
        # readiness, the /healthz probe's contract: False until warm()
        # completes; a deployment that disables serve.warmup.on.start
        # stays not ready until it calls warm() itself (scoring is never
        # gated, only the readiness signal)
        self.ready = False
        if warmup:
            self.warm()
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"serve-dispatch-{name}" if name else "serve-dispatch")
        self._thread.start()

    @classmethod
    def from_conf(cls, registry: ModelRegistry, conf: JobConfig,
                  **kwargs) -> "BucketedMicrobatcher":
        """``kwargs`` passes through the pool's wiring (``name``, shared
        ``counters``/``latency``, the dispatch callbacks).  A ``fault``
        plan not supplied by the caller is armed from the conf's own
        ``fault.*`` keys."""
        if "fault" not in kwargs:
            kwargs["fault"] = FaultPlan.from_conf(conf)
        if "tenant" not in kwargs:
            kwargs["tenant"] = conf.get("tenant.id", "") or ""
        return cls(
            registry,
            bucket_sizes=conf.get_int_list("serve.bucket.sizes",
                                           [1, 2, 4, 8, 16, 32, 64]),
            flush_deadline_ms=conf.get_float("serve.flush.deadline.ms", 5.0),
            queue_depth=conf.get_int("serve.queue.depth", 1024),
            request_timeout_ms=conf.get_float("serve.request.timeout.ms",
                                              1000.0),
            warmup=conf.get_bool("serve.warmup.on.start", True),
            **kwargs,
        )

    # -- warmup / recompile accounting ---------------------------------------
    def warm(self) -> Dict[str, int]:
        """Run every (model, bucket) shape once; shapes seen here never
        count as recompiles later.  Completing marks the batcher ready (the
        /healthz readiness contract)."""
        warmed = self.registry.warmup(self.buckets)
        for name, entry in self.registry.items():
            self._monitors[name].prime(entry.compile_keys)
        self.ready = True
        return warmed

    # -- hot swap (any thread) -----------------------------------------------
    def swap(self, model: str, entry, warm: bool = True) -> int:
        """Zero-downtime model hot-swap with the warmup barrier.

        Warms the incoming entry's bucket shapes and primes its recompile
        monitor before publishing it to the registry, so the
        zero-recompiles invariant holds across a swap.  In-flight batches
        hold the old entry they resolved and finish on the old
        parameters; every later batch resolves the new entry.  The warmup
        runs on the caller's thread, beside live dispatches.
        ``warm=False`` skips the barrier: the first post-swap batch of a
        new shape is then counted.  Returns the model's new version."""
        self.registry.get(model)          # raises UnknownModelError early
        if warm:
            for bucket in self.buckets:
                entry.warmup(int(bucket))
            self._monitors[model].prime(entry.compile_keys)
        version = self.registry.swap(model, entry)
        self.counters.increment(f"Serving.{model}", "swaps")
        tel.tracer().event("model.swap", model=model, version=version,
                           family=entry.family, warmed=bool(warm))
        # swap boundary: a leak of the outgoing entry's device buffers
        # across repeated swaps shows up in this gauge
        prof_mod.profiler().sample_device_memory("swap")
        return version

    # -- submission (any thread) ---------------------------------------------
    def submit_nowait(self, model: str, line: str,
                      rid: Optional[str] = None) -> PendingRequest:
        entry = self.registry.get(model)            # raises UnknownModelError
        del entry
        req = PendingRequest(model, line, rid=rid)
        shed_depth = None
        with self._cond:
            if self.failed:
                raise self._down_error("replica is down")
            if self._stop:
                raise ServingError("batcher is closed")
            queue = self._queues[model]
            if len(queue) >= self.queue_depth:
                self.counters.increment(f"Serving.{model}", "shed")
                if self.tenant:
                    self.counters.increment(f"Tenant.{self.tenant}", "shed")
                shed_depth = len(queue)
            else:
                queue.append(req)
                depth = len(queue)
                self._cond.notify()
        if shed_depth is None:
            # the submit door records to the flight ring (trace.on or not,
            # outside the lock): a killed replica's bundle shows which
            # rids were in flight
            blackbox.ring_record("serve.submit",
                                 {"rid": req.rid, "model": model,
                                  "tenant": req.tenant, "depth": depth})
        if shed_depth is not None:
            if self.tenant:
                # tenant-scoped door shed: journaled as tenant.shed and
                # raised outside the lock, carrying the queue drain
                # estimate (Retry-After) and the quota that fired
                retry_after = self.drain_estimate_s(model)
                tel.tracer().event(
                    "tenant.shed", tenant=self.tenant,
                    quota="serve.queue.depth",
                    waiting=shed_depth, inflight=0,
                    retry_after_ms=round(retry_after * 1e3, 1))
                raise self._attribute(TenantShedError(
                    f"{model!r} queue at depth {self.queue_depth} for "
                    f"tenant {self.tenant!r} — request shed "
                    f"(backpressure); retry after ~{retry_after:.2f}s",
                    tenant=self.tenant, quota="serve.queue.depth",
                    retry_after_s=retry_after), wait_s=0.0)
            raise self._attribute(ShedError(
                f"{model!r} queue at depth {self.queue_depth}"
                + (f" on replica {self.name!r}" if self.name else "")
                + " — request shed (backpressure)"), wait_s=0.0)
        return req

    def submit(self, model: str, line: str,
               timeout_s: Optional[float] = None) -> str:
        """Blocking submit: returns the response line or raises the typed
        error.  Default wait bound covers the request timeout plus dispatch
        slack so a wedged dispatcher surfaces as RequestTimeout, not a hang."""
        if timeout_s is None:
            timeout_s = self.request_timeout_s + 30.0
        return self.submit_nowait(model, line).wait(timeout_s)

    # -- dispatch loop (one thread) ------------------------------------------
    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.max_bucket

    def _ready(self, now: float) -> List[str]:
        out = []
        for name, queue in self._queues.items():
            if not queue:
                continue
            if (len(queue) >= self.max_bucket
                    or now - queue[0].enqueued >= self.flush_deadline_s):
                out.append(name)
        return out

    def _next_wait(self, now: float) -> float:
        deadlines = [queue[0].enqueued + self.flush_deadline_s - now
                     for queue in self._queues.values() if queue]
        if not deadlines:
            # idle: sleep until a submit notifies, waking at least once a
            # second (every wait here has a deadline)
            return 1.0
        return max(min(deadlines), 0.0)

    def _loop(self) -> None:
        with contextlib.ExitStack() as stack:
            if self.tenant:
                # every span, gauge and recompile event the dispatcher
                # journals carries the tenant label
                stack.enter_context(tel.label_scope(tenant=self.tenant))
            while True:
                with self._cond:
                    self.heartbeat = time.monotonic()
                    if self.fault is not None:
                        try:
                            self.fault.hit("serve.heartbeat")
                        except InjectedFault:
                            # the wedged-dispatcher drill: exit WITHOUT
                            # finishing pending work — the heartbeat goes
                            # stale and the pool's deadline detection is
                            # what has to reap the stranded queue
                            return
                    while not self._stop and \
                            not self._ready(time.monotonic()):
                        self._cond.wait(
                            timeout=self._next_wait(time.monotonic()))
                        self.heartbeat = time.monotonic()
                    if self._stop and not any(self._queues.values()):
                        return
                    ready = ([name for name, q in self._queues.items() if q]
                             if self._stop
                             else self._ready(time.monotonic()))
                    batches: List[Tuple[str, List[PendingRequest]]] = []
                    for name in ready:
                        queue = self._queues[name]
                        take = min(len(queue), self.max_bucket)
                        batches.append((name,
                                        [queue.popleft()
                                         for _ in range(take)]))
                    self._active = [r for _, rs in batches for r in rs]
                    self._dispatching = True
                try:
                    for i, (name, reqs) in enumerate(batches):
                        # refreshed PER BATCH (lock-free: a float store
                        # is atomic under the GIL, and the monitor only
                        # compares staleness) so a dispatcher working
                        # through several slow batches reads as busy,
                        # not wedged — only true silence past the
                        # deadline is a miss
                        self.heartbeat = time.monotonic()
                        try:
                            # a dispatch that wedges trips the progress
                            # watchdog and captures a forensics bundle
                            with blackbox.watchdog_guard("serve.dispatch"):
                                self._dispatch(name, reqs)
                        except Exception:  # noqa: BLE001
                            # replica-fatal, injected (serve.dispatch
                            # kill) or real: every unfinished request
                            # (this batch + everything queued) fails
                            # RETRYABLE so the pool can re-enqueue it on
                            # a survivor — waiting for the heartbeat
                            # deadline to reap a silently-dead loop
                            # would stall them for seconds instead
                            self._die([r for _, rs in batches[i:]
                                       for r in rs])
                            return
                finally:
                    with self._cond:
                        self._dispatching = False
                        self._active = []
                        self.heartbeat = time.monotonic()

    def _dispatch(self, model: str, reqs: List[PendingRequest]) -> None:
        scorable = [r for r in reqs if not r.probe]
        for req in reqs:
            if req.probe:
                # breaker half-open liveness probe: answered by the
                # dispatcher without scoring (and without counters) — it
                # proves THIS thread is alive and draining its queue
                req.finish(result="pong")
        if not scorable:
            return
        if self.fault is not None:
            # the replica-kill site: fires BEFORE any request of the
            # batch scores (InjectedFault propagates to _loop → _die),
            # so an injected death can never double-score a request
            self.fault.hit("serve.dispatch")
        group = f"Serving.{model}"
        now = time.monotonic()
        live: List[PendingRequest] = []
        for req in scorable:
            if now - req.enqueued > self.request_timeout_s:
                self.counters.increment(group, "timeouts")
                req.finish(error=self._attribute(RequestTimeout(
                    f"request waited past "
                    f"{self.request_timeout_s * 1e3:.0f} ms before dispatch"
                    + (f" on replica {self.name!r}" if self.name else "")),
                    wait_s=now - req.enqueued))
            else:
                live.append(req)
        if not live:
            return
        entry = self.registry.get(model)
        bucket = self._bucket_for(len(live))
        try:
            # the batch draws an arbitrated device slot under this plane's
            # tenant contract before it scores: serve dispatches and
            # batch/stream chunk folds share ONE fair-queued pool.  The
            # wait is bounded by the request timeout (a tenant paced past
            # it sheds typed rather than stranding requests) and ticks the
            # heartbeat while queued: being paced is not being wedged
            with tenancy.pool().slot(tenant=self.tenant or None,
                                     timeout_s=self.request_timeout_s,
                                     on_wait=self._beat):
                t0 = time.monotonic()
                outs = entry.score_lines([r.line for r in live], bucket)
                dispatch_s = time.monotonic() - t0
        except TenantShedError as exc:
            # the tenant's pool share refused this batch before any row
            # scored: fail the whole batch typed — tenant-scoped, so the
            # other tenants' planes keep dispatching
            self.counters.increment(group, "shed", len(live))
            self._attribute(exc)
            for req in live:
                req.finish(error=exc)
            return
        except Exception as exc:
            # typed ServingErrors are REQUEST faults (bad rows); anything
            # else is an infrastructure fault the pool's breaker counts
            if self.on_batch_error is not None and \
                    not isinstance(exc, ServingError):
                self.on_batch_error(exc)
            # one bad row must not poison its coalesced batch neighbors:
            # re-score each request alone (smallest bucket — warmed, so no
            # recompile) so only the genuinely bad ones fail typed
            if len(live) > 1:
                self._dispatch_isolated(entry, group, live)
                return
            self.counters.increment(group, "errors")
            err = (exc if isinstance(exc, ServingError)
                   else RequestError(f"{type(exc).__name__}: {exc}"))
            live[0].finish(error=self._attribute(
                err, wait_s=time.monotonic() - live[0].enqueued))
            return
        prev = self._dispatch_ewma.get(model)
        self._dispatch_ewma[model] = (
            dispatch_s if prev is None else 0.8 * prev + 0.2 * dispatch_s)
        if self.on_batch_ok is not None:
            self.on_batch_ok()
        self._finish_scored(entry, group, model, live, outs, bucket,
                            dispatch_s)

    def _dispatch_isolated(self, entry, group: str,
                           reqs: List[PendingRequest]) -> None:
        """Failure-isolation path: score each request of a failed batch
        alone; good rows still succeed, bad rows carry their own error."""
        model = reqs[0].model
        bucket = self._bucket_for(1)
        for req in reqs:
            try:
                with tenancy.pool().slot(tenant=self.tenant or None,
                                         timeout_s=self.request_timeout_s,
                                         on_wait=self._beat):
                    outs = entry.score_lines([req.line], bucket)
            except TenantShedError as exc:
                self.counters.increment(group, "shed")
                req.finish(error=self._attribute(exc))
                continue
            except Exception as exc:
                if self.on_batch_error is not None and \
                        not isinstance(exc, ServingError):
                    self.on_batch_error(exc)
                self.counters.increment(group, "errors")
                err = (exc if isinstance(exc, ServingError)
                       else RequestError(f"{type(exc).__name__}: {exc}"))
                req.finish(error=self._attribute(
                    err, wait_s=time.monotonic() - req.enqueued))
                continue
            if self.on_batch_ok is not None:
                self.on_batch_ok()
            self._finish_scored(entry, group, model, [req], outs, bucket)

    def _finish_scored(self, entry, group: str, model: str,
                       live: List[PendingRequest], outs: List[str],
                       bucket: int,
                       dispatch_s: Optional[float] = None) -> None:
        # a shape outside the warmed set is the invariant violation the
        # counter exposes (the monitor also registers each key as a
        # profiler program under site=<model>)
        self._monitors[model].observe(entry.compile_keys)
        done = time.monotonic()
        tracer = tel.tracer()
        prof = prof_mod.profiler()
        pid = None
        if prof.enabled:
            # the program this batch dispatched: the entry's compile key
            # for this bucket (every entry keys on (bucket, ...))
            pkey = next((k for k in entry.compile_keys
                         if k and k[0] == bucket), (bucket,))
            pid = prof_mod.program_id(model, pkey)
            if dispatch_s is not None:
                prof.sample(pkey, model, dispatch_s)
        tracker = self.latency[model]
        for req, out in zip(live, outs):
            req.finish(result=out)
            wait_s = done - req.enqueued
            tracker.record(wait_s)
            if tracer.enabled:
                # which replica scored this request and how long it sat
                # queued
                attrs = {"model": model, "bucket": bucket,
                         "wait_ms": round(wait_s * 1e3, 3)}
                if self.name:
                    attrs["replica"] = self.name
                if req.rid is not None:
                    attrs["rid"] = req.rid
                if req.tenant:
                    attrs["tenant"] = req.tenant
                if pid is not None:
                    attrs["program"] = pid
                tracer.emit_span("serve.request", wait_s,
                                 parent=req.trace_ctx, attrs=attrs)
        self.counters.increment(group, "requests", len(live))
        self.counters.increment(group, "batches")
        self.counters.increment(group, f"bucket.{bucket}")
        if tracer.enabled:
            tracer.gauge(f"serve.queue.{model}", len(self._queues[model]))

    def _beat(self) -> None:
        """Heartbeat tick while queued on the tenancy arbiter (a float
        store is atomic under the GIL, the contract of the per-batch
        refresh in ``_loop``): a paced dispatcher reads as busy, never as
        wedged, so only true silence past the deadline is a miss."""
        self.heartbeat = time.monotonic()

    # -- replica failure machinery --------------------------------------------
    def _attribute(self, err: ServingError,
                   wait_s: Optional[float] = None) -> ServingError:
        """Stamp a typed error with this replica's identity, its tenant
        and the request's queue wait, so client-visible failures triage
        to the replica (and owner) that caused them without the journal."""
        err.replica = self.name or None
        if self.tenant and getattr(err, "tenant", None) in (None, ""):
            err.tenant = self.tenant
        if wait_s is not None:
            err.queue_wait_ms = round(wait_s * 1e3, 3)
        return err

    def drain_estimate_s(self, model: str) -> float:
        """How long this model's pending queue needs to drain: queued
        batches × (EWMA batch dispatch + the flush deadline) — the
        ``Retry-After`` a tenant-scoped shed carries, clamped as the
        arbiter clamps it; no dispatch observed yet reads as a nominal
        50 ms batch."""
        depth = len(self._queues[model])
        batches = max((depth + self.max_bucket - 1) // self.max_bucket, 1)
        est = batches * (self._dispatch_ewma.get(model, 0.05)
                         + self.flush_deadline_s)
        return min(max(est, RETRY_AFTER_MIN_S), RETRY_AFTER_MAX_S)

    def _down_error(self, reason: str,
                    req: Optional[PendingRequest] = None) -> ReplicaDownError:
        err = ReplicaDownError(
            (f"replica {self.name!r}: " if self.name else "") + reason)
        return self._attribute(
            err, wait_s=(time.monotonic() - req.enqueued)
            if req is not None else None)

    def _die(self, stranded: List[PendingRequest]) -> None:
        """serve.dispatch kill: mark the replica failed (new submissions
        are refused at the door) and fail every unfinished request —
        ``stranded`` (popped but unscored) plus everything still queued —
        with the RETRYABLE :class:`ReplicaDownError`, the pool's cue to
        re-enqueue them on survivors.  ``finish`` is idempotent, so a
        request that already scored can never be re-failed here."""
        with self._cond:
            self.failed = True
            queued = [r for q in self._queues.values() for r in q]
            for q in self._queues.values():
                q.clear()
            self._cond.notify_all()
        for req in stranded + queued:
            req.finish(error=self._down_error("died mid-batch", req))

    def mark_failed(self) -> None:
        """Pool-side declaration that this replica is dead (missed
        heartbeat deadline): refuse new submissions from now on."""
        with self._cond:
            self.failed = True
            self._cond.notify_all()

    def fail_pending(self, reason: str = "replica down") -> int:
        """Fail every QUEUED request with :class:`ReplicaDownError` (the
        pool reaps a wedged replica's stranded queue with this); returns
        how many requests were failed over."""
        with self._cond:
            reqs = [r for q in self._queues.values() for r in q]
            for q in self._queues.values():
                q.clear()
        for req in reqs:
            req.finish(error=self._down_error(reason, req))
        return len(reqs)

    def stalled(self, deadline_s: float) -> bool:
        """True when the dispatcher has WORK but its heartbeat is older
        than ``deadline_s`` — a wedged (or silently dead) dispatcher.
        An idle batcher is never stalled: with nothing to dispatch a
        stale heartbeat is just sleep."""
        with self._cond:
            busy = self._dispatching or any(self._queues.values())
            return busy and \
                (time.monotonic() - self.heartbeat) > float(deadline_s)

    def probe(self, timeout_s: float = 5.0) -> bool:
        """Breaker half-open liveness probe: push a no-op request through
        the REAL dispatch queue and wait for the dispatcher to answer it.
        True = the dispatch thread is alive and draining (the breaker may
        close); False = dead, wedged, or closed (stay open)."""
        if self.failed or not self._thread.is_alive():
            return False
        model = next(iter(self._queues), None)
        if model is None:
            return False
        req = PendingRequest(model, "", rid="probe", probe=True)
        with self._cond:
            if self._stop or self.failed:
                return False
            self._queues[model].append(req)
            self._cond.notify()
        try:
            req.wait(timeout_s)
            return True
        except ServingError:
            return False

    def health(self) -> Dict[str, object]:
        """The ``/healthz`` body: readiness (warmed and not failed),
        loaded models, per-model queue depth vs cap, and each model's
        registry version — what a prober needs to see backpressure and
        rollout state at a glance."""
        ready = bool(self.ready) and not self.failed
        return {
            "status": "ok" if ready else "unavailable",
            "ready": ready,
            "models": self.registry.names(),
            "buckets": self.buckets,
            "queue": {name: {"depth": depth, "cap": self.queue_depth}
                      for name, depth in self.queue_depths().items()},
            "versions": {name: self.registry.version(name)
                         for name in self.registry.names()},
        }

    # -- observability / shutdown --------------------------------------------
    def stats(self, identity: Optional[Dict[str, str]] = None
              ) -> Dict[str, dict]:
        """Per-model serving stats; ``identity`` (process/replica — the
        frontend's scrape identity) rides into every row so N workers'
        stats stay distinguishable after fleet aggregation."""
        return serving_stats(self.counters, self.latency, identity=identity)

    def queue_depths(self) -> Dict[str, int]:
        """Per-model pending-queue depth — the ``/metrics`` gauges."""
        with self._cond:
            return {name: len(q) for name, q in self._queues.items()}

    def _blackbox_inflight(self) -> List[Dict[str, object]]:
        """The forensics bundle's in-flight table: every request this
        replica holds — popped-but-unscored first, then queued — with
        rid, tenant and queue age (capped: a flooded replica's bundle
        stays readable)."""
        now = time.monotonic()

        def row(req: PendingRequest, state: str) -> Dict[str, object]:
            return {"rid": req.rid, "model": req.model,
                    "tenant": req.tenant, "state": state,
                    "age_ms": round((now - req.enqueued) * 1e3, 1)}

        with self._cond:
            rows = [row(r, "dispatching") for r in self._active]
            for q in self._queues.values():
                rows.extend(row(r, "queued") for r in q)
        return rows[:512]

    def close(self) -> None:
        """Flush every pending request, then stop the dispatcher.  A
        dead/wedged dispatcher cannot flush — its leftovers fail typed
        (:class:`ReplicaDownError`) instead of hanging their callers."""
        with self._cond:
            if self._stop:
                return
            self._stop = True
            self._cond.notify_all()
        self._thread.join(timeout=60.0)
        if self.fail_pending("batcher closed with a dead dispatcher"):
            self.failed = True
        blackbox.unregister_provider(self._bb_name)

    def __enter__(self) -> "BucketedMicrobatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
