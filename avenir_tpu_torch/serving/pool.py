"""The fault-tolerant replica pool behind one frontend — port of
``avenir_tpu/serving/pool.py``.

:class:`ReplicaPool` runs N :class:`~avenir_tpu_torch.serving.batcher.BucketedMicrobatcher`
replicas behind one routing door:

- **health-gated routing** — requests go to the least-queue-depth replica
  whose readiness is green (warmed, not failed, breaker closed);
- **per-replica circuit breaker** — ``pool.breaker.failures`` consecutive
  infrastructure dispatch errors (typed request faults never count) or a
  missed ``pool.heartbeat.ms`` deadline open the breaker; after
  ``pool.breaker.halfopen.ms`` it half-opens and a liveness probe through
  the replica's real dispatch queue decides closed or open;
- **failover** — a replica dying mid-batch fails its unfinished requests
  with the retryable :class:`~avenir_tpu_torch.serving.errors.ReplicaDownError`
  and the pool re-enqueues each on a survivor, at most
  ``pool.failover.retries`` times per request, else a typed
  :class:`~avenir_tpu_torch.serving.errors.ShedError` — never silent loss
  and never a double score (``PendingRequest.finish`` is idempotent);
- **rolling hot-swap** — :meth:`ReplicaPool.swap` runs the swap barrier
  one replica at a time, so capacity never drops to zero;
- **autoscaling** — ``pool.autoscale.*`` grows and shrinks the active set
  from the live ``avenir_slo_burn_rate`` rows and the queue-depth gauges,
  and replaces dead replicas.

Every transition journals ``pool.replica.down``, ``pool.replica.up``,
``pool.scale`` or ``pool.failover``, the JAX package's events.

One card: the JAX package places one replica per local device
(``jax.local_devices()``, ``pool.pin.devices``); the port serves on one
CUDA card, so every replica is on ``cuda:0`` (or all on the CPU when the
caller asks for it), ``pool.replicas`` defaults to 1, and
``pool.pin.devices`` pins every replica to that one device.  The
replicas' dispatcher threads launch kernels on the card concurrently; the
kernel builds are serialized by ``ops/_build.py`` and the kNN launch
counters by a lock.

The pool has the batcher's frontend surface (``submit_nowait`` /
``submit`` / ``queue_depths`` / ``counters`` / ``latency`` / ``stats`` /
``health``), so :class:`~avenir_tpu_torch.serving.frontend.ScoreHTTPServer`
and :class:`~avenir_tpu_torch.serving.frontend.QueueScoreFrontend` serve
a pool unchanged; ``counters`` and the latency trackers are shared by
the replicas.
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Set

from avenir_tpu_torch.core.config import ConfigError, JobConfig
from avenir_tpu_torch.serving.batcher import (BucketedMicrobatcher,
                                              PendingRequest)
from avenir_tpu_torch.serving.errors import (
    ReplicaDownError,
    ServingError,
    ShedError,
)
from avenir_tpu_torch.telemetry import blackbox
from avenir_tpu_torch.telemetry import spans as tel
from avenir_tpu_torch.utils.metrics import (Counters, LatencyTracker,
                                            serving_stats)
from avenir_tpu_torch.utils.retry import FaultPlan

log = logging.getLogger(__name__)

# breaker states — the classic three-state circuit
CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


class Replica:
    """One pool member: a batcher plus its routing/breaker state."""

    __slots__ = ("name", "batcher", "breaker", "consecutive", "opened_at",
                 "active", "dead")

    def __init__(self, name: str, batcher: BucketedMicrobatcher):
        self.name = name
        self.batcher = batcher
        self.breaker = CLOSED
        self.consecutive = 0              # consecutive infra dispatch errors
        self.opened_at = 0.0
        self.active = True                # False once retired or dead
        self.dead = False                 # died/wedged — never comes back

    @property
    def routable(self) -> bool:
        """Health gate: traffic goes only to an active, warmed, breaker-
        closed replica whose dispatcher has not failed."""
        return (self.active and self.breaker == CLOSED
                and self.batcher.ready and not self.batcher.failed)

    def depth(self) -> int:
        return sum(self.batcher.queue_depths().values())


class PoolRequest:
    """The pool's pending handle: delegates to the current replica's
    :class:`PendingRequest` and fails over on replica death.

    ``wait`` re-enqueues the request on a survivor each time the holding
    replica dies (at most ``pool.failover.retries`` times), so the caller
    sees either the scored line or one typed error — a replica loss is
    shed requests at worst, never a hang and never a silent drop."""

    __slots__ = ("pool", "model", "line", "rid", "inner", "replica",
                 "tried", "attempts")

    def __init__(self, pool: "ReplicaPool", model: str, line: str, rid: str):
        self.pool = pool
        self.model = model
        self.line = line
        self.rid = rid
        self.inner: Optional[PendingRequest] = None
        self.replica: str = ""
        self.tried: Set[str] = set()
        self.attempts = 0                 # failover re-enqueues so far

    def wait(self, timeout_s: Optional[float] = None) -> str:
        if timeout_s is None:
            timeout_s = self.pool.request_timeout_s + 30.0
        deadline = time.monotonic() + timeout_s
        while True:
            try:
                return self.inner.wait(
                    max(deadline - time.monotonic(), 0.001))
            except ReplicaDownError:
                # the replica died before this request scored: re-enqueue
                # on a survivor (raises typed ShedError when retries are
                # exhausted or no survivor is ready)
                self.pool._failover(self)


class ReplicaPool:
    """N :class:`BucketedMicrobatcher` replicas behind one routing door.

    ``factory(name, **wiring)`` builds one replica's batcher; the pool
    passes the shared wiring (``counters``, ``latency``, ``fault``, the
    breaker callbacks) through it, so
    every replica reports into one aggregate and one fault schedule spans
    the pool ("kill the N-th dispatch" is pool-wide).
    """

    def __init__(self, factory: Callable[..., BucketedMicrobatcher],
                 replicas: int = 2, *,
                 counters: Optional[Counters] = None,
                 latency: Optional[Dict[str, LatencyTracker]] = None,
                 fault: Optional[FaultPlan] = None,
                 breaker_failures: int = 3,
                 heartbeat_ms: float = 2000.0,
                 halfopen_ms: float = 1000.0,
                 probe_timeout_ms: float = 5000.0,
                 failover_retries: int = 1,
                 monitor_interval_ms: Optional[float] = None,
                 autoscale: bool = False,
                 autoscale_min: int = 1,
                 autoscale_max: Optional[int] = None,
                 up_burn: float = 1.0,
                 down_burn: float = 0.25,
                 queue_frac: float = 0.5,
                 autoscale_interval_s: float = 5.0,
                 slo=None,
                 tenant: str = "",
                 start_monitor: bool = True):
        if replicas < 1:
            raise ConfigError(f"pool.replicas must be >= 1, got {replicas}")
        self._factory = factory
        # the tenant label (tenant.id): each replica's batcher reads it
        # too; the pool carries it so its own door sheds attribute
        self.tenant = tenant
        self.counters = counters if counters is not None else Counters()
        self.latency: Dict[str, LatencyTracker] = (
            latency if latency is not None else {})
        self.fault = fault
        self.breaker_failures = max(int(breaker_failures), 1)
        self.heartbeat_s = float(heartbeat_ms) / 1e3
        self.halfopen_s = float(halfopen_ms) / 1e3
        self.probe_timeout_s = float(probe_timeout_ms) / 1e3
        self.failover_retries = max(int(failover_retries), 0)
        self.autoscale = bool(autoscale)
        self.autoscale_min = max(int(autoscale_min), 1)
        self.autoscale_max = int(autoscale_max) if autoscale_max else \
            max(replicas, self.autoscale_min)
        self.up_burn = float(up_burn)
        self.down_burn = float(down_burn)
        self.queue_frac = float(queue_frac)
        self.autoscale_interval_s = float(autoscale_interval_s)
        self.slo = slo
        self._lock = threading.Lock()
        self._replicas: Dict[str, Replica] = {}
        # model → the entry the pool last swapped in: a replica spawned
        # AFTER a rolling swap (autoscale growth, replacement) must come
        # up on the swapped version, not re-load the conf's original
        # artifact — else it would silently serve stale predictions
        self._swapped: Dict[str, object] = {}
        self._next_index = 0
        self._rid = itertools.count(1)
        self._last_scale = time.monotonic()
        for _ in range(replicas):
            self._spawn(reason="start", journal=False)
        # the supervisor: heartbeat deadlines, breaker half-open probes,
        # dead-replica reaping + replacement, autoscaling — one thread,
        # ticking a few times per heartbeat window
        self._stop_evt = threading.Event()
        self.monitor_interval_s = (
            float(monitor_interval_ms) / 1e3 if monitor_interval_ms
            else max(self.heartbeat_s / 4.0, 0.02))
        self._monitor = threading.Thread(target=self._monitor_loop,
                                         daemon=True, name="pool-monitor")
        # a forensics bundle snapshots this pool's routing and breaker
        # table
        self._bb_name = f"pool-{id(self):x}"
        blackbox.register_provider(self._bb_name, self._blackbox_state)
        if start_monitor:
            self._monitor.start()

    # -- construction --------------------------------------------------------
    @classmethod
    def from_conf(cls, conf: JobConfig, registry_factory=None, device=None,
                  **overrides) -> "ReplicaPool":
        """Build the pool from ``pool.*`` keys.  ``pool.replicas`` defaults
        to one replica per device, and the port serves on one card, so to
        1; every replica loads its models onto ``device`` (``cuda``
        unless the CPU is asked for; ``pool.pin.devices`` pins them all to
        it, which is the only placement one card has).
        ``registry_factory`` overrides how each replica loads its models
        (tests); by default each replica holds its own
        ``ModelRegistry.from_conf``, which lets a hot swap roll one
        replica at a time.  ``overrides`` win over conf keys."""
        from avenir_tpu_torch.device import resolve_device
        from avenir_tpu_torch.serving.registry import ModelRegistry
        from avenir_tpu_torch.telemetry.slo import SloEvaluator

        n = conf.get_int("pool.replicas", 0) or 1
        dev = resolve_device(device) if registry_factory is None else None
        # the JAX package pins one replica per local device; the port has
        # one card and every replica already loads onto dev, so the key is
        # read and pins nothing more
        conf.get_bool("pool.pin.devices", False)

        def factory(name: str, **wiring) -> BucketedMicrobatcher:
            registry = (registry_factory() if registry_factory is not None
                        else ModelRegistry.from_conf(conf, device=dev))
            return BucketedMicrobatcher.from_conf(registry, conf,
                                                  name=name, **wiring)

        kwargs = dict(
            replicas=n,
            fault=FaultPlan.from_conf(conf),
            breaker_failures=conf.get_int("pool.breaker.failures", 3),
            heartbeat_ms=conf.get_float("pool.heartbeat.ms", 2000.0),
            halfopen_ms=conf.get_float("pool.breaker.halfopen.ms", 1000.0),
            probe_timeout_ms=conf.get_float("pool.probe.timeout.ms", 5000.0),
            failover_retries=conf.get_int("pool.failover.retries", 1),
            monitor_interval_ms=conf.get_float("pool.monitor.interval.ms"),
            autoscale=conf.get_bool("pool.autoscale.on", False),
            autoscale_min=conf.get_int("pool.autoscale.min", 1),
            autoscale_max=conf.get_int("pool.autoscale.max", 0) or None,
            up_burn=conf.get_float("pool.autoscale.up.burn", 1.0),
            down_burn=conf.get_float("pool.autoscale.down.burn", 0.25),
            queue_frac=conf.get_float("pool.autoscale.queue.frac", 0.5),
            autoscale_interval_s=conf.get_float(
                "pool.autoscale.interval.sec", 5.0),
            slo=SloEvaluator.from_conf(conf),
            tenant=conf.get("tenant.id", "") or "",
        )
        kwargs.update(overrides)
        replicas = kwargs.pop("replicas")
        return cls(factory, replicas, **kwargs)

    def _spawn(self, reason: str, journal: bool = True) -> Replica:
        name = f"r{self._next_index}"
        wiring = dict(
            counters=self.counters, latency=self.latency, fault=self.fault,
            on_batch_ok=lambda n=name: self._on_batch_ok(n),
            on_batch_error=lambda exc, n=name: self._on_batch_error(n, exc))
        self._next_index += 1
        replica = Replica(name, self._factory(name, **wiring))
        with self._lock:
            swapped = dict(self._swapped)
        for model, entry in swapped.items():
            # catch the newcomer up to the pool's current versions (the
            # same warmup barrier a rolling swap runs)
            replica.batcher.swap(model, entry)
        with self._lock:
            self._replicas[name] = replica
        if journal:
            tel.tracer().event("pool.replica.up", replica=name,
                               reason=reason)
        return replica

    # -- routing + submission (any thread) -----------------------------------
    def _choose(self, exclude: Set[str] = frozenset()
                ) -> Optional[Replica]:
        """Least-queue-depth routing over the health-gated replica set."""
        with self._lock:
            cands = [r for r in self._replicas.values()
                     if r.routable and r.name not in exclude]
        if not cands:
            return None
        return min(cands, key=lambda r: r.depth())

    def _submit_on(self, req: PoolRequest) -> None:
        """Bind ``req`` to the best ready replica (raises typed ShedError
        when none is).  A replica dying between choose and submit is
        skipped, not counted against the request's failover budget."""
        while True:
            replica = self._choose(exclude=req.tried)
            if replica is None:
                self.counters.increment(f"Serving.{req.model}", "shed")
                self.counters.increment("Pool", "no.ready")
                err = ShedError(
                    f"no ready replica for {req.model!r} "
                    f"(request {req.rid}) — shed at the pool door")
                if self.tenant:
                    err.tenant = self.tenant
                raise err
            try:
                req.inner = replica.batcher.submit_nowait(
                    req.model, req.line, rid=req.rid)
            except ReplicaDownError:
                req.tried.add(replica.name)   # raced a death; try the next
                continue
            except ServingError as err:
                if type(err) is ServingError:
                    # raced a scale-down close ("batcher is closed"):
                    # skip to a survivor like the death race above —
                    # typed errors (shed/unknown-model/...) still
                    # propagate to the caller
                    req.tried.add(replica.name)
                    continue
                raise
            req.replica = replica.name
            req.tried.add(replica.name)
            return

    def submit_nowait(self, model: str, line: str,
                      rid: Optional[str] = None) -> PoolRequest:
        # a caller-assigned rid wins over the pool's own ``q<n>``: the one
        # id that threads the request through the journal
        req = PoolRequest(self, model, line,
                          rid=rid or f"q{next(self._rid)}")
        self.counters.increment("Pool", "submitted")
        self._submit_on(req)
        return req

    def submit(self, model: str, line: str,
               timeout_s: Optional[float] = None) -> str:
        return self.submit_nowait(model, line).wait(timeout_s)

    def _failover(self, req: PoolRequest) -> None:
        """Re-enqueue a request whose replica died; at most
        ``pool.failover.retries`` re-enqueues per request, then a typed
        ShedError — never silent loss (the caller always gets a result
        or one typed error) and never a double score (only unscored
        requests carry ReplicaDownError)."""
        req.attempts += 1
        self.counters.increment("Pool", "failovers")
        if req.attempts > self.failover_retries:
            self.counters.increment(f"Serving.{req.model}", "shed")
            self.counters.increment("Pool", "failover.exhausted")
            raise ShedError(
                f"request {req.rid} for {req.model!r} lost its replica "
                f"{req.attempts} time(s) — pool.failover.retries="
                f"{self.failover_retries} exhausted, request shed")
        prev = req.replica
        self._submit_on(req)              # raises ShedError when none ready
        tel.tracer().event("pool.failover", rid=req.rid, model=req.model,
                           **{"from": prev, "to": req.replica},
                           attempt=req.attempts)

    # -- breaker callbacks (replica dispatch threads) ------------------------
    def _on_batch_ok(self, name: str) -> None:
        with self._lock:
            r = self._replicas.get(name)
            if r is None:
                return
            r.consecutive = 0

    def _on_batch_error(self, name: str, exc: BaseException) -> None:
        trip = False
        with self._lock:
            r = self._replicas.get(name)
            if r is None:
                return
            r.consecutive += 1
            if r.breaker == CLOSED and \
                    r.consecutive >= self.breaker_failures:
                r.breaker = OPEN
                r.opened_at = time.monotonic()
                trip = True
        if trip:
            self.counters.increment("Pool", "breaker.trips")
            tel.tracer().event("pool.replica.down", replica=name,
                               reason="breaker", pending=0)

    # -- supervision (monitor thread; public for deterministic tests) --------
    def monitor_once(self) -> None:
        """One supervision tick: reap dead/stalled replicas (failing their
        stranded requests over), run half-open probes, autoscale."""
        now = time.monotonic()
        with self._lock:
            replicas = list(self._replicas.values())
        for r in replicas:
            if r.dead or not r.active:
                continue
            b = r.batcher
            if b.failed or b.stalled(self.heartbeat_s):
                # a dead dispatcher (injected kill) or a wedged one (work
                # pending, heartbeat past the deadline): take it out of
                # rotation and fail its stranded queue over to survivors
                reason = "died" if b.failed else "heartbeat"
                r.dead = True
                r.active = False
                r.breaker = OPEN
                b.mark_failed()
                pending = b.fail_pending(
                    "missed pool.heartbeat.ms deadline" if reason ==
                    "heartbeat" else "replica died")
                self.counters.increment("Pool", "replicas.lost")
                tel.tracer().event("pool.replica.down", replica=r.name,
                                   reason=reason, pending=pending)
                continue
            if r.breaker == OPEN and now - r.opened_at >= self.halfopen_s:
                # half-open: one probe request through the replica's real
                # dispatch queue decides — alive again closes the
                # breaker.  The probe blocks up to pool.probe.timeout.ms,
                # so it runs OFF the supervision thread: heartbeat
                # deadlines on other replicas must not wait behind a
                # hung probe.  HALF_OPEN set first = at most one probe
                # in flight per replica (later ticks see != OPEN).
                with self._lock:
                    r.breaker = HALF_OPEN
                threading.Thread(target=self._probe_replica, args=(r,),
                                 daemon=True,
                                 name=f"pool-probe-{r.name}").start()
        if self.autoscale and \
                now - self._last_scale >= self.autoscale_interval_s:
            self._last_scale = now
            self.autoscale_once()

    def _probe_replica(self, r: Replica) -> None:
        try:
            alive = r.batcher.probe(self.probe_timeout_s)
        except Exception:                 # noqa: BLE001
            # a raising probe must route to the failure branch: a dead
            # thread here would strand the replica HALF_OPEN forever
            # (ticks only probe while the breaker reads OPEN)
            alive = False
        if alive:
            with self._lock:
                r.breaker = CLOSED
                r.consecutive = 0
            self.counters.increment("Pool", "breaker.closes")
            tel.tracer().event("pool.replica.up", replica=r.name,
                               reason="probe")
        else:
            with self._lock:
                r.breaker = OPEN
                r.opened_at = time.monotonic()

    def autoscale_once(self) -> None:
        """One autoscaler evaluation over the live burn-rate rows and the
        queue-depth gauges: replace lost capacity below
        ``pool.autoscale.min``, grow on burn/queue pressure up to
        ``pool.autoscale.max``, shrink when cold — each decision journals
        a golden-schema'd ``pool.scale`` event."""
        with self._lock:
            live = [r for r in self._replicas.values() if r.active]
        ready = [r for r in live if r.routable]
        depths = self.queue_depths()
        total_depth = sum(depths.values())
        cap = sum(r.batcher.queue_depth for r in ready)
        frac = (total_depth / cap) if cap else 1.0
        burn = 0.0
        if self.slo is not None:
            rows = self.slo.evaluate_live(self.counters, self.latency,
                                          depths)
            burns = [row["burn_rate"] for row in rows
                     if row["burn_rate"] is not None]
            burn = max(burns) if burns else 0.0
        tracer = tel.tracer()
        tracer.gauge("pool.replicas.ready", len(ready))
        tracer.gauge("pool.replicas.active", len(live))
        tracer.gauge("pool.burn.max", round(burn, 6))
        if len(ready) < self.autoscale_min:
            # lost capacity: replace, don't wait for pressure — this is
            # what turns a replica kill into shed requests, not an outage
            self._spawn(reason="replace")
            self._scale_event("up", len(ready) + 1, len(live) + 1, burn,
                              frac, "replace")
        elif (burn >= self.up_burn or frac >= self.queue_frac) and \
                len(live) < self.autoscale_max:
            reason = "burn" if burn >= self.up_burn else "queue"
            self._spawn(reason=reason)
            self._scale_event("up", len(ready) + 1, len(live) + 1, burn,
                              frac, reason)
        elif burn <= self.down_burn and frac <= 0.05 and \
                len(ready) > self.autoscale_min:
            victim = ready[-1]            # newest ready replica drains out
            with self._lock:
                victim.active = False     # out of rotation first…
            # …then drain in-flight work OFF the supervision thread (a
            # close joins the dispatcher — up to its flush — and the
            # heartbeat watch must keep ticking meanwhile)
            threading.Thread(target=victim.batcher.close, daemon=True,
                             name=f"pool-drain-{victim.name}").start()
            self.counters.increment("Pool", "scaled.down")
            tel.tracer().event("pool.replica.down", replica=victim.name,
                               reason="scale.down", pending=0)
            self._scale_event("down", len(ready) - 1, len(live) - 1, burn,
                              frac, "cold")

    def _scale_event(self, direction: str, ready: int, total: int,
                     burn: float, frac: float, reason: str) -> None:
        self.counters.increment("Pool", f"scale.{direction}")
        tel.tracer().event("pool.scale", direction=direction, ready=ready,
                           total=total, burn=round(burn, 6),
                           queue_frac=round(frac, 6), reason=reason)

    def _monitor_loop(self) -> None:
        while not self._stop_evt.wait(self.monitor_interval_s):
            try:
                self.monitor_once()
            except Exception:                      # pragma: no cover
                log.exception("pool monitor tick failed")

    # -- rolling hot-swap ----------------------------------------------------
    def swap(self, model: str, entry, warm: bool = True) -> Dict[str, int]:
        """Pool-wide versioned hot-swap, rolled ONE replica at a time:
        each replica warms the incoming entry's bucket shapes before
        publishing (the batcher's swap barrier), and while it warms every other
        replica keeps serving — capacity never drops to zero mid-swap.
        Returns each live replica's new version.  The entry is
        remembered so a replica spawned LATER (autoscale growth,
        replacement) comes up on it too, not on the conf's original
        artifact."""
        versions: Dict[str, int] = {}
        with self._lock:
            self._swapped[model] = entry
            replicas = [r for r in self._replicas.values()
                        if r.active and not r.batcher.failed]
        for r in replicas:
            versions[r.name] = r.batcher.swap(model, entry, warm=warm)
        return versions

    # -- the batcher-compatible frontend surface -----------------------------
    @property
    def ready(self) -> bool:
        """Aggregate readiness: green iff at least ONE replica routes."""
        with self._lock:
            return any(r.routable for r in self._replicas.values())

    @property
    def request_timeout_s(self) -> float:
        with self._lock:
            if not self._replicas:
                return 1.0
            return max(r.batcher.request_timeout_s
                       for r in self._replicas.values())

    @property
    def buckets(self) -> List[int]:
        with self._lock:
            for r in self._replicas.values():
                return r.batcher.buckets
        return []

    def queue_depths(self) -> Dict[str, int]:
        """Per-model pending depth SUMMED across live replicas — the
        ``serve.queue.<model>`` gauges a pool frontend exposes."""
        out: Dict[str, int] = {}
        with self._lock:
            replicas = [r for r in self._replicas.values()
                        if r.active and not r.batcher.failed]
        for r in replicas:
            for model, depth in r.batcher.queue_depths().items():
                out[model] = out.get(model, 0) + depth
        return out

    def gauges(self) -> Dict[str, float]:
        """Pool-level ``/metrics`` gauges: readiness and per-replica
        queue depth, so a rolling swap or tripped breaker is visible on
        the scrape page, not just in the journal."""
        with self._lock:
            replicas = list(self._replicas.values())
        out = {
            "pool.replicas.ready": float(
                sum(1 for r in replicas if r.routable)),
            "pool.replicas.active": float(
                sum(1 for r in replicas if r.active)),
        }
        for r in replicas:
            if r.active:
                out[f"pool.queue.{r.name}"] = float(r.depth())
        return out

    def health(self) -> Dict[str, object]:
        """The pool-mode ``/healthz`` body: aggregate readiness (green
        iff ≥ 1 replica is ready) plus one row per replica — ready,
        breaker state, queue depth vs cap, registry versions — so a
        rolling swap or a tripped breaker is visible from one curl."""
        with self._lock:
            replicas = list(self._replicas.values())
        rows = []
        models: Set[str] = set()
        versions: Dict[str, int] = {}
        buckets: List[int] = []
        any_ready = False
        cap = 0
        for r in replicas:
            h = r.batcher.health()
            routable = r.routable
            any_ready |= routable
            rows.append({"replica": r.name, "ready": routable,
                         "breaker": r.breaker, "active": r.active,
                         "queue": h["queue"], "versions": h["versions"]})
            models.update(h["models"])
            buckets = h["buckets"]
            if r.active and not r.batcher.failed:
                cap += r.batcher.queue_depth
                for m, v in h["versions"].items():
                    # the conservative rollout view: a swap has "landed"
                    # when the SLOWEST live replica runs the new version
                    versions[m] = min(versions.get(m, v), v)
        depths = self.queue_depths()
        return {
            "status": "ok" if any_ready else "unavailable",
            "ready": any_ready,
            "models": sorted(models),
            "buckets": buckets,
            "queue": {m: {"depth": d, "cap": cap} for m, d in
                      depths.items()},
            "versions": versions,
            "replicas": rows,
        }

    def stats(self, identity: Optional[Dict[str, str]] = None
              ) -> Dict[str, dict]:
        """The shared serving-stats schema over the POOL aggregate (the
        counters/latency every replica reports into), plus a ``pool``
        row: replica counts, failovers, breaker trips."""
        out = serving_stats(self.counters, self.latency, identity=identity)
        with self._lock:
            replicas = list(self._replicas.values())
        pool_counters = self.counters.as_dict().get("Pool", {})
        out["pool"] = {
            "replicas": sum(1 for r in replicas if r.active),
            "ready": sum(1 for r in replicas if r.routable),
            **{k: v for k, v in sorted(pool_counters.items())},
        }
        return out

    def _blackbox_state(self) -> List[Dict[str, object]]:
        """The bundle's pool-state rows: name, routable, breaker state,
        consecutive failures, queue depth per replica."""
        with self._lock:
            replicas = list(self._replicas.values())
        return [{"replica": r.name, "routable": r.routable,
                 "breaker": r.breaker, "active": r.active,
                 "consecutive": r.consecutive, "depth": r.depth()}
                for r in replicas]

    def close(self) -> None:
        """Stop supervision, then drain and close every replica."""
        self._stop_evt.set()
        if self._monitor.is_alive():
            self._monitor.join(timeout=10.0)
        with self._lock:
            replicas = list(self._replicas.values())
        for r in replicas:
            r.batcher.close()
        blackbox.unregister_provider(self._bb_name)

    def __enter__(self) -> "ReplicaPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
