"""GlobalServe — one logical serving frontend over a launched worker fleet;
port of ``avenir_tpu/serving/global_pool.py``.

A :class:`~avenir_tpu_torch.serving.pool.ReplicaPool` keeps N replicas
alive inside ONE process; the launcher (``launch/``) starts N processes for
the count jobs.  This module composes them: every worker process runs a
full serving plane (``python -m avenir_tpu_torch.serving`` — a ReplicaPool
when ``pool.*`` is armed), and a :class:`GlobalRouter` fronts the fleet
over the HTTP transport, so the death of a whole OS process costs shed
requests, never an outage:

- **health-gated least-load routing** — each worker's ``/healthz`` is the
  routing feed (polled by the monitor thread): traffic goes to the
  routable worker with the fewest in-flight + queued requests;
- **worker-level circuit breaker** — ``fleet.pool.breaker.failures``
  consecutive transport failures open a worker's breaker; after
  ``fleet.pool.breaker.halfopen.ms`` a healthz probe decides closed vs
  open — the replica breaker, one level up;
- **process-death failover** — a request in flight to a dying worker
  fails with the retryable
  :class:`~avenir_tpu_torch.serving.errors.WorkerDownError` (connection
  reset, or a worker-side 503 vouching the request never scored) and is
  re-sent to a survivor under a fresh attempt-qualified rid
  (``g<n>.a<k>``), at most ``fleet.pool.failover.retries`` times — never
  silent loss, and never a double score (a 2xx response is the ONLY
  delivery; each attempt's rid is distinct, so the merged journal proves
  exactly one scored span per delivered request);
- **rolling fleet-wide hot-swap** — :meth:`GlobalRouter.swap_fleet` rolls
  the warmup barrier one WORKER at a time through each worker's
  ``POST /swap``, polling fleet readiness between hops so ready capacity
  never drops below ``fleet.pool.swap.floor``;
- **process-granularity autoscaling** — the pool's burn-rate grammar
  under its own family (``fleet.pool.autoscale.*``): the router spawns or
  retires whole worker processes through its launcher-provided spawner.

Every transition journals schema'd events — ``fleet.pool.worker.down`` /
``fleet.pool.worker.up`` / ``fleet.pool.scale`` / ``fleet.pool.failover``
/ ``fleet.pool.swap`` — into the ROUTER's journal shard; worker shards
carry the per-request ``serve.request`` spans, and ``merge_fleet_journal``
folds them into the one fleet view.

The router duck-types the batcher's frontend surface (``submit_nowait`` /
``submit`` / ``queue_depths`` / ``counters`` / ``latency`` / ``stats`` /
``health`` / ``gauges``), so
:class:`~avenir_tpu_torch.serving.frontend.ScoreHTTPServer` serves a fleet
unchanged — ``/healthz`` aggregates per-worker readiness rows and
``/metrics`` splices a ``worker`` label via ``fleet_identity``.

Tenancy stays GLOBAL: the router holds the conf's FULL ``tenant.*``
contracts and enforces each tenant's fleet-wide in-flight quota at its
door, while the launcher hands every worker a 1/N split of the same
contracts (:func:`~avenir_tpu_torch.tenancy.contract.split_contracts`) so
worker-local arbitration sums back to the declared global shares.

Two differences from the JAX package, both in :class:`WorkerSpawner`:

- it hands no port number to a worker.  The JAX spawner picks a free
  port, closes it and passes it on, and anything that binds in between
  can take it; here every worker binds ``--http-port 0`` and the spawner
  reads the bound address from the worker's own ``serving ... on
  http://host:port`` line;
- ``command`` (``launch --serve ... -- <argv>``) may start each worker
  through a wrapper in place of ``python -m avenir_tpu_torch.serving``,
  given the same arguments, so that a harness can read what happens
  inside each worker process (``chip_smoke.py --serve-worker`` counts
  the kernel launches there).
"""

from __future__ import annotations

import itertools
import json
import logging
import re
import socket
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Set

from avenir_tpu_torch.core.config import ConfigError, JobConfig
from avenir_tpu_torch.serving.errors import (
    RequestError,
    RequestTimeout,
    ServingError,
    ShedError,
    TenantShedError,
    UnknownModelError,
    WorkerDownError,
)
from avenir_tpu_torch.telemetry import blackbox
from avenir_tpu_torch.telemetry import spans as tel
from avenir_tpu_torch.utils.metrics import Counters, LatencyTracker, serving_stats

log = logging.getLogger(__name__)

# breaker states — the three-state circuit of serving/pool.py, one level up
CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


class WorkerClient:
    """Blocking stdlib HTTP client for ONE worker's serving plane.

    Wraps ``http.client`` (no third-party deps — the same constraint the
    RESP transport honors) and maps the worker's typed error bodies back
    to the SAME typed exceptions the in-process batcher raises, so the
    router's failure handling is transport-agnostic: a refused/reset
    connection or a worker-side 503 ``REPLICA_DOWN`` becomes the
    retryable :class:`WorkerDownError`; shed/timeout/unknown-model/bad-
    request stay typed and non-retryable."""

    def __init__(self, host: str, port: int, name: str = "",
                 timeout_s: float = 30.0):
        self.host = host
        self.port = int(port)
        self.name = name or f"{host}:{port}"
        self.timeout_s = float(timeout_s)

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def _request(self, method: str, path: str, payload: Optional[dict],
                 timeout_s: Optional[float],
                 ok_status: Sequence[int] = ()) -> dict:
        import http.client

        conn = http.client.HTTPConnection(
            self.host, self.port,
            timeout=timeout_s if timeout_s is not None else self.timeout_s)
        try:
            body = json.dumps(payload).encode() if payload is not None \
                else None
            headers = {"Content-Type": "application/json"} if body else {}
            try:
                conn.request(method, path, body=body, headers=headers)
                resp = conn.getresponse()
                raw = resp.read()
            except (ConnectionError, socket.timeout,
                    http.client.HTTPException, OSError) as exc:
                # transport failure: no response landed, so the request
                # (if any) was NOT delivered — retryable by construction
                raise WorkerDownError(
                    f"worker {self.name!r} unreachable at {self.url}: "
                    f"{type(exc).__name__}: {exc}",
                    worker=self.name) from exc
            try:
                doc = json.loads(raw) if raw else {}
            except ValueError:
                doc = {}
            if resp.status < 400 or resp.status in ok_status:
                return doc
            raise self._typed_error(resp.status, doc)
        finally:
            conn.close()

    def _typed_error(self, status: int, doc: dict) -> ServingError:
        """The worker's JSON error body, re-raised as the batcher's own
        typed exception so ``PoolRequest``-style retry logic and the
        frontend's status mapping work unchanged across the hop."""
        code = doc.get("error", "")
        message = doc.get("message", f"HTTP {status} from {self.name}")
        if status == 503 or code in ("REPLICA_DOWN", "WORKER_DOWN"):
            # the worker itself vouches the request never scored (the
            # ReplicaDownError contract) — safe to fail over
            return WorkerDownError(
                f"worker {self.name!r}: {message}", worker=self.name)
        if status == 404 or code == "UNKNOWN_MODEL":
            return UnknownModelError(message)
        if status == 429 or code in ("SHED", "TENANT_SHED"):
            if doc.get("tenant"):
                return TenantShedError(
                    message, tenant=doc["tenant"],
                    quota=doc.get("quota", ""),
                    retry_after_s=float(doc.get("retry_after_ms", 0.0))
                    / 1e3)
            return ShedError(message)
        if status == 504 or code == "TIMEOUT":
            return RequestTimeout(message)
        if status == 400 or code == "BAD_REQUEST":
            return RequestError(message)
        return ServingError(message)

    def get(self, path: str, timeout_s: Optional[float] = None) -> dict:
        return self._request("GET", path, None, timeout_s)

    def healthz(self, timeout_s: Optional[float] = None) -> dict:
        """The worker's ``/healthz`` body (the routing feed).  A 503 is a
        VALID answer — up but not ready (warming, mid-swap) — so it
        returns the body instead of raising: only TRANSPORT failures
        raise WorkerDownError and count toward the breaker."""
        try:
            return self._request("GET", "/healthz", None, timeout_s,
                                 ok_status=(503,))
        except WorkerDownError:
            raise
        except ServingError:                   # pragma: no cover - defensive
            return {"ready": False}

    def score(self, model: str, rows: Sequence[str],
              rids: Optional[Sequence[str]] = None,
              tenant: Optional[str] = None,
              timeout_s: Optional[float] = None) -> List[str]:
        payload: Dict[str, object] = {"model": model, "rows": list(rows)}
        if rids:
            payload["rids"] = list(rids)
        if tenant:
            payload["tenant"] = tenant
        doc = self._request("POST", "/score", payload, timeout_s)
        return list(doc.get("results", []))

    def swap(self, model: str, props: Dict[str, str],
             warm: bool = True, timeout_s: Optional[float] = None) -> dict:
        return self._request("POST", "/swap",
                             {"model": model, "props": dict(props),
                              "warm": bool(warm)}, timeout_s)


class GlobalWorker:
    """One fleet member: a worker process's client + routing/breaker
    state.  ``proc`` is the launcher's process handle when the router owns
    the process (None for externally managed workers — tests front
    in-process HTTP servers)."""

    __slots__ = ("name", "client", "proc", "breaker", "consecutive",
                 "opened_at", "active", "dead", "inflight", "health")

    def __init__(self, name: str, client: WorkerClient, proc=None):
        self.name = name
        self.client = client
        self.proc = proc
        self.breaker = CLOSED
        self.consecutive = 0          # consecutive transport failures
        self.opened_at = 0.0
        self.active = True            # False once retired or dead
        self.dead = False             # process died — never comes back
        self.inflight = 0             # router-side in-flight request count
        self.health: Optional[dict] = None    # last /healthz body

    @property
    def routable(self) -> bool:
        """Health gate: traffic goes only to an active worker whose
        breaker is closed and whose last ``/healthz`` poll was green."""
        return (self.active and not self.dead and self.breaker == CLOSED
                and bool(self.health) and bool(self.health.get("ready")))

    def depth(self) -> int:
        """Routing load: router-side in-flight plus the worker's own
        queued depth from the last health poll."""
        queued = 0
        if self.health:
            for row in (self.health.get("queue") or {}).values():
                queued += int(row.get("depth", 0))
        return self.inflight + queued


class GlobalRequest:
    """The router's pending handle — same wait/finish contract as the
    batcher's :class:`PendingRequest`, with the failover loop running on
    the router's client threads instead of the caller's."""

    __slots__ = ("model", "line", "rid", "tenant", "result", "error",
                 "_done", "worker", "tried", "attempts")

    def __init__(self, model: str, line: str, rid: str,
                 tenant: Optional[str] = None):
        self.model = model
        self.line = line
        self.rid = rid
        self.tenant = tenant
        self.result: Optional[str] = None
        self.error: Optional[ServingError] = None
        self._done = threading.Event()
        self.worker = ""
        self.tried: Set[str] = set()
        self.attempts = 0             # failover re-sends so far

    def finish(self, result: Optional[str] = None,
               error: Optional[ServingError] = None) -> None:
        if self._done.is_set():       # idempotent — a done request is done
            return
        self.result = result
        self.error = error
        self._done.set()

    def wait(self, timeout_s: Optional[float] = None) -> str:
        if not self._done.wait(timeout_s):
            raise RequestTimeout(
                f"no fleet response for {self.model!r} request {self.rid} "
                f"within {timeout_s}s")
        if self.error is not None:
            raise self.error
        return self.result            # type: ignore[return-value]


class GlobalRouter:
    """N worker processes behind one routing door — the process-level
    twin of :class:`~avenir_tpu_torch.serving.pool.ReplicaPool`.

    ``spawner()`` (launcher integration — :class:`WorkerSpawner`) builds
    and waits out one NEW worker process; the router calls it to replace
    dead workers and to grow under burn/queue pressure, and retires
    processes via SIGTERM when cold.  Without a spawner the fleet is
    fixed-size (tests front in-process servers)."""

    def __init__(self, workers: Sequence[GlobalWorker] = (), *,
                 spawner: Optional[Callable[[], GlobalWorker]] = None,
                 breaker_failures: int = 3,
                 heartbeat_ms: float = 2000.0,
                 halfopen_ms: float = 1000.0,
                 failover_retries: int = 1,
                 monitor_interval_ms: Optional[float] = None,
                 request_timeout_ms: float = 20000.0,
                 client_threads: int = 8,
                 autoscale: bool = False,
                 autoscale_min: int = 1,
                 autoscale_max: Optional[int] = None,
                 up_burn: float = 1.0,
                 down_burn: float = 0.25,
                 queue_frac: float = 0.5,
                 autoscale_interval_s: float = 5.0,
                 swap_floor: int = 1,
                 slo=None,
                 contracts: Optional[Dict[str, object]] = None,
                 counters: Optional[Counters] = None,
                 latency: Optional[Dict[str, LatencyTracker]] = None,
                 start_monitor: bool = True):
        from concurrent.futures import ThreadPoolExecutor

        self.spawner = spawner
        self.breaker_failures = max(int(breaker_failures), 1)
        self.heartbeat_s = float(heartbeat_ms) / 1e3
        self.halfopen_s = float(halfopen_ms) / 1e3
        self.failover_retries = max(int(failover_retries), 0)
        self.request_timeout_s = float(request_timeout_ms) / 1e3
        self.autoscale = bool(autoscale)
        self.autoscale_min = max(int(autoscale_min), 1)
        self.autoscale_max = int(autoscale_max) if autoscale_max else \
            max(len(workers), self.autoscale_min)
        self.up_burn = float(up_burn)
        self.down_burn = float(down_burn)
        self.queue_frac = float(queue_frac)
        self.autoscale_interval_s = float(autoscale_interval_s)
        self.swap_floor = max(int(swap_floor), 0)
        self.slo = slo
        # GLOBAL tenancy: the conf's FULL contracts enforced at the
        # router door (workers run 1/N splits — split_contracts)
        self.contracts = dict(contracts or {})
        self.counters = counters if counters is not None else Counters()
        self.latency: Dict[str, LatencyTracker] = (
            latency if latency is not None else {})
        self._lock = threading.Lock()
        self._workers: Dict[str, GlobalWorker] = {}
        self._tenant_inflight: Dict[str, int] = {}
        self._rid = itertools.count(1)
        self._last_scale = time.monotonic()
        self._spawning = False
        # model → the (props, warm) of the last fleet swap: a worker
        # spawned AFTER a rolling swap must come up on the swapped
        # version, not the conf's original artifact (ReplicaPool parity)
        self._swapped: Dict[str, tuple] = {}
        for w in workers:
            self._workers[w.name] = w
        # the client pool: each request's send/failover loop runs here so
        # concurrent single-row POSTs microbatch inside the workers
        self._pool = ThreadPoolExecutor(
            max_workers=max(int(client_threads), 1),
            thread_name_prefix="fleet-client")
        self._stop_evt = threading.Event()
        self.monitor_interval_s = (
            float(monitor_interval_ms) / 1e3 if monitor_interval_ms
            else max(self.heartbeat_s / 4.0, 0.05))
        # prime the routing feed so requests submitted before the first
        # monitor tick still see ready workers
        for w in list(self._workers.values()):
            self._poll_worker(w)
        self._monitor = threading.Thread(target=self._monitor_loop,
                                         daemon=True, name="fleet-monitor")
        # the router's forensics bundle carries the fleet routing/breaker
        # table (which workers were routable at death)
        self._bb_name = f"router-{id(self):x}"
        blackbox.register_provider(self._bb_name, self._blackbox_state)
        if start_monitor:
            self._monitor.start()

    # -- construction --------------------------------------------------------
    @classmethod
    def from_conf(cls, conf: JobConfig,
                  workers: Sequence[GlobalWorker] = (),
                  spawner: Optional[Callable[[], GlobalWorker]] = None,
                  **overrides) -> "GlobalRouter":
        """Build the router from ``fleet.pool.*`` keys — the
        ``pool.autoscale.*`` grammar lifted to process granularity.
        ``overrides`` win over conf keys (tests pin e.g.
        ``start_monitor=False``)."""
        from avenir_tpu_torch.telemetry.slo import SloEvaluator
        from avenir_tpu_torch.tenancy.contract import contracts_from_conf

        kwargs = dict(
            spawner=spawner,
            breaker_failures=conf.get_int("fleet.pool.breaker.failures", 3),
            heartbeat_ms=conf.get_float("fleet.pool.heartbeat.ms", 2000.0),
            halfopen_ms=conf.get_float(
                "fleet.pool.breaker.halfopen.ms", 1000.0),
            failover_retries=conf.get_int("fleet.pool.failover.retries", 1),
            monitor_interval_ms=conf.get_float(
                "fleet.pool.monitor.interval.ms"),
            request_timeout_ms=conf.get_float("serve.request.timeout.ms",
                                              1000.0),
            client_threads=conf.get_int("fleet.pool.client.threads", 8),
            autoscale=conf.get_bool("fleet.pool.autoscale.on", False),
            autoscale_min=conf.get_int("fleet.pool.autoscale.min", 1),
            autoscale_max=conf.get_int("fleet.pool.autoscale.max", 0)
            or None,
            up_burn=conf.get_float("fleet.pool.autoscale.up.burn", 1.0),
            down_burn=conf.get_float("fleet.pool.autoscale.down.burn", 0.25),
            queue_frac=conf.get_float("fleet.pool.autoscale.queue.frac",
                                      0.5),
            autoscale_interval_s=conf.get_float(
                "fleet.pool.autoscale.interval.sec", 5.0),
            swap_floor=conf.get_int("fleet.pool.swap.floor", 1),
            slo=SloEvaluator.from_conf(conf),
            contracts=contracts_from_conf(conf),
        )
        kwargs.update(overrides)
        return cls(workers, **kwargs)

    # -- submission (any thread) ---------------------------------------------
    def submit_nowait(self, model: str, line: str,
                      rid: Optional[str] = None) -> GlobalRequest:
        tenant = tel.current_label("tenant")
        self._tenant_admit(model, tenant)
        req = GlobalRequest(model, line, rid=rid or f"g{next(self._rid)}",
                            tenant=tenant)
        with self._lock:
            any_ready = any(w.routable for w in self._workers.values())
        if not any_ready:
            self._tenant_release(tenant)
            self.counters.increment(f"Serving.{model}", "shed")
            self.counters.increment("Fleet", "no.ready")
            err = ShedError(
                f"no ready worker for {model!r} (request {req.rid}) — "
                f"shed at the fleet door")
            if tenant:
                err.tenant = tenant
            raise err
        self.counters.increment("Fleet", "submitted")
        self._pool.submit(self._run, req)
        return req

    def submit(self, model: str, line: str,
               timeout_s: Optional[float] = None) -> str:
        if timeout_s is None:
            timeout_s = self.request_timeout_s + 30.0
        return self.submit_nowait(model, line).wait(timeout_s)

    def _tenant_admit(self, model: str, tenant: Optional[str]) -> None:
        """Fleet-wide quota admission: the router holds the conf's FULL
        contracts, so a tenant's global in-flight ceiling is enforced at
        ONE door even though each worker only sees its 1/N split."""
        if not tenant:
            return
        contract = self.contracts.get(tenant)
        quota = getattr(contract, "max_inflight", 0) if contract else 0
        with self._lock:
            inflight = self._tenant_inflight.get(tenant, 0)
            if quota and inflight >= quota:
                self.counters.increment(f"Serving.{model}", "shed")
                self.counters.increment(f"Tenant.{tenant}", "shed")
                shed = TenantShedError(
                    f"tenant {tenant!r} at its fleet-wide in-flight quota "
                    f"({quota}) — request shed at the router door",
                    tenant=tenant, quota="fleet.max.inflight",
                    retry_after_s=0.05)
            else:
                self._tenant_inflight[tenant] = inflight + 1
                return
        tel.tracer().event("tenant.shed", tenant=tenant,
                           quota="fleet.max.inflight", waiting=0,
                           inflight=inflight,
                           retry_after_ms=round(shed.retry_after_s * 1e3, 1))
        raise shed

    def _tenant_release(self, tenant: Optional[str]) -> None:
        if not tenant:
            return
        with self._lock:
            n = self._tenant_inflight.get(tenant, 0)
            if n > 1:
                self._tenant_inflight[tenant] = n - 1
            else:
                self._tenant_inflight.pop(tenant, None)

    # -- routing + the per-request send/failover loop ------------------------
    def _choose(self, exclude: Set[str] = frozenset()
                ) -> Optional[GlobalWorker]:
        """Least-load routing over the health-gated worker set."""
        with self._lock:
            cands = [w for w in self._workers.values()
                     if w.routable and w.name not in exclude]
            if not cands:
                return None
            return min(cands, key=lambda w: w.depth())

    def _run(self, req: GlobalRequest) -> None:
        """One request's whole life on a client thread: choose, send,
        and on worker death re-send to a survivor under an attempt-
        qualified rid — the journal-provable failover loop."""
        try:
            self._run_attempts(req)
        except Exception as exc:               # noqa: BLE001 - last resort
            req.finish(error=RequestError(f"{type(exc).__name__}: {exc}"))
        finally:
            self._tenant_release(req.tenant)

    def _run_attempts(self, req: GlobalRequest) -> None:
        prev = ""
        while True:
            worker = self._choose(exclude=req.tried)
            if worker is None and req.tried:
                # every distinct worker tried (or none ready among the
                # untried): widen to ANY routable worker before shedding —
                # a 2-worker fleet that lost one must keep retrying on
                # the survivor
                worker = self._choose()
            if worker is None:
                self.counters.increment(f"Serving.{req.model}", "shed")
                self.counters.increment("Fleet", "no.ready")
                req.finish(error=ShedError(
                    f"no ready worker for {req.model!r} "
                    f"(request {req.rid}) — shed at the fleet door"))
                return
            if req.attempts > 0:
                self.counters.increment("Fleet", "failovers")
                tel.tracer().event("fleet.pool.failover", rid=req.rid,
                                   model=req.model,
                                   **{"from": prev, "to": worker.name},
                                   attempt=req.attempts)
            req.worker = worker.name
            req.tried.add(worker.name)
            with self._lock:
                worker.inflight += 1
            t0 = time.monotonic()
            try:
                outs = worker.client.score(
                    req.model, [req.line],
                    rids=[f"{req.rid}.a{req.attempts}"],
                    tenant=req.tenant,
                    timeout_s=self.request_timeout_s + 30.0)
            except WorkerDownError as err:
                self._on_worker_error(worker)
                prev = worker.name
                req.attempts += 1
                if req.attempts > self.failover_retries:
                    self.counters.increment(f"Serving.{req.model}", "shed")
                    self.counters.increment("Fleet", "failover.exhausted")
                    req.finish(error=ShedError(
                        f"request {req.rid} for {req.model!r} lost its "
                        f"worker {req.attempts} time(s) — fleet.pool."
                        f"failover.retries={self.failover_retries} "
                        f"exhausted, request shed ({err})"))
                    return
                continue
            except ServingError as err:
                # typed, non-retryable: shed/timeout/unknown/bad-request
                req.finish(error=err)
                return
            finally:
                with self._lock:
                    worker.inflight = max(worker.inflight - 1, 0)
            self._on_worker_ok(worker)
            if not outs:
                req.finish(error=RequestError(
                    f"worker {worker.name!r} returned no result for "
                    f"request {req.rid}"))
                return
            self.latency.setdefault(
                req.model, LatencyTracker()).record(time.monotonic() - t0)
            self.counters.increment(f"Serving.{req.model}", "requests")
            req.finish(result=outs[0])
            return

    # -- breaker bookkeeping -------------------------------------------------
    def _on_worker_ok(self, worker: GlobalWorker) -> None:
        with self._lock:
            worker.consecutive = 0

    def _on_worker_error(self, worker: GlobalWorker) -> None:
        trip = False
        with self._lock:
            worker.consecutive += 1
            if worker.breaker == CLOSED and \
                    worker.consecutive >= self.breaker_failures:
                worker.breaker = OPEN
                worker.opened_at = time.monotonic()
                trip = True
        if trip:
            self.counters.increment("Fleet", "breaker.trips")
            tel.tracer().event("fleet.pool.worker.down", worker=worker.name,
                               reason="breaker", pending=0)
            # snapshot what the ROUTER saw the moment the
            # breaker opened — ring tail, routing table, in-flight rids —
            # without spending the router's own crash latch (no-op when
            # blackbox.dir is unset)
            blackbox.capture(f"breaker:{worker.name}")

    # -- supervision (monitor thread; public for deterministic tests) --------
    def monitor_once(self) -> None:
        """One supervision tick: detect dead processes, refresh every
        worker's health feed, run half-open probes, autoscale."""
        now = time.monotonic()
        with self._lock:
            workers = list(self._workers.values())
        for w in workers:
            if w.dead or not w.active:
                continue
            if w.proc is not None and w.proc.poll() is not None:
                # the PROCESS died (SIGKILL, crash): out of rotation now.
                # Its in-flight requests fail over themselves — each
                # blocked POST gets a reset and re-sends to a survivor —
                # so `pending` records how many were stranded mid-hop.
                with self._lock:
                    w.dead = True
                    w.active = False
                    w.breaker = OPEN
                    pending = w.inflight
                self.counters.increment("Fleet", "workers.lost")
                tel.tracer().event("fleet.pool.worker.down", worker=w.name,
                                   reason="died", pending=pending)
                continue
            self._poll_worker(w, now=now)
        if self.autoscale and \
                now - self._last_scale >= self.autoscale_interval_s:
            self._last_scale = now
            self.autoscale_once()

    def _poll_worker(self, w: GlobalWorker,
                     now: Optional[float] = None) -> None:
        """Refresh one worker's ``/healthz`` feed; a transport failure
        counts toward the breaker, a 200 closes a half-open breaker."""
        now = time.monotonic() if now is None else now
        try:
            body = w.client.healthz(timeout_s=min(self.heartbeat_s, 5.0))
        except WorkerDownError:
            with self._lock:
                w.health = None
            self._on_worker_error(w)
            return
        with self._lock:
            w.health = body
            w.consecutive = 0
            reopen = (w.breaker == OPEN
                      and now - w.opened_at >= self.halfopen_s
                      and bool(body.get("ready")))
            if reopen:
                w.breaker = CLOSED
        if reopen:
            self.counters.increment("Fleet", "breaker.closes")
            tel.tracer().event("fleet.pool.worker.up", worker=w.name,
                               reason="probe")

    def _monitor_loop(self) -> None:
        while not self._stop_evt.wait(self.monitor_interval_s):
            try:
                self.monitor_once()
            except Exception:                      # pragma: no cover
                log.exception("fleet monitor tick failed")

    # -- process-granularity autoscaling -------------------------------------
    def autoscale_once(self) -> None:
        """The pool's burn-rate autoscaler at process granularity:
        replace lost capacity below ``fleet.pool.autoscale.min``, spawn a
        worker on burn/queue pressure up to ``fleet.pool.autoscale.max``,
        SIGTERM the newest worker when cold — each decision journals a
        golden-schema'd ``fleet.pool.scale`` event."""
        with self._lock:
            live = [w for w in self._workers.values() if w.active]
            ready = [w for w in live if w.routable]
            spawning = self._spawning
        depths = self.queue_depths()
        total_depth = sum(depths.values())
        cap = 0
        for w in ready:
            for row in ((w.health or {}).get("queue") or {}).values():
                cap += int(row.get("cap", 0))
        frac = (total_depth / cap) if cap else 1.0
        burn = 0.0
        if self.slo is not None:
            rows = self.slo.evaluate_live(self.counters, self.latency,
                                          depths)
            burns = [row["burn_rate"] for row in rows
                     if row["burn_rate"] is not None]
            burn = max(burns) if burns else 0.0
        tracer = tel.tracer()
        tracer.gauge("fleet.workers.ready", len(ready))
        tracer.gauge("fleet.workers.active", len(live))
        tracer.gauge("fleet.burn.max", round(burn, 6))
        if spawning or self.spawner is None:
            return
        if len(ready) < self.autoscale_min:
            # lost capacity: replace without waiting for pressure — what
            # turns a SIGKILLed worker into shed requests, not an outage
            self._spawn_async("replace")
            self._scale_event("up", len(ready), len(live) + 1, burn, frac,
                              "replace")
        elif (burn >= self.up_burn or frac >= self.queue_frac) and \
                len(live) < self.autoscale_max:
            reason = "burn" if burn >= self.up_burn else "queue"
            self._spawn_async(reason)
            self._scale_event("up", len(ready), len(live) + 1, burn, frac,
                              reason)
        elif burn <= self.down_burn and frac <= 0.05 and \
                len(ready) > self.autoscale_min:
            victim = ready[-1]        # newest ready worker drains out
            self.retire(victim, reason="scale.down")
            self._scale_event("down", len(ready) - 1, len(live) - 1, burn,
                              frac, "cold")

    def _scale_event(self, direction: str, ready: int, total: int,
                     burn: float, frac: float, reason: str) -> None:
        self.counters.increment("Fleet", f"scale.{direction}")
        tel.tracer().event("fleet.pool.scale", direction=direction,
                           ready=ready, total=total, burn=round(burn, 6),
                           queue_frac=round(frac, 6), reason=reason)

    def _spawn_async(self, reason: str) -> None:
        """Spawn a worker PROCESS off the monitor thread: bring-up is
        seconds (interpreter + model load + warmup), and heartbeat
        detection on the rest of the fleet must keep ticking meanwhile."""
        with self._lock:
            if self._spawning:
                return
            self._spawning = True
        threading.Thread(target=self._spawn_blocking, args=(reason,),
                         daemon=True, name="fleet-spawn").start()

    def _spawn_blocking(self, reason: str) -> None:
        try:
            worker = self.spawner()
            with self._lock:
                swapped = dict(self._swapped)
            for model, (props, warm) in swapped.items():
                # catch the newcomer up to the fleet's swapped versions
                # (the ReplicaPool._swapped discipline, one level up)
                try:
                    worker.client.swap(model, props, warm=warm)
                except ServingError:           # pragma: no cover
                    log.exception("post-spawn swap of %r failed", model)
            self._poll_worker(worker)
            with self._lock:
                self._workers[worker.name] = worker
            self.counters.increment("Fleet", "workers.spawned")
            tel.tracer().event("fleet.pool.worker.up", worker=worker.name,
                               reason=reason)
        except Exception:                          # noqa: BLE001
            log.exception("fleet worker spawn failed")
        finally:
            with self._lock:
                self._spawning = False

    def retire(self, worker: GlobalWorker, reason: str = "retire") -> None:
        """Take a worker out of rotation and SIGTERM its process (the
        worker's own handler drains, snapshots counters and closes its
        journal shard — serving/__main__.py)."""
        with self._lock:
            worker.active = False
        self.counters.increment("Fleet", "workers.retired")
        tel.tracer().event("fleet.pool.worker.down", worker=worker.name,
                           reason=reason, pending=0)
        if worker.proc is not None and worker.proc.poll() is None:
            worker.proc.terminate()

    # -- rolling fleet-wide hot-swap -----------------------------------------
    def swap_fleet(self, model: str, props: Dict[str, str],
                   warm: bool = True, floor: Optional[int] = None,
                   settle_timeout_s: float = 30.0) -> Dict[str, object]:
        """Roll a model swap across the fleet ONE worker at a time
        through each worker's ``POST /swap`` (inside, the batcher's warmup
        barrier — or the pool's own rolling swap — keeps that worker
        serving).  Between hops the router polls fleet readiness and
        refuses to proceed while ready capacity sits below ``floor``
        (``fleet.pool.swap.floor``), so the observable guarantee is
        end-to-end: ready workers never drop below the floor during the
        rollout.  Returns per-worker versions plus the minimum ready
        count observed."""
        floor = self.swap_floor if floor is None else int(floor)
        with self._lock:
            targets = [w for w in self._workers.values()
                       if w.active and not w.dead]
            self._swapped[model] = (dict(props), bool(warm))
        versions: Dict[str, object] = {}
        min_ready: Optional[int] = None
        for w in targets:
            ready = self._settled_ready(floor, settle_timeout_s)
            min_ready = ready if min_ready is None else min(min_ready, ready)
            if ready < floor:
                raise ShedError(
                    f"fleet ready capacity {ready} below the swap floor "
                    f"{floor} — rolling swap halted before {w.name!r}")
            doc = w.client.swap(model, props, warm=warm)
            version = doc.get("version")
            versions[w.name] = version
            tel.tracer().event("fleet.pool.swap", worker=w.name,
                               model=model, version=version, ready=ready,
                               floor=floor)
            self.counters.increment("Fleet", "swaps")
        ready = self._settled_ready(floor, settle_timeout_s)
        if min_ready is not None:
            min_ready = min(min_ready, ready)
        return {"model": model, "versions": versions,
                "min_ready": min_ready if min_ready is not None else ready,
                "floor": floor}

    def _settled_ready(self, floor: int, timeout_s: float) -> int:
        """Fresh ready count (every active worker re-polled); waits up to
        ``timeout_s`` for the count to reach ``floor`` before giving up
        and returning the last observation."""
        deadline = time.monotonic() + max(timeout_s, 0.0)
        while True:
            with self._lock:
                workers = [w for w in self._workers.values()
                           if w.active and not w.dead]
            for w in workers:
                self._poll_worker(w)
            with self._lock:
                ready = sum(1 for w in self._workers.values()
                            if w.routable)
            if ready >= floor or time.monotonic() >= deadline:
                return ready
            time.sleep(0.1)

    # -- the batcher-compatible frontend surface -----------------------------
    @property
    def ready(self) -> bool:
        with self._lock:
            return any(w.routable for w in self._workers.values())

    @property
    def buckets(self) -> List[int]:
        with self._lock:
            for w in self._workers.values():
                if w.health and w.health.get("buckets"):
                    return list(w.health["buckets"])
        return []

    def queue_depths(self) -> Dict[str, int]:
        """Per-model queued depth SUMMED across routable workers (from
        the health feed) — the ``serve.queue.<model>`` gauges."""
        out: Dict[str, int] = {}
        with self._lock:
            workers = [w for w in self._workers.values() if w.routable]
        for w in workers:
            for model, row in ((w.health or {}).get("queue") or {}).items():
                out[model] = out.get(model, 0) + int(row.get("depth", 0))
        return out

    def gauges(self) -> Dict[str, float]:
        with self._lock:
            workers = list(self._workers.values())
        out = {
            "fleet.workers.ready": float(
                sum(1 for w in workers if w.routable)),
            "fleet.workers.active": float(
                sum(1 for w in workers if w.active)),
        }
        for w in workers:
            if w.active:
                out[f"fleet.queue.{w.name}"] = float(w.depth())
        return out

    def health(self) -> Dict[str, object]:
        """The fleet ``/healthz`` body: green iff ≥ 1 worker is ready,
        plus one row per worker — the aggregate readiness contract,
        rendered by the unchanged HTTP frontend."""
        with self._lock:
            workers = list(self._workers.values())
        rows = []
        models: Set[str] = set()
        versions: Dict[str, int] = {}
        buckets: List[int] = []
        queue: Dict[str, Dict[str, int]] = {}
        any_ready = False
        for w in workers:
            h = w.health or {}
            routable = w.routable
            any_ready |= routable
            rows.append({"worker": w.name, "url": w.client.url,
                         "ready": routable, "breaker": w.breaker,
                         "active": w.active, "alive": not w.dead,
                         "inflight": w.inflight,
                         "queue": h.get("queue", {}),
                         "versions": h.get("versions", {})})
            models.update(h.get("models", []))
            if h.get("buckets"):
                buckets = list(h["buckets"])
            if w.active and not w.dead:
                for m, row in (h.get("queue") or {}).items():
                    agg = queue.setdefault(m, {"depth": 0, "cap": 0})
                    agg["depth"] += int(row.get("depth", 0))
                    agg["cap"] += int(row.get("cap", 0))
                for m, v in (h.get("versions") or {}).items():
                    # conservative rollout view: a fleet swap has landed
                    # when the SLOWEST live worker runs the new version
                    versions[m] = min(versions.get(m, v), v)
        return {
            "status": "ok" if any_ready else "unavailable",
            "ready": any_ready,
            "models": sorted(models),
            "buckets": buckets,
            "queue": queue,
            "versions": versions,
            "workers": rows,
        }

    def stats(self, identity: Optional[Dict[str, str]] = None
              ) -> Dict[str, dict]:
        out = serving_stats(self.counters, self.latency, identity=identity)
        with self._lock:
            workers = list(self._workers.values())
        fleet_counters = self.counters.as_dict().get("Fleet", {})
        out["fleet"] = {
            "workers": sum(1 for w in workers if w.active),
            "ready": sum(1 for w in workers if w.routable),
            **{k: v for k, v in sorted(fleet_counters.items())},
        }
        return out

    def _blackbox_state(self) -> List[Dict[str, object]]:
        """The bundle's fleet-state rows: worker name, routable, breaker
        state, consecutive failures, in-flight count."""
        with self._lock:
            workers = list(self._workers.values())
        return [{"worker": w.name, "routable": w.routable,
                 "breaker": w.breaker, "active": w.active,
                 "alive": not w.dead, "consecutive": w.consecutive,
                 "inflight": w.inflight}
                for w in workers]

    def close(self, retire_workers: bool = True,
              grace_s: float = 15.0) -> None:
        """Stop supervision and the client pool; with
        ``retire_workers``, SIGTERM every owned process and reap it
        (escalating to SIGKILL past ``grace_s``)."""
        self._stop_evt.set()
        if self._monitor.is_alive():
            self._monitor.join(timeout=10.0)
        self._pool.shutdown(wait=True)
        blackbox.unregister_provider(self._bb_name)
        if not retire_workers:
            return
        with self._lock:
            workers = list(self._workers.values())
        for w in workers:
            if w.proc is not None and w.proc.poll() is None:
                w.proc.terminate()
        deadline = time.monotonic() + grace_s
        for w in workers:
            if w.proc is None:
                continue
            while w.proc.poll() is None and time.monotonic() < deadline:
                time.sleep(0.05)
            if w.proc.poll() is None:
                w.proc.kill()

    def __enter__(self) -> "GlobalRouter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class WorkerSpawner:
    """Launcher integration: spawns ONE serving worker process per call
    (``python -m avenir_tpu_torch.serving --conf <props> --http-port 0
    -D …``) with its own journal-shard suffix (``w<k>``, through
    ``AVENIR_WRITER_SUFFIX``) and the fleet's shared ``trace.run.id`` — so
    every worker's shard lands in the SAME run and one merge holds the
    whole serving fleet.  ``device`` is passed on as the worker's
    ``--device`` (None: the worker's own default, ``cuda``).

    The worker binds an ephemeral port and prints it on its ``serving ...
    on http://host:port`` line; the spawner reads the address there (no
    port number is picked here and handed on), then blocks until the
    worker's ``/healthz`` answers ready (the router's health gate takes
    over from there).  ``command`` replaces ``python -m
    avenir_tpu_torch.serving`` at the head of the worker's command line;
    what follows it is the same."""

    def __init__(self, conf_path: str, run_id: str, *,
                 overrides: Optional[Dict[str, str]] = None,
                 env: Optional[Dict[str, str]] = None,
                 device: Optional[str] = None,
                 command: Optional[Sequence[str]] = None,
                 ready_timeout_s: float = 180.0,
                 echo: bool = True):
        self.conf_path = conf_path
        self.run_id = run_id
        self.overrides = dict(overrides or {})
        self.env = env
        self.device = device
        self.command = list(command or ())
        self.ready_timeout_s = float(ready_timeout_s)
        self.echo = echo
        self._index = itertools.count(0)
        self._lock = threading.Lock()

    def spawn(self) -> GlobalWorker:
        import os
        import subprocess
        import sys

        from avenir_tpu_torch.launch import ENV_SUFFIX

        with self._lock:
            k = next(self._index)
        name = f"w{k}"
        cmd = [*(self.command or [sys.executable, "-m",
                                  "avenir_tpu_torch.serving"]),
               "--conf", self.conf_path, "--http-port", "0",
               "-D", f"trace.run.id={self.run_id}"]
        if self.device:
            cmd += ["--device", self.device]
        for key, value in sorted(self.overrides.items()):
            cmd += ["-D", f"{key}={value}"]
        env = dict(os.environ if self.env is None else self.env)
        # the launcher's per-process shard contract: the worker adopts
        # AVENIR_WRITER_SUFFIX as trace.writer.suffix (spans.configure)
        env[ENV_SUFFIX] = name
        proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        bound: Dict[str, object] = {"event": threading.Event()}
        threading.Thread(target=self._pump, args=(name, proc, bound),
                         daemon=True, name=f"fleet-pump-{name}").start()
        deadline = time.monotonic() + self.ready_timeout_s
        try:
            host, port = self._wait_bound(name, proc, bound, deadline)
            worker = GlobalWorker(name, WorkerClient(host, port, name=name),
                                  proc=proc)
            self._wait_up(worker, deadline)
        except BaseException:
            # a worker that never came up is not left running
            if proc.poll() is None:
                proc.kill()
            raise
        return worker

    def _pump(self, name: str, proc, bound: Dict[str, object]) -> None:
        try:
            for line in proc.stdout:
                if "address" not in bound:
                    m = _BOUND_LINE.match(line)
                    if m:
                        bound["address"] = (m.group(1), int(m.group(2)))
                        bound["event"].set()
                if self.echo:
                    print(f"[{name}] {line}", end="", flush=True)
        # stdout relay only: the pipe breaking (worker SIGKILLed, fleet
        # teardown) is the expected end of this thread, and the monitor
        # journals the worker's death itself
        # graftlint: disable=GL012
        except Exception:                          # noqa: BLE001
            pass
        finally:
            bound["event"].set()

    def _wait_bound(self, name: str, proc, bound: Dict[str, object],
                    deadline: float):
        """The (host, port) of the worker's ``serving ... on
        http://host:port`` line; raises typed if the worker exits first or
        prints none by the deadline."""
        event = bound["event"]
        while not event.wait(0.2):
            if time.monotonic() >= deadline:
                raise WorkerDownError(
                    f"worker {name!r} printed no serving address within "
                    f"{self.ready_timeout_s:g}s", worker=name)
        if "address" not in bound:
            proc.wait(timeout=10.0)
            raise WorkerDownError(
                f"worker {name!r} exited {proc.returncode} during bring-up",
                worker=name)
        return bound["address"]

    def _wait_up(self, worker: GlobalWorker, deadline: float) -> None:
        """Poll the newborn's ``/healthz`` until it answers ready (model
        load + warmup come before the address line, so this is quick); a
        process that dies first raises typed."""
        while time.monotonic() < deadline:
            if worker.proc.poll() is not None:
                raise WorkerDownError(
                    f"worker {worker.name!r} exited "
                    f"{worker.proc.returncode} during bring-up",
                    worker=worker.name)
            try:
                worker.health = worker.client.healthz(timeout_s=2.0)
                if worker.health.get("ready"):
                    return
            except WorkerDownError:
                pass                      # not answering yet
            time.sleep(0.2)
        raise WorkerDownError(
            f"worker {worker.name!r} not ready within "
            f"{self.ready_timeout_s:g}s", worker=worker.name)


# the serving CLI's startup line (serving/__main__.py)
_BOUND_LINE = re.compile(r"^serving .* on http://([^\s:]+):(\d+) ")


def serve_fleet(conf_path: str, nprocs: int, *,
                http_port: Optional[int] = None,
                device: Optional[str] = None,
                command: Optional[Sequence[str]] = None,
                stop_event: Optional[threading.Event] = None,
                echo: bool = True) -> int:
    """The launcher's ``--serve`` mode body: bring up ``nprocs`` serving
    worker processes from ``conf_path`` (each on ``device``, started by
    ``command`` when given, see :class:`WorkerSpawner`), front them
    with a :class:`GlobalRouter` behind the standard HTTP frontend
    (``http_port``, else ``fleet.http.port``, default 8490; 0 binds an
    ephemeral port, which the startup line names), run until SIGTERM /
    Ctrl-C (or ``stop_event``), then tear the fleet down, sweep dead
    workers' forensics bundles, merge every shard — workers' ``w<k>``
    suffixes, tenant suffixes and the router's own ``router`` shard — into
    one ``fleet-<run>.jsonl`` and print the router's stats."""
    import signal

    from avenir_tpu_torch.device import resolve_device
    from avenir_tpu_torch.launch import merge_fleet_journal
    from avenir_tpu_torch.serving.frontend import ScoreHTTPServer
    from avenir_tpu_torch.telemetry.export import fleet_identity
    from avenir_tpu_torch.telemetry.slo import SloEvaluator
    from avenir_tpu_torch.tenancy.contract import split_contracts

    if nprocs < 1:
        raise ConfigError(f"--serve needs nprocs >= 1, got {nprocs}")
    # the workers' device, checked before any of them starts: without
    # CUDA and without "cpu" asked for this raises
    resolve_device(device)
    conf = JobConfig.from_file(conf_path)
    run_id = tel.fleet_run_id(conf)
    journal_dir = conf.get("trace.journal.dir") or "."
    # the router journals to its OWN shard of the same run: pin the
    # shared run id and a `router` writer suffix before configure
    router_conf = JobConfig(dict(conf.props), prefix=conf.prefix)
    router_conf.set("trace.run.id", run_id)
    if not router_conf.get("trace.writer.suffix"):
        router_conf.set("trace.writer.suffix", "router")
    tel.configure(router_conf)
    # global tenancy: each worker runs a 1/N split of the declared
    # contracts; the router keeps the full ones for door admission
    spawner = WorkerSpawner(conf_path, run_id,
                            overrides=split_contracts(conf, nprocs),
                            device=device, command=command, echo=echo)
    workers: List[GlobalWorker] = []
    try:
        for _ in range(nprocs):
            workers.append(spawner.spawn())
    except BaseException:
        for w in workers:
            w.proc.kill()
        raise
    router = GlobalRouter.from_conf(conf, workers=workers,
                                    spawner=spawner.spawn)
    port = (http_port if http_port is not None
            else conf.get_int("fleet.http.port", 8490))
    http = ScoreHTTPServer(
        router, port=port, slo=SloEvaluator.from_conf(conf),
        identity=fleet_identity(worker="router")).start()
    health = router.health()
    print(f"GlobalServe fronting {len(workers)} worker(s) "
          f"({health['models']}) on "
          f"http://{http.address[0]}:{http.address[1]}", flush=True)
    stop = stop_event if stop_event is not None else threading.Event()
    try:
        signal.signal(signal.SIGTERM, lambda *_: stop.set())
    except ValueError:                       # not the main thread
        pass
    try:
        stop.wait()
    except KeyboardInterrupt:
        pass
    finally:
        http.stop()
        router.close()
        tel.tracer().counters("fleet", router.counters)
        tel.tracer().disable()
        # finalize + journal dead workers' bundles BEFORE the merge, so
        # the merged fleet journal carries exactly one bundle.written per
        # dead worker (a SIGKILLed worker ran no hook — its live bundle is
        # all the evidence there is)
        bb_dir = conf.get("blackbox.dir")
        if bb_dir:
            for rec in blackbox.sweep(bb_dir, journal_dir=journal_dir,
                                      run_id=run_id):
                print(f"[fleet] blackbox bundle: {rec['dir']} "
                      f"({rec['reason']})", flush=True)
        merged = merge_fleet_journal(journal_dir, run_id=run_id)
        if merged:
            print(f"[fleet] merged journal: {merged}", flush=True)
        print(json.dumps(router.stats()), flush=True)
    return 0
