"""Transport front ends for the scoring plane — port of
``avenir_tpu/serving/frontend.py``.

Two transports, both stdlib-only:

- :class:`ScoreHTTPServer` — a ``http.server`` JSON endpoint
  (``POST /score`` with ``{"model": ..., "rows": [...]}``) plus health and
  stats endpoints.  Typed serving errors map to distinct HTTP statuses so a
  load balancer can tell shed (429) from overload timeout (504) from a bad
  request (400).
- :class:`QueueScoreFrontend` — a RESP-list transport over the same
  push/pop queue surface the RL serving loop uses (``pipeline/resp.py``'s
  ``RedisListQueue``, or the in-proc queue for tests): clients LPUSH
  ``requestId,model,<csv row>`` onto a request list and collect
  ``requestId,<response line>`` (or ``requestId,ERR,<code>,<message>``)
  from a response list.  The port runs it over in-process queues
  (``pipeline/streaming.py::InProcQueue``); its Redis wiring,
  :func:`redis_score_frontend`, needs the RESP client, which is not ported
  yet (ROADMAP.md, Queue 1 item 7h-ii), and raises.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Tuple

from avenir_tpu_torch.serving.batcher import (BucketedMicrobatcher,
                                              PendingRequest)
from avenir_tpu_torch.serving.errors import (
    ReplicaDownError,
    RequestError,
    RequestTimeout,
    ServingError,
    ShedError,
    UnknownModelError,
)

_HTTP_STATUS = {
    UnknownModelError: 404,
    ShedError: 429,
    RequestTimeout: 504,
    ReplicaDownError: 503,
    RequestError: 400,
}


def _status_for(err: ServingError) -> int:
    # MRO walk, not an exact-type lookup: subclassed typed errors (e.g.
    # the tenant-scoped TenantShedError) keep their base's transport
    # status — a shed is a 429 whoever shed it
    for klass in type(err).__mro__:
        if klass in _HTTP_STATUS:
            return _HTTP_STATUS[klass]
    return 500


def _error_body(err: ServingError) -> dict:
    """Typed error → JSON body, carrying the attribution the batcher
    stamps (which replica shed or timed out this request and how long it
    waited); a tenant-scoped shed also names the tenant, the quota that
    fired and the queue drain estimate."""
    body = {"error": err.code, "message": str(err)}
    replica = getattr(err, "replica", None)
    if replica:
        body["replica"] = replica
    wait_ms = getattr(err, "queue_wait_ms", None)
    if wait_ms is not None:
        body["queue_wait_ms"] = wait_ms
    tenant = getattr(err, "tenant", None)
    if tenant:
        body["tenant"] = tenant
    quota = getattr(err, "quota", None)
    if quota:
        body["quota"] = quota
    retry_after = getattr(err, "retry_after_s", None)
    if retry_after:
        body["retry_after_ms"] = round(float(retry_after) * 1e3, 1)
    return body


def _retry_after_header(err: ServingError) -> dict:
    """``Retry-After`` (integer seconds, HTTP semantics — rounded UP so
    an honest client never re-arrives early) for errors carrying a queue
    drain estimate; ``{}`` otherwise."""
    retry_after = getattr(err, "retry_after_s", None)
    if not retry_after:
        return {}
    return {"Retry-After": str(max(int(-(-float(retry_after) // 1)), 1))}


class ScoreHTTPServer:
    """Threaded HTTP front end over a :class:`BucketedMicrobatcher` or a
    :class:`~avenir_tpu_torch.serving.pool.ReplicaPool` (the same surface:
    submit/queue_depths/counters/latency/health).

    Concurrent POSTs are the microbatching win: each handler thread submits
    its rows and blocks, and the dispatcher folds every model's concurrent
    rows into one padded bucket.  Port 0 binds an ephemeral port;
    ``serve.http.port`` configures a fixed one.  ``device`` is where a
    ``/swap`` loads its incoming entry (``cuda`` unless the CPU is asked
    for).  The handlers are a class (:attr:`handler_class`), so they can
    be driven on in-memory streams without binding a socket
    (``bind=False``)."""

    def __init__(self, batcher: BucketedMicrobatcher,
                 host: str = "127.0.0.1", port: int = 0,
                 slo=None, identity=None, bind: bool = True, device=None):
        from avenir_tpu_torch.telemetry import spans as _tel
        from avenir_tpu_torch.telemetry.export import fleet_identity

        self.batcher = batcher
        self.device = device
        self.started = time.monotonic()
        # the scrape identity (process/replica labels on every /metrics
        # sample and /stats row) and an optional SLO evaluator rendering
        # avenir_slo_burn_rate gauges per scrape; the default identity
        # reuses the tracer's writer suffix, as the journal shard does
        self.identity = identity if identity is not None else fleet_identity(
            replica=_tel.tracer().writer_suffix or None,
            tenant=getattr(batcher, "tenant", "") or None)
        self.slo = slo
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):      # no per-request stderr spam
                pass

            def _send(self, status: int, payload: dict,
                      headers: Optional[dict] = None) -> None:
                self._send_text(status, json.dumps(payload),
                                "application/json", headers=headers)

            def _send_text(self, status: int, text: str,
                           content_type: str,
                           headers: Optional[dict] = None) -> None:
                body = text.encode()
                self.send_response(status)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                for name, value in (headers or {}).items():
                    self.send_header(name, value)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/metrics":
                    # Prometheus text of the counters /stats reports as
                    # JSON; under profile.on the device-memory gauges
                    # (avenir_device_bytes) ride the same page
                    from avenir_tpu_torch.telemetry import profile as _profile
                    from avenir_tpu_torch.telemetry.export import prometheus_text

                    depths = outer.batcher.queue_depths()
                    gauges = {f"serve.queue.{name}": float(depth)
                              for name, depth in depths.items()}
                    gauges["uptime.sec"] = time.monotonic() - outer.started
                    # a ReplicaPool adds its readiness and per-replica
                    # queue gauges to the same page
                    pool_gauges = getattr(outer.batcher, "gauges", None)
                    if callable(pool_gauges):
                        gauges.update(pool_gauges())
                    body = prometheus_text(
                        counters=outer.batcher.counters,
                        latency=outer.batcher.latency,
                        gauges=gauges,
                        device_bytes=_profile.profiler().gauges(),
                        labels=outer.identity)
                    if outer.slo is not None:
                        # scrape-time SLO evaluation: burn-rate gauges on
                        # the same page, slo.violation journaled on each
                        # rule's transition into violation
                        rows = outer.slo.evaluate_live(
                            outer.batcher.counters, outer.batcher.latency,
                            depths, gauges=gauges)
                        slo_lines = []
                        outer.slo.render_prometheus(rows, slo_lines,
                                                    labels=outer.identity)
                        body += "\n".join(slo_lines) + "\n"
                    self._send_text(
                        200, body,
                        "text/plain; version=0.0.4; charset=utf-8")
                elif self.path == "/healthz":
                    # readiness probe: 503 until every model is loaded and
                    # its (model, bucket) shapes are warmed; behind a
                    # ReplicaPool the aggregate (green iff one replica is
                    # ready) plus one row per replica
                    body = outer.batcher.health()
                    body["uptime_sec"] = round(
                        time.monotonic() - outer.started, 3)
                    ready = bool(body.get("ready"))
                    self._send(200 if ready else 503, body)
                elif self.path == "/stats":
                    self._send(200,
                               outer.batcher.stats(identity=outer.identity))
                else:
                    self._send(404, {"error": "NOT_FOUND",
                                     "message": self.path})

            def do_POST(self):
                if self.path == "/swap":
                    self._do_swap()
                    return
                if self.path != "/score":
                    self._send(404, {"error": "NOT_FOUND",
                                     "message": self.path})
                    return
                try:
                    length = int(self.headers.get("Content-Length", "0"))
                    req = json.loads(self.rfile.read(length) or b"{}")
                    model = req["model"]
                    rows = req["rows"]
                    if isinstance(rows, str):
                        rows = [rows]
                    # a caller may pin each row's request id and the
                    # submitter's tenant label
                    rids = req.get("rids")
                    tenant = req.get("tenant")
                    if rids is not None and (
                            not isinstance(rids, list)
                            or len(rids) != len(rows)):
                        raise ValueError(
                            f"rids must be a list of len(rows)="
                            f"{len(rows)} request ids")
                except (ValueError, KeyError, TypeError) as exc:
                    self._send(400, {
                        "error": "BAD_REQUEST",
                        "message": f"body must be JSON "
                                   f'{{"model": ..., "rows": [...]}}: {exc}'})
                    return
                try:
                    results = outer.score_rows(model, rows, rids=rids,
                                               tenant=tenant)
                except ServingError as err:
                    self._send(_status_for(err), _error_body(err),
                               headers=_retry_after_header(err))
                    return
                self._send(200, {"model": model, "results": results})

            def _do_swap(self):
                # build the incoming entry from the posted props and run
                # the batcher's (or the pool's rolling) swap barrier
                try:
                    length = int(self.headers.get("Content-Length", "0"))
                    req = json.loads(self.rfile.read(length) or b"{}")
                    model = req["model"]
                    props = req.get("props") or {}
                    warm = bool(req.get("warm", True))
                    if not isinstance(props, dict):
                        raise ValueError("props must be an object")
                except (ValueError, KeyError, TypeError) as exc:
                    self._send(400, {
                        "error": "BAD_REQUEST",
                        "message": f"body must be JSON "
                                   f'{{"model": ..., "props": {{...}}}}: '
                                   f"{exc}"})
                    return
                try:
                    doc = outer.swap_model(model, props, warm=warm)
                except ServingError as err:
                    self._send(_status_for(err), _error_body(err),
                               headers=_retry_after_header(err))
                    return
                self._send(200, doc)

        self.handler_class = _Handler
        self._httpd = None
        if bind:
            self._httpd = ThreadingHTTPServer((host, port), _Handler)
            self._httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    def score_rows(self, model: str, rows: List[str],
                   rids: Optional[List[str]] = None,
                   tenant: Optional[str] = None) -> List[str]:
        """Submit all rows (they microbatch together), wait for all.  The
        first typed error aborts the call; rows already queued behind it
        still score and are discarded — shed/timeout accounting stays
        truthful either way.  ``rids`` pins each row's request id (else
        the plane assigns its own); ``tenant`` scopes the submits under
        that tenant label, so span attribution sees the submitter's
        tenant."""
        import contextlib

        from avenir_tpu_torch.telemetry import spans as _tel

        if rids is not None and len(rids) != len(rows):
            raise RequestError(
                f"rids must pair 1:1 with rows ({len(rids)} != {len(rows)})")
        scope = (_tel.label_scope(tenant=tenant) if tenant
                 else contextlib.nullcontext())
        with scope:
            pending: List[PendingRequest] = [
                self.batcher.submit_nowait(
                    model, row, rid=rids[i] if rids else None)
                for i, row in enumerate(rows)]
        return [p.wait(self.batcher.request_timeout_s + 30.0)
                for p in pending]

    def swap_model(self, model: str, props: dict,
                   warm: bool = True) -> dict:
        """``POST /swap`` body: build the incoming entry from ``props``
        (the posted keys are a self-contained job conf for the model's
        family loader) and hand it to the serving plane's swap barrier —
        a plain batcher warms-then-publishes, a ReplicaPool rolls replica
        by replica.  Returns the new version (for a pool: the slowest
        replica's, so the rollout is done when ``version`` moved).  The
        entry loads onto the server's ``device``.  (The JAX package also
        hands the props to a multi-process router's fleet swap,
        ROADMAP.md, Queue 1 item 7h-ii.)"""
        from avenir_tpu_torch.core.config import ConfigError, JobConfig
        from avenir_tpu_torch.serving.registry import FAMILIES

        loader = FAMILIES.get(model)
        if loader is None:
            raise UnknownModelError(
                f"unknown serving family {model!r} "
                f"(known: {sorted(FAMILIES)})")
        try:
            entry = loader.from_conf(JobConfig(dict(props)),
                                     device=self.device)
        except ConfigError as exc:
            raise RequestError(
                f"swap props for {model!r} rejected: {exc}") from exc
        result = self.batcher.swap(model, entry, warm=warm)
        if isinstance(result, dict):
            version = min(result.values()) if result else None
            return {"model": model, "version": version,
                    "versions": result}
        return {"model": model, "version": result}

    @property
    def address(self) -> Tuple[str, int]:
        return self._httpd.server_address[:2]

    def start(self) -> "ScoreHTTPServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="serve-http")
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10.0)

    def __enter__(self) -> "ScoreHTTPServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


class QueueScoreFrontend:
    """RESP-list (or in-proc queue) front end.

    ``requests``/``responses`` are any objects with the ``push``/``drain``
    queue surface (``pipeline/resp.py::RedisListQueue``,
    ``pipeline/streaming.py::InProcQueue``).  Message contract:

    - request:  ``<requestId>,<model>,<csv row>``  (split on the first two
      delimiters only — the payload keeps its own delimiters)
    - response: ``<requestId>,<response line>`` on success,
      ``<requestId>,ERR,<code>,<message>`` on a typed failure.

    Every wait for a response has the batcher's request timeout plus 30 s
    as its deadline."""

    def __init__(self, batcher: BucketedMicrobatcher, requests, responses,
                 delim: str = ","):
        self.batcher = batcher
        self.requests = requests
        self.responses = responses
        self.delim = delim

    def _fail(self, rid: str, err: ServingError) -> None:
        msg = str(err).replace("\n", " ").replace(self.delim, ";")
        self.responses.push(
            self.delim.join([rid, "ERR", err.code, msg]))

    def poll_once(self) -> int:
        """Drain the request list, submit everything (so concurrent clients
        microbatch), then push responses; returns messages consumed."""
        msgs = self.requests.drain()
        pending: List[Tuple[str, PendingRequest]] = []
        for msg in msgs:
            parts = msg.split(self.delim, 2)
            if len(parts) != 3:
                self._fail(msg, RequestError(
                    "request must be 'requestId,model,<csv row>'"))
                continue
            rid, model, payload = parts
            try:
                pending.append((rid, self.batcher.submit_nowait(model,
                                                                payload)))
            except ServingError as err:
                self._fail(rid, err)
        for rid, req in pending:
            try:
                out = req.wait(self.batcher.request_timeout_s + 30.0)
            except ServingError as err:
                self._fail(rid, err)
                continue
            self.responses.push(f"{rid}{self.delim}{out}")
        return len(msgs)

    def run(self, max_messages: Optional[int] = None,
            idle_sleep_s: float = 0.005,
            idle_limit_s: Optional[float] = None) -> int:
        """Poll until ``max_messages`` are served, or the request list stays
        empty for ``idle_limit_s`` (None = poll forever)."""
        served = 0
        idle_since = time.monotonic()
        while max_messages is None or served < max_messages:
            n = self.poll_once()
            if n:
                served += n
                idle_since = time.monotonic()
                continue
            if idle_limit_s is not None and \
                    time.monotonic() - idle_since >= idle_limit_s:
                break
            time.sleep(idle_sleep_s)
        return served


def redis_score_frontend(batcher: BucketedMicrobatcher,
                         host: str = "localhost", port: int = 6379,
                         db: int = 0,
                         request_queue: str = "scoreRequestQueue",
                         response_queue: str = "scoreResponseQueue",
                         ) -> QueueScoreFrontend:
    """The Redis wiring of :class:`QueueScoreFrontend`.  The RESP client
    (``pipeline/resp.py``) is not ported yet, so this raises before any
    connection, as the RL loop's Redis transports do."""
    from avenir_tpu_torch.pipeline.streaming import _refuse_redis

    _refuse_redis("redis_score_frontend")
