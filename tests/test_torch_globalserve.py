"""The port's serving fleet (``serving/global_pool.py``) held against
``avenir_tpu`` on the CPU.

In-process, over real HTTP (each worker a port batcher behind a port
``ScoreHTTPServer`` bound on port 0): health-gated least-load routing, the
worker breaker and its half-open probe, typed error mapping across the
hop, the tenant quota at the router door, the rolling fleet swap holding
the ready floor (also through ``POST /swap`` to the router), autoscale
replacement, the aggregate ``/healthz`` / ``/metrics`` / ``/stats``, and
``from_conf``, ``health()`` and ``stats()`` equal to the JAX package's
router over the same workers.  A worker that must fail at the transport
sits behind a port-0 TCP relay the test holds, switched between
forwarding and resetting every connection; no test binds or dials a port
it does not hold.

Two subprocess gates: real port serving workers from the
:class:`WorkerSpawner` (``--device cpu --http-port 0``, the address read
from each worker's startup line), ``w0`` armed to die on its first
dispatch — every answer byte-identical to the one-process oracle and to
the JAX package's plane, no attempt scored twice in the merged journal —
and one ``serve_fleet`` run, the body of ``launch --serve``.
"""

import json
import os
import socket
import struct
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

torch = pytest.importorskip("torch")

from avenir_tpu.core.config import JobConfig as JConf  # noqa: E402
from avenir_tpu.core.csv_io import write_csv  # noqa: E402
from avenir_tpu.datagen.churn import CHURN_SCHEMA_JSON, generate_churn  # noqa: E402
from avenir_tpu.jobs import get_job as jget_job  # noqa: E402
from avenir_tpu.serving import BucketedMicrobatcher as JBatcher  # noqa: E402
from avenir_tpu.serving import ModelRegistry as JRegistry  # noqa: E402
from avenir_tpu.serving import global_pool as jgp  # noqa: E402
from avenir_tpu_torch.core.config import JobConfig  # noqa: E402
from avenir_tpu_torch.jobs.base import read_lines  # noqa: E402
from avenir_tpu_torch.serving import (BucketedMicrobatcher,  # noqa: E402
                                      ModelRegistry, ScoreHTTPServer,
                                      ServableModel, ShedError)
from avenir_tpu_torch.serving import global_pool as gp  # noqa: E402
from avenir_tpu_torch.serving.errors import (  # noqa: E402
    RequestError, TenantShedError, UnknownModelError, WorkerDownError)
from avenir_tpu_torch.serving.global_pool import (  # noqa: E402
    CLOSED, OPEN, GlobalRouter, GlobalWorker, WorkerClient, WorkerSpawner)
from avenir_tpu_torch.telemetry import spans as tel  # noqa: E402
from avenir_tpu_torch.telemetry.export import fleet_identity  # noqa: E402
from avenir_tpu_torch.telemetry.journal import read_events  # noqa: E402
from avenir_tpu_torch.tenancy.contract import TenantContract  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 60.0


# ---------------------------------------------------------------------------
# fixtures: NB artifacts trained by the JAX package, an echo family, a relay
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_globalserve")
    j = lambda *p: str(root.joinpath(*p))  # noqa: E731
    rows = generate_churn(400, seed=7)
    write_csv(j("train.csv"), rows[:320])
    write_csv(j("test.csv"), rows[320:])
    write_csv(j("train2.csv"), generate_churn(300, seed=23))
    root.joinpath("churn.json").write_text(json.dumps(CHURN_SCHEMA_JSON))
    churn = {"feature.schema.file.path": j("churn.json")}
    jget_job("BayesianDistribution").run(JConf(dict(churn)), j("train.csv"),
                                         j("nb_model"))
    jget_job("BayesianDistribution").run(JConf(dict(churn)), j("train2.csv"),
                                         j("nb_model_v2"))
    return {"j": j, "churn": churn}


def nb_props(ws, model="nb_model"):
    return {**ws["churn"], "bayesian.model.file.path": ws["j"](model),
            "serve.models": "naiveBayes", "serve.bucket.sizes": "1,4",
            "serve.flush.deadline.ms": "5"}


def oracles(props, lines):
    """(port, JAX) one-process batcher responses to ``lines``."""
    conf = JobConfig(dict(props))
    b = BucketedMicrobatcher.from_conf(
        ModelRegistry.from_conf(conf, device="cpu"), conf)
    try:
        port = [b.submit("naiveBayes", ln, timeout_s=WAIT_S) for ln in lines]
    finally:
        b.close()
    jconf = JConf(dict(props))
    jb = JBatcher.from_conf(JRegistry.from_conf(jconf), jconf)
    try:
        jax = [jb.submit("naiveBayes", ln, timeout_s=WAIT_S) for ln in lines]
    finally:
        jb.close()
    return port, jax


class EchoServable(ServableModel):
    """Instant scoring (``<line>,<tag>``), with an optional delay a call
    (holds a request in flight for the quota test)."""

    family = "echo"

    def __init__(self, tag="v1", delay_s=0.0):
        super().__init__()
        self.tag = tag
        self.delay_s = delay_s

    def score_lines(self, lines, pad_to):
        self.compile_keys.add((pad_to,))
        if self.delay_s:
            time.sleep(self.delay_s)
        return [f"{line},{self.tag}" for line in lines]

    def warmup(self, pad_to):
        self.compile_keys.add((pad_to,))


def _front(batcher, name):
    srv = ScoreHTTPServer(batcher, device="cpu").start()
    host, port = srv.address
    return srv, batcher, GlobalWorker(name, WorkerClient(host, port,
                                                         name=name))


def echo_worker(name, tag="v1", delay_s=0.0, relay=False):
    """One in-process worker: a port batcher behind a port HTTP server on
    port 0, optionally reached through a :class:`Relay`."""
    conf = JobConfig({"serve.bucket.sizes": "1,4",
                      "serve.flush.deadline.ms": "5"})
    registry = ModelRegistry().add("echo", EchoServable(tag, delay_s))
    batcher = BucketedMicrobatcher.from_conf(registry, conf)
    srv = ScoreHTTPServer(batcher).start()
    via = Relay(srv.address) if relay else None
    host, port = (via or srv).address
    worker = GlobalWorker(name, WorkerClient(host, port, name=name))
    return srv, batcher, worker, via


def nb_worker(name, ws, model="nb_model"):
    conf = JobConfig(nb_props(ws, model))
    batcher = BucketedMicrobatcher.from_conf(
        ModelRegistry.from_conf(conf, device="cpu"), conf)
    return _front(batcher, name)


class Relay:
    """A TCP relay on port 0, held by the test, in front of a worker's
    address: ``mode`` "forward" pipes each connection through, "reset"
    answers each with a reset — a worker whose process is gone, without
    freeing or re-binding any port."""

    def __init__(self, target):
        self.target = target
        self.mode = "forward"
        self._lsock = socket.socket()
        self._lsock.bind(("127.0.0.1", 0))
        self._lsock.listen(16)
        self.address = self._lsock.getsockname()[:2]
        threading.Thread(target=self._accept, daemon=True,
                         name="test-relay").start()

    def _accept(self):
        while True:
            try:
                conn, _ = self._lsock.accept()
            except OSError:
                return                       # closed
            if self.mode == "reset":
                conn.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                                struct.pack("ii", 1, 0))
                conn.close()
                continue
            try:
                up = socket.create_connection(self.target, timeout=10)
            except OSError:
                conn.close()
                continue
            for src, dst in ((conn, up), (up, conn)):
                threading.Thread(target=self._pipe, args=(src, dst),
                                 daemon=True).start()

    @staticmethod
    def _pipe(src, dst):
        try:
            while True:
                data = src.recv(65536)
                if not data:
                    break
                dst.sendall(data)
        except OSError:
            pass
        finally:
            try:
                dst.shutdown(socket.SHUT_WR)
            except OSError:
                pass
            src.close()

    def close(self):
        self._lsock.close()


@pytest.fixture
def traced(tmp_path):
    tracer = tel.tracer().enable(str(tmp_path))
    try:
        yield tracer
    finally:
        tel.tracer().disable()


def _http(base, path, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(base + path, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=WAIT_S) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as err:
        return err.code, err.read()


def _close(*items):
    """Stop servers, close everything else (routers, batchers, relays)."""
    for item in items:
        (item.stop if isinstance(item, ScoreHTTPServer) else item.close)()


# ---------------------------------------------------------------------------
# routing, the health gate, the front end's surfaces
# ---------------------------------------------------------------------------

def test_router_routes_scores_and_aggregates_health():
    s0, b0, w0, _ = echo_worker("w0")
    s1, b1, w1, _ = echo_worker("w1")
    router = GlobalRouter([w0, w1], start_monitor=False)
    try:
        assert router.ready
        assert router.submit("echo", "a,b") == "a,b,v1"
        with ScoreHTTPServer(router,
                             identity=fleet_identity(worker="router")) as srv:
            base = "http://%s:%d" % srv.address
            status, body = _http(base, "/score",
                                 {"model": "echo", "rows": ["x,y", "p,q"]})
            assert status == 200
            assert json.loads(body)["results"] == ["x,y,v1", "p,q,v1"]
            status, body = _http(base, "/healthz")
            hz = json.loads(body)
            assert status == 200 and hz["ready"] is True
            rows = {r["worker"]: r for r in hz["workers"]}
            assert set(rows) == {"w0", "w1"}
            assert all(r["ready"] and r["breaker"] == CLOSED
                       for r in rows.values())
            assert hz["queue"]["echo"]["cap"] == 2 * b0.queue_depth
            status, body = _http(base, "/metrics")
            assert status == 200 and b'worker="router"' in body
            status, body = _http(base, "/stats")
            st = json.loads(body)
            assert st["fleet"]["workers"] == 2 and st["fleet"]["ready"] == 2
            assert st["echo"]["requests"] == 3
    finally:
        _close(router, s0, b0, s1, b1)


def test_health_and_stats_equal_jax_router():
    """The JAX package's router and the port's, each fronting the same two
    port workers and given the same requests, report the same fleet."""
    s0, b0, w0, _ = echo_worker("w0")
    s1, b1, w1, _ = echo_worker("w1")
    b0.mark_failed()                     # w0's plane is down: gated out
    routers = {
        "torch": GlobalRouter([GlobalWorker("w0", w0.client),
                               GlobalWorker("w1", w1.client)],
                              start_monitor=False),
        "jax": jgp.GlobalRouter(
            [jgp.GlobalWorker("w0", jgp.WorkerClient(*w0.client.url[7:]
                                                     .split(":"), name="w0")),
             jgp.GlobalWorker("w1", jgp.WorkerClient(*w1.client.url[7:]
                                                     .split(":"), name="w1"))],
            start_monitor=False)}
    try:
        got = {}
        for name, router in routers.items():
            outs = [router.submit("echo", f"r{i},x") for i in range(5)]
            router.monitor_once()
            stats = router.stats()
            got[name] = (outs, router.health(), stats["fleet"],
                         {k: v for k, v in stats["echo"].items()
                          if not k.endswith("_ms") and not k.endswith("_us")},
                         router.gauges(), router.queue_depths(),
                         router.buckets, router.ready,
                         router._blackbox_state())
        assert got["torch"] == got["jax"]
        assert got["torch"][0] == [f"r{i},x,v1" for i in range(5)]
        assert [r["ready"] for r in got["torch"][1]["workers"]] == \
            [False, True]
    finally:
        _close(*routers.values(), s0, b0, s1, b1)


def test_health_gate_excludes_unready_worker():
    s0, b0, w0, _ = echo_worker("w0")
    s1, b1, w1, _ = echo_worker("w1")
    router = GlobalRouter([w0, w1], start_monitor=False)
    try:
        b0.mark_failed()
        router.monitor_once()
        assert not w0.routable and w1.routable and router.ready
        for i in range(4):
            assert router.submit("echo", f"r{i},x") == f"r{i},x,v1"
        health = router.health()
        rows = {r["worker"]: r["ready"] for r in health["workers"]}
        assert rows == {"w0": False, "w1": True} and health["ready"]
        assert b1.counters.get("Serving.echo", "requests") == 4
    finally:
        _close(router, s0, b0, s1, b1)


def test_least_load_prefers_shallower_worker():
    s0, b0, w0, _ = echo_worker("w0")
    s1, b1, w1, _ = echo_worker("w1")
    router = GlobalRouter([w0, w1], start_monitor=False)
    try:
        assert router._choose().name == "w0"     # a tie: insertion order
        with router._lock:
            w0.inflight = 5                      # deeper by the router's count
        assert router._choose().name == "w1"
        with router._lock:
            w0.inflight = 0
            # deeper by the worker's own queue (the health feed)
            w1.health = {**w1.health,
                         "queue": {"echo": {"depth": 3, "cap": 8}}}
        assert w1.depth() == 3 and router._choose().name == "w0"
        assert router._choose(exclude={"w0"}).name == "w1"
    finally:
        _close(router, s0, b0, s1, b1)


# ---------------------------------------------------------------------------
# typed errors across the HTTP hop; the breaker's life
# ---------------------------------------------------------------------------

ERROR_CASES = {
    "down 503": (503, {"error": "REPLICA_DOWN", "message": "died"}),
    "worker down": (500, {"error": "WORKER_DOWN", "message": "gone"}),
    "unknown": (404, {"error": "UNKNOWN_MODEL", "message": "no such"}),
    "shed": (429, {"error": "SHED", "message": "full"}),
    "tenant shed": (429, {"error": "TENANT_SHED", "message": "quota",
                          "tenant": "alpha", "quota": "max.inflight",
                          "retry_after_ms": 250.0}),
    "timeout": (504, {"error": "TIMEOUT", "message": "late"}),
    "bad request": (400, {"error": "BAD_REQUEST", "message": "rows"}),
    "other": (500, {}),
}


@pytest.mark.parametrize("case", sorted(ERROR_CASES))
def test_typed_error_mapping_equals_jax(case):
    status, doc = ERROR_CASES[case]
    got = WorkerClient("127.0.0.1", 1, name="w0")._typed_error(status, doc)
    want = jgp.WorkerClient("127.0.0.1", 1, name="w0")._typed_error(status,
                                                                     doc)
    assert type(got).__name__ == type(want).__name__
    assert str(got) == str(want) and got.code == want.code
    for attr in ("worker", "tenant", "quota", "retry_after_s"):
        assert getattr(got, attr, None) == getattr(want, attr, None)


def test_client_maps_worker_errors_to_typed_exceptions():
    s0, b0, w0, relay = echo_worker("w0", relay=True)
    client = w0.client
    try:
        with pytest.raises(UnknownModelError):
            client.score("nosuch", ["a,b"])
        with pytest.raises(RequestError):
            client._request("POST", "/score", {"rows": ["a,b"]}, None)
        assert client.healthz()["ready"] is True
        assert client.score("echo", ["a,b"], rids=["g9.a0"]) == ["a,b,v1"]
        # the worker unreachable: a transport failure, retryable
        relay.mode = "reset"
        with pytest.raises(WorkerDownError) as ei:
            client.score("echo", ["a,b"], timeout_s=2.0)
        assert ei.value.worker == "w0"
        with pytest.raises(WorkerDownError):
            client.healthz(timeout_s=2.0)
    finally:
        _close(relay, s0, b0)


def test_breaker_trips_on_transport_failures_and_halfopen_recovers(traced):
    s0, b0, w0, relay = echo_worker("w0", relay=True)
    router = GlobalRouter([w0], breaker_failures=2, halfopen_ms=400.0,
                          start_monitor=False)
    try:
        relay.mode = "reset"             # the process is gone, not the port
        router.monitor_once()
        assert w0.breaker == CLOSED and w0.consecutive == 1
        router.monitor_once()
        assert w0.breaker == OPEN and not w0.routable
        with pytest.raises(ShedError):
            router.submit_nowait("echo", "a,b")
        relay.mode = "forward"           # it answers again
        router.monitor_once()            # inside the half-open window
        assert w0.breaker == OPEN
        time.sleep(0.45)
        router.monitor_once()
        assert w0.breaker == CLOSED and w0.routable
        assert router.submit("echo", "z,z") == "z,z,v1"
        fleet = router.stats()["fleet"]
        assert fleet["breaker.trips"] == 1 and fleet["breaker.closes"] == 1
        assert fleet["no.ready"] == 1
    finally:
        _close(router, relay, s0, b0)
    events = [e for e in read_events(traced.journal_path)
              if e["ev"].startswith("fleet.pool.worker")]
    assert [(e["ev"], e["reason"]) for e in events] == [
        ("fleet.pool.worker.down", "breaker"),
        ("fleet.pool.worker.up", "probe")]


def test_failover_to_a_survivor_under_attempt_rids(traced):
    """A request whose worker resets is re-sent to the other worker under
    ``<rid>.a1``; with the retries spent it is shed, typed."""
    s0, b0, w0, relay = echo_worker("w0", relay=True)
    s1, b1, w1, _ = echo_worker("w1")
    router = GlobalRouter([w0, w1], failover_retries=1, breaker_failures=5,
                          start_monitor=False)
    try:
        relay.mode = "reset"
        assert router.submit("echo", "a,b") == "a,b,v1"   # w0 first: a tie
        fleet = router.stats()["fleet"]
        assert fleet["failovers"] == 1
        b1.mark_failed()                 # now both fail: 503, then reset
        router.monitor_once()
        with router._lock:
            w1.health = {"ready": True}  # keep w1 routable to force a 503
        with pytest.raises(ShedError, match="exhausted"):
            router.submit("echo", "c,d")
        assert router.stats()["fleet"]["failover.exhausted"] == 1
    finally:
        _close(router, relay, s0, b0, s1, b1)
    hops = [e for e in read_events(traced.journal_path)
            if e["ev"] == "fleet.pool.failover"]
    assert hops[0]["rid"] == "g1" and hops[0]["from"] == "w0" and \
        hops[0]["to"] == "w1" and hops[0]["attempt"] == 1


# ---------------------------------------------------------------------------
# the fleet-wide tenant quota at the router door
# ---------------------------------------------------------------------------

def test_global_tenant_quota_sheds_at_router_door(traced):
    s0, b0, w0, _ = echo_worker("w0", delay_s=0.3)
    contracts = {"alpha": TenantContract(tenant="alpha", share=3.0,
                                         max_inflight=1)}
    router = GlobalRouter([w0], contracts=contracts, start_monitor=False)
    try:
        with tel.label_scope(tenant="alpha"):
            held = router.submit_nowait("echo", "a,b")   # takes the quota
            with pytest.raises(TenantShedError) as ei:
                router.submit_nowait("echo", "c,d")
        assert ei.value.tenant == "alpha"
        assert ei.value.quota == "fleet.max.inflight"
        assert held.wait(10.0) == "a,b,v1"
        with tel.label_scope(tenant="alpha"):
            assert router.submit("echo", "e,f") == "e,f,v1"
        with tel.label_scope(tenant="beta"):             # uncontracted
            assert router.submit("echo", "g,h") == "g,h,v1"
        assert router.counters.get("Tenant.alpha", "shed") == 1
        assert router._tenant_inflight == {}
    finally:
        _close(router, s0, b0)
    sheds = [e for e in read_events(traced.journal_path)
             if e["ev"] == "tenant.shed"]
    assert [(e["tenant"], e["quota"]) for e in sheds] == \
        [("alpha", "fleet.max.inflight")]


# ---------------------------------------------------------------------------
# the rolling fleet swap (ready floor) and process autoscale replacement
# ---------------------------------------------------------------------------

def test_swap_fleet_rolls_every_worker_and_holds_floor(ws, traced):
    s0, b0, w0 = nb_worker("w0", ws)
    s1, b1, w1 = nb_worker("w1", ws)
    router = GlobalRouter([w0, w1], swap_floor=1, start_monitor=False)
    lines = read_lines(ws["j"]("test.csv"))[:4]
    try:
        v1, jv1 = oracles(nb_props(ws), lines)
        assert [router.submit("naiveBayes", ln) for ln in lines] == v1 == jv1
        v2_props = {**ws["churn"],
                    "bayesian.model.file.path": ws["j"]("nb_model_v2")}
        result = router.swap_fleet("naiveBayes", v2_props)
        assert result["versions"] == {"w0": 2, "w1": 2}
        assert result["min_ready"] >= result["floor"] == 1
        v2, jv2 = oracles(nb_props(ws, "nb_model_v2"), lines)
        assert v2 == jv2 and v2 != v1
        for w in (w0, w1):
            assert w.client.score("naiveBayes", lines) == v2
        # POST /swap to the router's front end is the rolling fleet swap
        with ScoreHTTPServer(router) as srv:
            status, body = _http("http://%s:%d" % srv.address, "/swap",
                                 {"model": "naiveBayes",
                                  "props": {**ws["churn"],
                                            "bayesian.model.file.path":
                                                ws["j"]("nb_model")}})
        doc = json.loads(body)
        assert status == 200 and doc["versions"] == {"w0": 3, "w1": 3}
        assert router.health()["versions"] == {"naiveBayes": 3}
        for w in (w0, w1):
            assert w.client.score("naiveBayes", lines) == v1
        # ready capacity never below the floor
        b0.mark_failed()
        b1.mark_failed()
        with pytest.raises(ShedError, match="below the swap floor"):
            router.swap_fleet("naiveBayes", v2_props, settle_timeout_s=0.2)
    finally:
        _close(router, s0, b0, s1, b1)
    swaps = [e for e in read_events(traced.journal_path)
             if e["ev"] == "fleet.pool.swap"]
    assert [e["worker"] for e in swaps] == ["w0", "w1", "w0", "w1"]
    assert all(e["ready"] >= e["floor"] for e in swaps)


def test_autoscale_replaces_worker_below_min(traced):
    s0, b0, w0, relay = echo_worker("w0", relay=True)
    s1, b1, w1, _ = echo_worker("w1")
    spawned = []

    def spawner():
        srv, batcher, worker, _ = echo_worker(f"w{2 + len(spawned)}", "v2")
        spawned.append((srv, batcher))
        return worker

    router = GlobalRouter([w0, w1], spawner=spawner, autoscale=True,
                          autoscale_min=2, autoscale_max=3,
                          breaker_failures=1, start_monitor=False)
    try:
        relay.mode = "reset"           # w0's process plane is gone
        router.monitor_once()          # breaker opens -> ready < min
        router.autoscale_once()        # -> a replacement spawn (async)
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and (not spawned or
                                               router._spawning):
            time.sleep(0.05)
        assert spawned, "the autoscaler never spawned the replacement"
        stats = router.stats()["fleet"]
        assert stats["ready"] == 2 and stats.get("workers.spawned") == 1
        assert stats.get("scale.up") == 1
        # the replacement serves: w1 busy, the newcomer takes the request
        with router._lock:
            w1.inflight = 9
        assert router.submit("echo", "a,b") == "a,b,v2"
    finally:
        _close(router, relay, s1, b1, b0, s0)
        for srv, batcher in spawned:
            _close(srv, batcher)
    events = read_events(traced.journal_path)
    scales = [e for e in events if e["ev"] == "fleet.pool.scale"]
    assert [(e["direction"], e["reason"]) for e in scales] == \
        [("up", "replace")]
    ups = [e for e in events if e["ev"] == "fleet.pool.worker.up"]
    assert [(e["worker"], e["reason"]) for e in ups] == [("w2", "replace")]


FLEET_CONF = {
    "fleet.pool.breaker.failures": "4", "fleet.pool.heartbeat.ms": "800",
    "fleet.pool.breaker.halfopen.ms": "300",
    "fleet.pool.failover.retries": "2",
    "fleet.pool.monitor.interval.ms": "70",
    "serve.request.timeout.ms": "2500", "fleet.pool.client.threads": "3",
    "fleet.pool.autoscale.on": "true", "fleet.pool.autoscale.min": "2",
    "fleet.pool.autoscale.max": "5", "fleet.pool.autoscale.up.burn": "2.5",
    "fleet.pool.autoscale.down.burn": "0.1",
    "fleet.pool.autoscale.queue.frac": "0.75",
    "fleet.pool.autoscale.interval.sec": "3",
    "fleet.pool.swap.floor": "2",
    "tenant.alpha.share": "3", "tenant.alpha.max.inflight": "7",
    "tenant.beta.share": "1", "tenant.beta.queue.depth": "5",
    "slo.p99.metric": "p99.latency.ms", "slo.p99.target": "250",
}


@pytest.mark.parametrize("props", [{}, FLEET_CONF], ids=["defaults", "all"])
def test_from_conf_reads_every_fleet_pool_key_like_jax(props):
    import dataclasses

    got = GlobalRouter.from_conf(JobConfig(dict(props)), start_monitor=False)
    want = jgp.GlobalRouter.from_conf(JConf(dict(props)),
                                      start_monitor=False)
    try:
        for attr in ("breaker_failures", "heartbeat_s", "halfopen_s",
                     "failover_retries", "request_timeout_s", "autoscale",
                     "autoscale_min", "autoscale_max", "up_burn",
                     "down_burn", "queue_frac", "autoscale_interval_s",
                     "swap_floor", "monitor_interval_s"):
            assert getattr(got, attr) == getattr(want, attr), attr
        assert got._pool._max_workers == want._pool._max_workers
        assert {t: dataclasses.asdict(c) for t, c in got.contracts.items()} \
            == {t: dataclasses.asdict(c) for t, c in want.contracts.items()}
        assert (got.slo is None) == (want.slo is None)
        if got.slo is not None:
            assert [r.name for r in got.slo.rules] == \
                [r.name for r in want.slo.rules]
    finally:
        _close(got, want)


# ---------------------------------------------------------------------------
# the subprocess gates: real port serving workers
# ---------------------------------------------------------------------------

@pytest.fixture
def worker_env(monkeypatch):
    """The spawned workers import the port from this checkout, on one
    thread each."""
    monkeypatch.setenv("PYTHONPATH", REPO)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _scored_spans(path):
    """rid → serve.request span count of the router's rids (``g…``)."""
    out = {}
    for e in read_events(path):
        if e.get("ev") == "span.close" and e.get("name") == "serve.request":
            rid = (e.get("attrs") or {}).get("rid")
            if rid and rid.startswith("g"):
                out[rid] = out.get(rid, 0) + 1
    return out


def test_subprocess_failover_scores_byte_identical(ws, tmp_path, worker_env):
    """Two real port serving workers from the spawner; ``w0`` dies on its
    first dispatched batch (``fault.serve.dispatch.crash.after=1``: its
    plane answers 503, the vouch that the request never scored).  The
    router re-sends onto ``w1``; every answer equals the one-process
    oracle and the JAX package's plane byte for byte, and the merged
    journal shows the hop and no attempt scored twice."""
    from avenir_tpu_torch.launch import merge_fleet_journal

    d = str(tmp_path / "tel")
    props = {**nb_props(ws), "serve.request.timeout.ms": "10000",
             "trace.on": "true", "trace.journal.dir": d}
    conf_path = str(tmp_path / "serve.properties")
    with open(conf_path, "w") as fh:
        fh.write("".join(f"{k}={v}\n" for k, v in props.items()))
    spawner = WorkerSpawner(
        conf_path, "gserve", device="cpu", echo=False,
        overrides={"fault.serve.dispatch.crash.after": "1"})
    workers = []
    try:
        workers.append(spawner.spawn())
        spawner.overrides = {}
        workers.append(spawner.spawn())
        assert [w.name for w in workers] == ["w0", "w1"]
        assert all(w.client.port > 0 and w.proc.poll() is None
                   for w in workers)
        lines = read_lines(ws["j"]("test.csv"))[:6]
        want, jwant = oracles(nb_props(ws), lines)
        router = GlobalRouter(workers, failover_retries=1,
                              start_monitor=False)
        try:
            # w0 first (a tie): its first batch kills its plane, and the
            # router must rescue the request onto w1
            got = [router.submit("naiveBayes", ln, timeout_s=WAIT_S)
                   for ln in lines]
            assert router.counters.as_dict()["Fleet"]["failovers"] >= 1
        finally:
            router.close(retire_workers=True)
        assert got == want == jwant
        for w in workers:
            assert w.proc.wait(timeout=60) is not None
    finally:
        for w in workers:
            if w.proc.poll() is None:
                w.proc.kill()
                w.proc.wait()
    merged = merge_fleet_journal(d, run_id="gserve")
    assert merged is not None
    scored = _scored_spans(merged)
    assert scored and all(n == 1 for n in scored.values()), scored
    bases = {}
    for rid in scored:
        bases.setdefault(rid.rsplit(".a", 1)[0], []).append(rid)
    assert len(bases) == len(lines)
    assert any(r.endswith(".a1") for rids in bases.values() for r in rids)


def test_serve_fleet_launch_end_to_end(ws, tmp_path, worker_env,
                                       monkeypatch, capsys):
    """``launch --serve``'s body, ``serve_fleet``, with two port workers on
    the CPU and the router's front end on port 0: answers equal the
    oracle, ``/healthz`` aggregates both workers, ``/metrics`` carries
    ``worker="router"``, and on stop the merged fleet journal holds one
    ``serve.request`` span per router rid, the router's stats printed."""
    d = str(tmp_path / "tel")
    props = {**nb_props(ws), "trace.on": "true", "trace.journal.dir": d,
             "trace.run.id": "fleetrun", "tenant.alpha.share": "3",
             "tenant.alpha.max.inflight": "3"}
    conf_path = str(tmp_path / "serve.properties")
    with open(conf_path, "w") as fh:
        fh.write("".join(f"{k}={v}\n" for k, v in props.items()))
    fronts = []
    start = ScoreHTTPServer.start

    def record(self):
        fronts.append(self)
        return start(self)

    monkeypatch.setattr(ScoreHTTPServer, "start", record)
    stop = threading.Event()
    rc = {}
    fleet = threading.Thread(target=lambda: rc.setdefault(
        "rc", gp.serve_fleet(conf_path, 2, http_port=0, device="cpu",
                             stop_event=stop)), daemon=True)
    fleet.start()
    try:
        deadline = time.monotonic() + 240.0
        while not fronts and fleet.is_alive() and \
                time.monotonic() < deadline:
            time.sleep(0.1)
        assert fronts, "the router's front end never started"
        base = "http://%s:%d" % fronts[0].address
        lines = read_lines(ws["j"]("test.csv"))[:8]
        status, body = _http(base, "/score",
                             {"model": "naiveBayes", "rows": lines})
        assert status == 200
        assert json.loads(body)["results"] == oracles(nb_props(ws), lines)[0]
        status, body = _http(base, "/healthz")
        hz = json.loads(body)
        assert status == 200 and hz["ready"]
        assert [(r["worker"], r["ready"]) for r in hz["workers"]] == \
            [("w0", True), ("w1", True)]
        status, body = _http(base, "/metrics")
        assert status == 200 and b'worker="router"' in body
    finally:
        stop.set()
        fleet.join(timeout=120.0)
    assert not fleet.is_alive() and rc == {"rc": 0}
    out = capsys.readouterr().out
    assert "GlobalServe fronting 2 worker(s) (['naiveBayes']) on http://" \
        in out
    assert "[w0] serving ['naiveBayes'] on http://" in out
    merged = os.path.join(d, "fleet-fleetrun.jsonl")
    assert f"[fleet] merged journal: {merged}" in out
    stats = json.loads(out.strip().splitlines()[-1])
    assert stats["fleet"]["workers"] == 2
    assert stats["naiveBayes"]["requests"] == len(lines)
    scored = _scored_spans(merged)
    assert sorted(scored) == sorted(f"g{i}.a0"
                                    for i in range(1, len(lines) + 1))
    assert set(scored.values()) == {1}
    writers = {e.get("replica") for e in read_events(merged)}
    assert {"w0", "w1", "router"} <= writers


def test_spawner_command_heads_the_worker_command_line(tmp_path, capsys):
    """``command`` (``launch --serve ... -- <argv>``) takes the place of
    ``python -m avenir_tpu_torch.serving`` and the serving CLI's arguments
    follow it: a stand-in worker that prints its argv and shard suffix and
    exits fails the bring-up typed, having printed them."""
    conf_path = str(tmp_path / "serve.properties")
    open(conf_path, "w").close()
    probe = ("import os, sys; print('ARGV', sys.argv[1:], "
             "os.environ['AVENIR_WRITER_SUFFIX']); sys.exit(3)")
    spawner = WorkerSpawner(conf_path, "cmdrun", device="cpu",
                            overrides={"k": "v"},
                            command=[sys.executable, "-c", probe])
    with pytest.raises(WorkerDownError, match="exited 3 during bring-up"):
        spawner.spawn()
    argv = ["--conf", conf_path, "--http-port", "0", "-D",
            "trace.run.id=cmdrun", "--device", "cpu", "-D", "k=v"]
    assert f"[w0] ARGV {argv} w0\n" in capsys.readouterr().out
