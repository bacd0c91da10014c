"""The port's replica pool held against ``avenir_tpu`` on the CPU.

The heart is failover correctness: a replica killed mid-batch through the
conf-armed ``fault.serve.dispatch`` site has its in-flight requests
re-scored on a survivor byte for byte as the JAX package's single
batcher scores them, a request past ``pool.failover.retries`` sheds
typed, and the journal's per-rid ``serve.request`` spans show no request
lost or scored twice.  Around it: health-gated routing, the breaker and
its half-open probe, heartbeat detection of a wedged dispatcher, the
rolling swap, the autoscaler, the pool-mode ``/healthz`` ``/metrics``
``/stats`` (handlers on in-memory streams, never a socket), replica
attribution, and ``FaultPlan`` / ``HeartbeatMonitor`` against the JAX
package's.  Every wait has a timeout.
"""

import json
import time

import pytest

torch = pytest.importorskip("torch")

from avenir_tpu.core.config import JobConfig as JConf  # noqa: E402
from avenir_tpu.core.csv_io import write_csv  # noqa: E402
from avenir_tpu.datagen.churn import CHURN_SCHEMA_JSON, generate_churn  # noqa: E402
from avenir_tpu.jobs import get_job as jget_job  # noqa: E402
from avenir_tpu_torch.core.config import JobConfig  # noqa: E402
from avenir_tpu_torch.jobs.base import read_lines  # noqa: E402
from avenir_tpu_torch.serving import (BucketedMicrobatcher,  # noqa: E402
                                      ModelRegistry, ReplicaDownError,
                                      RequestError, RequestTimeout,
                                      ScoreHTTPServer, ServableModel,
                                      ShedError)
from avenir_tpu_torch.serving.pool import CLOSED, OPEN, ReplicaPool  # noqa: E402
from avenir_tpu_torch.telemetry import spans as tel  # noqa: E402
from avenir_tpu_torch.telemetry.journal import read_events  # noqa: E402
from test_torch_serving import _handle  # noqa: E402

WAIT_S = 60.0


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_pool")
    j = lambda *p: str(root.joinpath(*p))  # noqa: E731
    rows = generate_churn(400, seed=7)
    write_csv(j("train.csv"), rows[:320])
    write_csv(j("test.csv"), rows[320:])
    root.joinpath("churn.json").write_text(json.dumps(CHURN_SCHEMA_JSON))
    churn = {"feature.schema.file.path": j("churn.json")}
    jget_job("BayesianDistribution").run(JConf(dict(churn)), j("train.csv"),
                                         j("nb_model"))
    return {"j": j, "churn": churn}


class EchoServable(ServableModel):
    """Deterministic fake: instant scoring (``<line>,<tag>``) and optional
    leading failures of the infrastructure class the breaker counts."""

    family = "echo"

    def __init__(self, tag="v1", fail_first=0):
        super().__init__()
        self.tag = tag
        self.fail_first = fail_first

    def score_lines(self, lines, pad_to):
        self.compile_keys.add((pad_to,))
        if self.fail_first > 0:
            self.fail_first -= 1
            raise RuntimeError("injected infra fault")
        return [f"{line},{self.tag}" for line in lines]

    def warmup(self, pad_to):
        self.compile_keys.add((pad_to,))


def echo_registry_factory(entries=None):
    pending = list(entries) if entries else []

    def factory():
        entry = pending.pop(0) if pending else EchoServable()
        return ModelRegistry().add("echo", entry)

    return factory


def echo_pool(props, entries=None, **kwargs):
    conf = JobConfig({"serve.bucket.sizes": "1,4",
                      "serve.flush.deadline.ms": "5", **props})
    return ReplicaPool.from_conf(
        conf, registry_factory=echo_registry_factory(entries), **kwargs)


def nb_pool(ws, **props):
    j, churn = ws["j"], ws["churn"]
    return ReplicaPool.from_conf(JobConfig({
        **churn, "bayesian.model.file.path": j("nb_model"),
        "serve.models": "naiveBayes", **props}), device="cpu")


@pytest.fixture
def traced(tmp_path):
    tracer = tel.tracer().enable(str(tmp_path))
    try:
        yield tracer
    finally:
        tel.tracer().disable()


def _request_spans(path):
    """rid → scored-span count from a journal (the dedupe oracle)."""
    out = {}
    for e in read_events(path):
        if e.get("ev") == "span.close" and e.get("name") == "serve.request":
            rid = (e.get("attrs") or {}).get("rid")
            if rid:
                out[rid] = out.get(rid, 0) + 1
    return out


def _jax_oracle(ws, lines):
    """The JAX package's single-batcher responses to ``lines``."""
    from avenir_tpu.serving import BucketedMicrobatcher as JBatcher
    from avenir_tpu.serving import ModelRegistry as JRegistry

    j, churn = ws["j"], ws["churn"]
    conf = JConf({**churn, "bayesian.model.file.path": j("nb_model"),
                  "serve.models": "naiveBayes",
                  "serve.bucket.sizes": "1,2,4"})
    b = JBatcher.from_conf(JRegistry.from_conf(conf), conf)
    try:
        return [b.submit("naiveBayes", ln, timeout_s=WAIT_S) for ln in lines]
    finally:
        b.close()


def _wait_until(pred, limit_s=10.0):
    deadline = time.monotonic() + limit_s
    while time.monotonic() < deadline and not pred():
        time.sleep(0.02)
    return pred()


# ---------------------------------------------------------------------------
# failover correctness
# ---------------------------------------------------------------------------

def test_failover_rescore_byte_identical_and_never_double(ws, traced):
    lines = read_lines(ws["j"]("test.csv"))[:16]
    oracle = _jax_oracle(ws, lines)
    pool = nb_pool(ws, **{"serve.bucket.sizes": "1,2,4",
                          "pool.replicas": "2",
                          "pool.monitor.interval.ms": "40",
                          "pool.failover.retries": "1",
                          "serve.flush.deadline.ms": "20",
                          "fault.serve.dispatch.crash.after": "2"})
    try:
        reqs = [pool.submit_nowait("naiveBayes", ln) for ln in lines]
        assert [r.wait(WAIT_S) for r in reqs] == oracle
        stats = pool.stats()["pool"]
        assert stats["replicas.lost"] == 1
        assert stats["failovers"] >= 1
        time.sleep(0.2)                   # let the monitor journal the loss
    finally:
        pool.close()
    spans = _request_spans(traced.journal_path)
    assert spans and all(n == 1 for n in spans.values()), spans
    assert set(spans) == {r.rid for r in reqs}        # none lost
    events = read_events(traced.journal_path)
    downs = [e for e in events if e["ev"] == "pool.replica.down"]
    assert any(e["reason"] == "died" for e in downs)
    assert any(e["ev"] == "fault.injected" and e["site"] == "serve.dispatch"
               for e in events)
    assert any(e["ev"] == "pool.failover" for e in events)


def test_failover_exhausted_sheds_typed(ws):
    lines = read_lines(ws["j"]("test.csv"))[:12]
    pool = nb_pool(ws, **{"serve.bucket.sizes": "1,2,4",
                          "serve.flush.deadline.ms": "20",
                          "pool.replicas": "2",
                          "pool.monitor.interval.ms": "40",
                          "pool.failover.retries": "0",
                          "fault.serve.dispatch.crash.after": "2"})
    try:
        reqs = [pool.submit_nowait("naiveBayes", ln) for ln in lines]
        ok = shed = 0
        for r in reqs:
            try:
                r.wait(WAIT_S)
                ok += 1
            except ShedError:
                shed += 1
        assert ok + shed == len(lines)    # every request has ONE outcome
        assert shed >= 1 and ok >= 1
        assert pool.counters.get("Pool", "failover.exhausted") == shed
        assert pool.counters.get("Serving.naiveBayes", "shed") >= shed
    finally:
        pool.close()


def test_no_ready_replicas_sheds_at_the_door():
    pool = echo_pool({"pool.replicas": "1"})
    try:
        with pool._lock:
            replica = next(iter(pool._replicas.values()))
        replica.breaker = OPEN
        with pytest.raises(ShedError):
            pool.submit_nowait("echo", "row")
        assert pool.counters.get("Pool", "no.ready") == 1
        assert not pool.ready
    finally:
        pool.close()


# ---------------------------------------------------------------------------
# breaker
# ---------------------------------------------------------------------------

def test_breaker_trips_and_probe_recovers():
    flaky = EchoServable(fail_first=2)
    pool = echo_pool({"pool.replicas": "1",
                      "pool.breaker.failures": "2",
                      "pool.breaker.halfopen.ms": "60",
                      "pool.monitor.interval.ms": "30"},
                     entries=[flaky])
    try:
        for _ in range(2):
            with pytest.raises(RequestError):
                pool.submit("echo", "row", timeout_s=10.0)
        assert _wait_until(lambda: not pool.ready, 5.0)
        assert pool.counters.get("Pool", "breaker.trips") == 1
        with pytest.raises(ShedError):
            pool.submit_nowait("echo", "row")
        # half-open: the monitor's probe rides the real dispatch queue and
        # the fake is healthy again, so the breaker closes
        assert _wait_until(lambda: pool.ready, 10.0)
        assert pool.submit("echo", "row9", timeout_s=10.0) == "row9,v1"
        assert pool.counters.get("Pool", "breaker.closes") == 1
    finally:
        pool.close()


def test_bad_requests_do_not_trip_the_breaker(ws):
    pool = nb_pool(ws, **{"serve.bucket.sizes": "1", "pool.replicas": "1",
                          "pool.breaker.failures": "2"})
    try:
        for _ in range(4):
            with pytest.raises(RequestError):
                pool.submit("naiveBayes", "too,few", timeout_s=30.0)
        assert pool.ready
        assert pool.counters.get("Pool", "breaker.trips") == 0
    finally:
        pool.close()


# ---------------------------------------------------------------------------
# heartbeat
# ---------------------------------------------------------------------------

def test_wedged_dispatcher_detected_by_heartbeat_deadline(traced):
    pool = echo_pool({"pool.replicas": "2",
                      "pool.heartbeat.ms": "150",
                      "pool.monitor.interval.ms": "40",
                      "fault.serve.heartbeat.crash.after": "3"})
    try:
        reqs = []
        for i in range(30):
            reqs.append(pool.submit_nowait("echo", f"row{i}"))
            time.sleep(0.015)
        assert [r.wait(30.0) for r in reqs] == [f"row{i},v1"
                                                for i in range(30)]
    finally:
        pool.close()
    events = read_events(traced.journal_path)
    downs = [e for e in events if e["ev"] == "pool.replica.down"]
    assert any(e["reason"] == "heartbeat" for e in downs), downs
    assert any(e["ev"] == "fault.injected" and e["site"] == "serve.heartbeat"
               for e in events)
    assert all(n == 1 for n in _request_spans(traced.journal_path).values())


# ---------------------------------------------------------------------------
# rolling swap
# ---------------------------------------------------------------------------

def test_rolling_swap_advances_every_replica():
    pool = echo_pool({"pool.replicas": "2"})
    try:
        assert pool.submit("echo", "a", timeout_s=10.0) == "a,v1"
        assert pool.swap("echo", EchoServable(tag="v2")) == {"r0": 2, "r1": 2}
        assert pool.submit("echo", "b", timeout_s=10.0) == "b,v2"
        health = pool.health()
        assert health["versions"] == {"echo": 2}
        assert all(row["versions"] == {"echo": 2}
                   for row in health["replicas"])
        assert pool.counters.get("Serving.echo", "recompiles") == 0
    finally:
        pool.close()


def test_replica_spawned_after_swap_serves_swapped_version():
    pool = echo_pool({"pool.replicas": "1"}, start_monitor=False)
    try:
        pool.swap("echo", EchoServable(tag="v2"))
        newcomer = pool._spawn(reason="test")
        assert newcomer.batcher.registry.version("echo") == 2
        assert newcomer.batcher.submit("echo", "z", timeout_s=10.0) == "z,v2"
    finally:
        pool.close()


def test_swap_skips_dead_replicas(ws):
    from avenir_tpu_torch.serving.registry import NaiveBayesServable

    j, churn = ws["j"], ws["churn"]
    lines = read_lines(j("test.csv"))[:8]
    pool = nb_pool(ws, **{"serve.bucket.sizes": "1,2,4",
                          "serve.flush.deadline.ms": "20",
                          "pool.replicas": "2",
                          "pool.monitor.interval.ms": "40",
                          "fault.serve.dispatch.crash.after": "1"})
    try:
        reqs = [pool.submit_nowait("naiveBayes", ln) for ln in lines]
        [r.wait(WAIT_S) for r in reqs]
        time.sleep(0.2)
        entry = NaiveBayesServable.from_conf(JobConfig(
            {**churn, "bayesian.model.file.path": j("nb_model")}),
            device="cpu")
        versions = pool.swap("naiveBayes", entry)
        assert len(versions) == 1 and set(versions.values()) == {2}
    finally:
        pool.close()


# ---------------------------------------------------------------------------
# autoscaler
# ---------------------------------------------------------------------------

def test_autoscaler_grows_on_queue_pressure(traced):
    pool = echo_pool({"serve.bucket.sizes": "64",
                      "serve.flush.deadline.ms": "3000",
                      "serve.queue.depth": "8",
                      "pool.replicas": "1",
                      "pool.monitor.interval.ms": "30",
                      "pool.autoscale.on": "true",
                      "pool.autoscale.min": "1",
                      "pool.autoscale.max": "3",
                      "pool.autoscale.queue.frac": "0.3",
                      "pool.autoscale.interval.sec": "0.05"})
    try:
        reqs = [pool.submit_nowait("echo", f"row{i}") for i in range(6)]
        assert _wait_until(lambda: pool.stats()["pool"]["replicas"] >= 2,
                           5.0)
    finally:
        pool.close()                      # drains the held queue
    [r.wait(10.0) for r in reqs]
    events = read_events(traced.journal_path)
    assert any(e["ev"] == "pool.scale" and e["direction"] == "up"
               and e["reason"] == "queue" for e in events)
    assert any(e["ev"] == "pool.replica.up" for e in events)


def test_autoscaler_replaces_lost_capacity(traced):
    pool = echo_pool({"pool.replicas": "2",
                      "pool.monitor.interval.ms": "30",
                      "pool.autoscale.on": "true",
                      "pool.autoscale.min": "2",
                      "pool.autoscale.interval.sec": "0.05",
                      "fault.serve.dispatch.crash.after": "1"})
    try:
        reqs = [pool.submit_nowait("echo", f"row{i}") for i in range(8)]
        [r.wait(30.0) for r in reqs]
        assert _wait_until(lambda: pool.stats()["pool"]["ready"] == 2, 5.0)
    finally:
        pool.close()
    events = read_events(traced.journal_path)
    assert any(e["ev"] == "pool.scale" and e["reason"] == "replace"
               for e in events)
    assert any(e["ev"] == "pool.replica.up" and e["reason"] == "replace"
               for e in events)


def test_autoscaler_shrinks_when_cold():
    pool = echo_pool({"pool.replicas": "3",
                      "pool.autoscale.on": "true",
                      "pool.autoscale.min": "1",
                      "pool.autoscale.down.burn": "0.5"},
                     start_monitor=False)
    try:
        pool.autoscale_once()
        assert pool.stats()["pool"]["replicas"] == 2
        assert pool.counters.get("Pool", "scale.down") == 1
    finally:
        pool.close()


# ---------------------------------------------------------------------------
# pool-mode surfaces and attribution
# ---------------------------------------------------------------------------

def test_healthz_pool_mode_rows_and_aggregate():
    pool = echo_pool({"pool.replicas": "2"})
    try:
        srv = ScoreHTTPServer(pool, bind=False)
        status, _h, body = _handle(srv, "GET", "/healthz")
        body = json.loads(body)
        assert status == 200 and body["ready"]
        rows = {r["replica"]: r for r in body["replicas"]}
        assert set(rows) == {"r0", "r1"}
        assert all(r["ready"] and r["breaker"] == CLOSED
                   for r in rows.values())
        assert all(r["versions"] == {"echo": 1} for r in rows.values())
        with pool._lock:
            pool._replicas["r1"].breaker = OPEN
        status, _h, body = _handle(srv, "GET", "/healthz")
        rows = {r["replica"]: r for r in json.loads(body)["replicas"]}
        assert status == 200 and not rows["r1"]["ready"]
        assert rows["r1"]["breaker"] == OPEN
        with pool._lock:
            pool._replicas["r0"].breaker = OPEN
        assert _handle(srv, "GET", "/healthz")[0] == 503
        with pool._lock:
            pool._replicas["r0"].breaker = CLOSED
            pool._replicas["r1"].breaker = CLOSED
        page = _handle(srv, "GET", "/metrics")[2].decode()
        assert 'name="pool.replicas.ready"' in page
        assert 'name="pool.queue.r0"' in page
        stats = json.loads(_handle(srv, "GET", "/stats")[2])
        assert stats["pool"]["replicas"] == 2
        status, _h, body = _handle(srv, "POST", "/score",
                                   {"model": "echo", "rows": ["a", "b"]})
        assert status == 200 and json.loads(body)["results"] == ["a,v1",
                                                                  "b,v1"]
    finally:
        pool.close()


def test_shed_and_timeout_carry_replica_attribution(ws):
    j, churn = ws["j"], ws["churn"]
    props = {**churn, "bayesian.model.file.path": j("nb_model"),
             "serve.models": "naiveBayes"}
    registry = ModelRegistry.from_conf(JobConfig(dict(props)), device="cpu")
    b = BucketedMicrobatcher.from_conf(
        registry, JobConfig({**props, "serve.bucket.sizes": "64",
                             "serve.flush.deadline.ms": "5000",
                             "serve.queue.depth": "2"}), name="r7")
    line = read_lines(j("test.csv"))[0]
    try:
        held = [b.submit_nowait("naiveBayes", line) for _ in range(2)]
        with pytest.raises(ShedError) as exc:
            b.submit_nowait("naiveBayes", line)
        assert exc.value.replica == "r7" and "r7" in str(exc.value)
        assert exc.value.queue_wait_ms == 0.0
    finally:
        b.close()
    assert all(h.wait(5.0) for h in held)
    bt = BucketedMicrobatcher.from_conf(
        registry, JobConfig({**props, "serve.bucket.sizes": "8",
                             "serve.flush.deadline.ms": "30",
                             "serve.request.timeout.ms": "1"}), name="r8")
    try:
        req = bt.submit_nowait("naiveBayes", line)
        time.sleep(0.05)
        with pytest.raises(RequestTimeout) as exc:
            req.wait(WAIT_S)
        assert exc.value.replica == "r8" and exc.value.queue_wait_ms > 0
    finally:
        bt.close()


def test_single_batcher_killed_through_conf_fails_typed(ws):
    j, churn = ws["j"], ws["churn"]
    props = {**churn, "bayesian.model.file.path": j("nb_model"),
             "serve.models": "naiveBayes"}
    b = BucketedMicrobatcher.from_conf(
        ModelRegistry.from_conf(JobConfig(dict(props)), device="cpu"),
        JobConfig({**props, "serve.bucket.sizes": "1,4",
                   "fault.serve.dispatch.crash.after": "1"}))
    try:
        line = read_lines(j("test.csv"))[0]
        reqs = [b.submit_nowait("naiveBayes", line) for _ in range(3)]
        for r in reqs:
            with pytest.raises(ReplicaDownError):
                r.wait(WAIT_S)
        assert b.failed
        with pytest.raises(ReplicaDownError):
            b.submit_nowait("naiveBayes", line)
    finally:
        b.close()


# ---------------------------------------------------------------------------
# FaultPlan and HeartbeatMonitor against the JAX package's
# ---------------------------------------------------------------------------

def test_fault_plan_fires_and_journals_as_the_jax_package(tmp_path):
    """The same schedule fires at the same hits and journals the same
    ``fault.injected`` sequence in both packages."""
    from avenir_tpu.telemetry import spans as jtel
    from avenir_tpu.telemetry.journal import read_events as jread
    from avenir_tpu.utils.retry import FaultPlan as JPlan
    from avenir_tpu.utils.retry import InjectedFault as JFault
    from avenir_tpu_torch.utils.retry import FaultPlan, InjectedFault

    props = {"fault.serve.dispatch.crash.after": "3",
             "fault.serve.heartbeat.crash.after": "2",
             "fault.fold.crash.after": "1"}
    seq = ["serve.dispatch", "serve.heartbeat", "serve.dispatch",
           "fold", "serve.heartbeat", "serve.dispatch", "checkpoint.save"]

    def drive(plan, fault_cls):
        fired = []
        for site in seq:
            try:
                plan.hit(site)
                fired.append(None)
            except fault_cls as exc:
                fired.append(str(exc))
        return fired, plan.hits, plan.faults_fired

    tracers = ((tel, read_events, FaultPlan, InjectedFault, JobConfig),
               (jtel, jread, JPlan, JFault, JConf))
    results, journals = [], []
    for k, (t, reader, plan_cls, fault_cls, conf_cls) in enumerate(tracers):
        tracer = t.tracer().enable(str(tmp_path / f"tel{k}"))
        try:
            results.append(drive(plan_cls.from_conf(conf_cls(dict(props))),
                                 fault_cls))
            path = tracer.journal_path
        finally:
            t.tracer().disable()
        journals.append([(e["site"], e["hit"]) for e in reader(path)
                         if e["ev"] == "fault.injected"])
    assert results[0] == results[1]
    assert journals[0] == journals[1] == [
        ("fold", 1), ("serve.heartbeat", 2), ("serve.dispatch", 3)]
    with pytest.raises(ValueError):
        FaultPlan({"nowhere": 1})


def test_heartbeat_monitor_equals_the_jax_package():
    from avenir_tpu.utils.retry import HeartbeatMonitor as JMonitor
    from avenir_tpu_torch.utils.retry import HeartbeatMonitor

    outs = []
    for cls in (HeartbeatMonitor, JMonitor):
        now = [100.0]
        m = cls(timeout_s=5.0, clock=lambda: now[0])
        trace = [m.stalled()]
        now[0] = 104.0
        trace.append(m.stalled())
        now[0] = 106.0
        trace.append(m.stalled())
        m.beat()
        trace += [m.stalled(), m.beats, m.last_beat]
        outs.append(trace)
    assert outs[0] == outs[1] == [False, False, True, False, 1, 106.0]


def test_telemetry_cli_renders_the_failover_drill(tmp_path, capsys):
    """A traced pool drill gives the telemetry CLI its events: the
    durability timeline reads ``fault.injected`` → ``pool.replica.down``,
    the journal holds the ``pool.failover``, and the port's CLI prints
    the JAX package's bytes on the same journal."""
    from avenir_tpu.telemetry.__main__ import main as jax_cli
    from avenir_tpu_torch.telemetry.__main__ import main as port_cli

    tracer = tel.tracer().enable(str(tmp_path))
    try:
        pool = echo_pool({"pool.replicas": "2",
                          "pool.monitor.interval.ms": "30",
                          "fault.serve.dispatch.crash.after": "1"})
        try:
            reqs = [pool.submit_nowait("echo", f"row{i}") for i in range(8)]
            assert [r.wait(30.0) for r in reqs] == [f"row{i},v1"
                                                    for i in range(8)]
            assert _wait_until(
                lambda: pool.stats()["pool"].get("replicas.lost") == 1, 5.0)
        finally:
            pool.close()
        path = tracer.journal_path
    finally:
        tel.tracer().disable()
    capsys.readouterr()
    assert port_cli([path]) == 0
    port = capsys.readouterr().out
    assert jax_cli([path]) == 0
    assert capsys.readouterr().out == port
    order = [ln.split()[0] for ln in port.splitlines()
             if ln.strip().startswith(("fault.injected",
                                       "pool.replica.down"))]
    assert order[:2] == ["fault.injected", "pool.replica.down"]
    assert any(e["ev"] == "pool.failover" for e in read_events(path))


class _ReadLog(JobConfig):
    """A JobConfig that records every key looked up."""

    def __init__(self, props):
        super().__init__(props)
        self.read = set()

    def _lookup(self, key):
        self.read.add(key)
        return super()._lookup(key)


@pytest.mark.parametrize("pin", ["true", "false"])
def test_pool_pin_devices_is_read_and_replicas_share_the_pools_device(
        ws, pin):
    """``pool.pin.devices`` is read (the JAX package pins one replica per
    local device, ``avenir_tpu/serving/pool.py:240,249``); one card is the
    port's only placement, so under both values every replica loads its
    models onto the pool's device."""
    j, churn = ws["j"], ws["churn"]
    conf = _ReadLog({**churn, "bayesian.model.file.path": j("nb_model"),
                     "serve.models": "naiveBayes", "pool.replicas": "3",
                     "pool.pin.devices": pin})
    pool = ReplicaPool.from_conf(conf, device="cpu", start_monitor=False)
    cpu = torch.device("cpu")
    try:
        assert "pool.pin.devices" in conf.read
        replicas = list(pool._replicas.values())
        assert len(replicas) == 3
        for r in replicas:
            assert r.batcher.registry.get("naiveBayes").device == cpu
        line = ",".join(generate_churn(1, seed=3)[0][:-1])
        assert pool.submit("naiveBayes", line, timeout_s=WAIT_S)
    finally:
        pool.close()
