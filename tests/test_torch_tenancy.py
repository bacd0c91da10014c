"""The port's tenancy arbiter (``avenir_tpu_torch/tenancy/``) against the
JAX package's on the CPU.

Contracts parse field for field and refuse key for key as the JAX
package's, and a serving fleet worker's 1/N slice of them
(``split_contracts``) equals the JAX package's; the weighted-DRR arbiter splits a contended pool in share
proportion, strict priority tiers outrank backfill, and per-tenant queue
shares and deadlines shed with a typed ``TenantShedError`` naming the
tenant and the quota, leaving the other tenants whole; the journal events
of a deterministic arbitration equal the JAX package's.  The seams: a
chunk fold and a stream pane draw a slot, a tenanted serving door sheds
with a drain estimate rendered as ``Retry-After`` (HTTP handlers on
in-memory streams: no socket), a paced dispatcher keeps its heartbeat,
an untenanted batcher keeps its anonymous shed, and jobs, the pipeline
driver and the serving CLI arm the arbiter from the conf.
"""

import dataclasses
import io
import json
import re
import threading
import time

import numpy as np
import pytest

from avenir_tpu import tenancy as jtenancy
from avenir_tpu.core.config import ConfigError as JConfigError
from avenir_tpu.core.config import JobConfig as JJobConfig
from avenir_tpu.jobs import get_job as jget_job
from avenir_tpu.telemetry import spans as jtel
from avenir_tpu.telemetry.journal import read_events as jread_events
from avenir_tpu.tenancy.contract import contracts_from_conf as jcontracts
from avenir_tpu.tenancy.contract import split_contracts as jsplit_contracts
from avenir_tpu.tenancy.contract import tenant_slo_rules as jslo_rules
from avenir_tpu_torch import tenancy
from avenir_tpu_torch.core.config import ConfigError, JobConfig
from avenir_tpu_torch.core.encoding import EncodedDataset
from avenir_tpu_torch.jobs import get_job
from avenir_tpu_torch.pipeline import scan
from avenir_tpu_torch.serving import (
    BucketedMicrobatcher,
    ModelRegistry,
    ScoreHTTPServer,
    ServableModel,
)
from avenir_tpu_torch.serving.errors import ShedError, TenantShedError
from avenir_tpu_torch.telemetry import spans as tel
from avenir_tpu_torch.telemetry.journal import read_events
from avenir_tpu_torch.tenancy.contract import (contracts_from_conf,
                                               split_contracts,
                                               tenant_slo_rules)


@pytest.fixture(autouse=True)
def fresh_pool():
    tenancy.reset()
    jtenancy.reset()
    yield
    tenancy.reset()
    jtenancy.reset()


@pytest.fixture
def traced(tmp_path):
    tracer = tel.tracer().enable(str(tmp_path / "tel"))
    try:
        yield tracer
    finally:
        tel.tracer().disable()


def mk_pool(props, capacity=1, mod=tenancy, conf_cls=JobConfig):
    conf = conf_cls({k: str(v) for k, v in props.items()})
    return mod.GraftPool(mod.contracts_from_conf(conf), capacity=capacity)


# ---------------------------------------------------------------------------
# contracts: the tenant.* grammar, field for field and refusal for refusal
# ---------------------------------------------------------------------------

CONTRACT_CONFS = {
    "defaults and overrides": {
        "tenant.a.share": "3", "tenant.a.max.inflight": "2",
        "tenant.a.queue.depth": "8", "tenant.a.priority": "1",
        "tenant.a.queue.timeout.ms": "250", "tenant.b.share": "1",
        "tenant.queue.depth": "16"},
    "prefixed": {"avenir.tenant.x.share": "2",
                 "avenir.tenant.x.queue.timeout.ms": "40"},
    "pool-wide only": {"tenant.id": "a", "tenant.pool.concurrency": "2",
                       "tenant.queue.depth": "8",
                       "tenant.queue.timeout.ms": "50"},
    "pool-wide default": {"tenant.a.share": "1", "tenant.id": "a",
                          "tenant.pool.concurrency": "2",
                          "tenant.queue.depth": "8",
                          "tenant.queue.timeout.ms": "50"},
    "zero share": {"tenant.a.share": "0"},
    "reserved id": {"tenant.pool.share": "1"},
    "typo subkey": {"tenant.a.share": "1", "tenant.a.max.inflght": "2"},
    "dotted id": {"tenant.team.a.share": "2"},
    "quota without share": {"tenant.b.max.inflight": "1"},
    "bad quota": {"tenant.a.share": "1", "tenant.a.max.inflight": "many"},
}


@pytest.mark.parametrize("case", sorted(CONTRACT_CONFS))
def test_contracts_equal_jax_field_for_field(case):
    props = CONTRACT_CONFS[case]
    try:
        want = jcontracts(JJobConfig(dict(props)))
    except Exception as exc:       # the JAX package refuses: so must we
        with pytest.raises(ConfigError if isinstance(exc, JConfigError)
                           else type(exc)):
            contracts_from_conf(JobConfig(dict(props)))
        return
    got = contracts_from_conf(JobConfig(dict(props)))
    assert {t: dataclasses.asdict(c) for t, c in got.items()} == \
        {t: dataclasses.asdict(c) for t, c in want.items()}


SPLIT_CONFS = {
    **CONTRACT_CONFS,
    "ceil": {"tenant.a.share": "3", "tenant.a.max.inflight": "5",
             "tenant.a.queue.depth": "1", "tenant.a.priority": "2",
             "tenant.a.queue.timeout.ms": "80", "tenant.b.share": "1",
             "tenant.b.max.inflight": "4", "tenant.b.queue.depth": "7",
             "tenant.b.slo.p99.metric": "p99.latency.ms",
             "tenant.b.slo.p99.target": "40"},
}


@pytest.mark.parametrize("nworkers", [0, 1, 2, 3])
@pytest.mark.parametrize("case", sorted(SPLIT_CONFS))
def test_split_contracts_equal_jax(case, nworkers):
    """A worker's slice: ``max.inflight`` and ``queue.depth`` ceil-divided
    (the latter at least 1), the relative keys unsplit, the same
    ConfigError for ``nworkers < 1`` or a malformed contract."""
    props = SPLIT_CONFS[case]
    try:
        want = jsplit_contracts(JJobConfig(dict(props)), nworkers)
    except Exception as exc:       # the JAX package refuses: so must we
        with pytest.raises(ConfigError if isinstance(exc, JConfigError)
                           else type(exc), match=re.escape(str(exc))):
            split_contracts(JobConfig(dict(props)), nworkers)
        return
    got = split_contracts(JobConfig(dict(props)), nworkers)
    assert got == want
    if case == "ceil":
        assert got == {
            "tenant.a.max.inflight": str(-(-5 // nworkers)),
            "tenant.a.queue.depth": "1",
            "tenant.b.max.inflight": str(-(-4 // nworkers)),
            "tenant.b.queue.depth": str(-(-7 // nworkers))}


def test_tenant_slo_rules_equal_jax():
    props = {"tenant.a.share": "1",
             "tenant.a.slo.p99.metric": "p99.latency.ms",
             "tenant.a.slo.p99.target": "50",
             "tenant.a.slo.shed.metric": "counter:Tenant.a:shed",
             "tenant.a.slo.shed.target": "0"}
    got = tenant_slo_rules(JobConfig(dict(props)), "a")
    want = jslo_rules(JJobConfig(dict(props)), "a")
    assert {(r.name, r.metric, r.target) for r in got} == \
        {(r.name, r.metric, r.target) for r in want} == {
            ("p99", "p99.latency.ms", 50.0),
            ("shed", "counter:Tenant.a:shed", 0.0)}
    with pytest.raises(ConfigError):
        tenant_slo_rules(JobConfig({"tenant.b.share": "1",
                                    "tenant.b.slo.x.metric": "shed.rate"}),
                         "b")


# ---------------------------------------------------------------------------
# the arbiter
# ---------------------------------------------------------------------------

def test_disabled_and_unmanaged_work_pass_through():
    assert not tenancy.pool().enabled
    with tenancy.pool().slot(tenant="whoever"):
        pass
    assert tenancy.pool().stats() == {} and tenancy.pool().queue_depths() == {}
    pool = mk_pool({"tenant.a.share": 1})
    with pool.slot():
        pass
    with pool.slot(tenant="stranger"):
        pass
    assert pool.stats()["a"]["grants"] == 0
    # configure arms once (the first enabling conf wins), reset disarms
    armed = tenancy.configure(JobConfig({"tenant.a.share": "1"}))
    assert armed.enabled and tenancy.pool() is armed
    assert tenancy.configure(JobConfig({"tenant.b.share": "1"})) is armed
    tenancy.reset()
    assert not tenancy.pool().enabled


def _drain_in_order(pool, submissions):
    """Enqueue ``submissions`` (tenant ids) while the pool's one slot is
    held by tenant ``h``, then release and record the grant order."""
    order = []
    hold = pool.slot(tenant="h")
    hold.__enter__()

    def worker(t):
        with pool.slot(tenant=t):
            order.append(t)

    threads = [threading.Thread(target=worker, args=(t,))
               for t in submissions]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 10.0
    while sum(pool.queue_depths().values()) < len(submissions) and \
            time.monotonic() < deadline:
        time.sleep(0.002)
    hold.__exit__(None, None, None)
    for t in threads:
        t.join(10.0)
    return order


def test_drr_grants_in_share_proportion():
    pool = mk_pool({"tenant.h.share": 1, "tenant.big.share": 4,
                    "tenant.small.share": 1})
    order = _drain_in_order(pool, ["big"] * 12 + ["small"] * 12)
    assert len(order) == 24
    assert order[:10].count("big") >= 6, order
    assert order[:10].count("small") >= 1, order
    stats = pool.stats()
    assert stats["big"]["grants"] == stats["small"]["grants"] == 12


def test_drr_grant_sequence_equals_jax_on_a_ready_backlog():
    """With every ticket queued before the engine runs (driven through
    the engine itself, no threads), the port grants in the JAX package's
    exact order."""
    def sequence(mod, conf_cls):
        pool = mk_pool({"tenant.a.share": 3, "tenant.b.share": 1,
                        "tenant.c.share": 2, "tenant.c.priority": 0},
                       mod=mod, conf_cls=conf_cls)
        arb = mod.arbiter
        now = time.monotonic()
        for t, n in (("a", 6), ("b", 6), ("c", 6)):
            for _ in range(n):
                pool._states[t].queue.append(arb._Ticket(1.0, now))
        order = []
        while any(st.queue for st in pool._states.values()):
            with pool._cond:
                pool._grant_locked([])
            for t, st in pool._states.items():
                if st.inflight:
                    order.append(t)
                    st.inflight -= 1
                    pool._in_use -= 1
        return order

    from avenir_tpu import tenancy as jt

    port = sequence(tenancy, JobConfig)
    assert port == sequence(jt, JJobConfig)
    assert len(port) == 18


def test_priority_tier_outranks_shares():
    pool = mk_pool({"tenant.h.share": 1, "tenant.lo.share": 8,
                    "tenant.hi.share": 1, "tenant.hi.priority": 1})
    order = _drain_in_order(pool, ["lo", "lo", "hi", "hi"])
    assert order[:2] == ["hi", "hi"], order


def test_queue_depth_shed_is_tenant_scoped(traced):
    pool = mk_pool({"tenant.a.share": 1, "tenant.a.queue.depth": 1,
                    "tenant.b.share": 1})
    hold = pool.slot(tenant="a")
    hold.__enter__()
    waiter_done = []

    def waiter():
        with pool.slot(tenant="a"):
            waiter_done.append(True)

    t = threading.Thread(target=waiter)
    t.start()
    deadline = time.monotonic() + 5.0
    while pool.queue_depths()["a"] < 1 and time.monotonic() < deadline:
        time.sleep(0.002)
    with pytest.raises(TenantShedError) as exc:
        with pool.slot(tenant="a"):
            pass
    assert (exc.value.tenant, exc.value.quota) == ("a", "queue.depth")
    assert exc.value.retry_after_s > 0
    hold.__exit__(None, None, None)
    t.join(5.0)
    assert waiter_done
    with pool.slot(tenant="b"):
        pass
    stats = pool.stats()
    assert stats["a"]["shed"] == 1 and stats["b"]["shed"] == 0
    # book-keeping: a submitted 3 (hold, waiter, shed) = granted 2 + shed 1
    assert stats["a"]["grants"] + stats["a"]["shed"] == 3
    sheds = [e for e in read_events(traced.journal_path)
             if e["ev"] == "tenant.shed"]
    assert [e["tenant"] for e in sheds] == ["a"]
    assert sheds[0]["quota"] == "queue.depth" and \
        sheds[0]["retry_after_ms"] > 0


def _deadline_events(mod, conf_cls, tracer_mod, read, path):
    tracer = tracer_mod.tracer().enable(str(path))
    try:
        pool = mk_pool({"tenant.n.share": 1, "tenant.n.max.inflight": 1,
                        "tenant.n.queue.depth": 4}, capacity=2, mod=mod,
                       conf_cls=conf_cls)
        hold = pool.slot(tenant="n")
        hold.__enter__()
        quotas = []
        for _ in range(2):
            try:
                with pool.slot(tenant="n", timeout_s=0):
                    pass
            except Exception as exc:           # noqa: BLE001
                quotas.append((type(exc).__name__, exc.quota))
        hold.__exit__(None, None, None)
        stats = pool.stats()["n"]
        jpath = tracer.journal_path
    finally:
        tracer_mod.tracer().disable()
    events = [{k: v for k, v in e.items()
               if k not in ("ts", "trace", "span", "retry_after_ms")}
              for e in read(jpath) if e["ev"].startswith("tenant.")]
    return quotas, stats, events


def test_deadline_shed_and_throttle_latch_equal_jax(tmp_path):
    from avenir_tpu import tenancy as jt

    port = _deadline_events(tenancy, JobConfig, tel, read_events,
                            tmp_path / "p")
    jax_ = _deadline_events(jt, JJobConfig, jtel, jread_events,
                            tmp_path / "j")
    assert port == jax_
    quotas, stats, events = port
    assert quotas == [("TenantShedError", "deadline")] * 2
    assert stats["shed"] == 2 and stats["throttled"] == 1
    assert [e["ev"] for e in events].count("tenant.admitted") == 1
    assert [e["ev"] for e in events].count("tenant.throttled") == 1


def test_label_scope_stamps_every_journal_event(traced):
    with tenancy.tenant_scope("acme"):
        with traced.span("work", attrs={"k": 1}):
            traced.event("checkpoint.save", dir="d", run="r", rows=1,
                         chunk=0)
    with traced.span("unscoped"):
        pass
    events = read_events(traced.journal_path)
    scoped = [e for e in events if e.get("name") != "unscoped"
              and e["ev"] in ("span.open", "span.close", "checkpoint.save")]
    assert scoped and all(e.get("tenant") == "acme" for e in scoped)
    assert all("tenant" not in e for e in events
               if e.get("name") == "unscoped")


# ---------------------------------------------------------------------------
# the fold seam: batch chunks and stream panes draw arbitrated slots
# ---------------------------------------------------------------------------

def _tiny_ds(n=64, f=3, b=4, c=2):
    rng = np.random.default_rng(5)
    return EncodedDataset(
        codes=rng.integers(0, b, size=(n, f)).astype(np.int32),
        cont=rng.normal(size=(n, 1)).astype(np.float32),
        labels=rng.integers(0, c, size=n).astype(np.int32),
        n_bins=np.full(f, b, np.int32), class_values=["x", "y"],
        binned_ordinals=list(range(f)), cont_ordinals=[f])


def _nb_engine():
    eng = scan.SharedScan(device="cpu")
    eng.register(scan.NaiveBayesConsumer(name="nb"))
    return eng


def test_chunk_fold_draws_tenant_slot_and_sheds_typed():
    tenancy.configure(JobConfig({"tenant.t.share": "1",
                                 "tenant.t.queue.depth": "1"}))
    pool = tenancy.pool()
    with tenancy.tenant_scope("t"):
        out = _nb_engine().run(_tiny_ds())
    assert out["nb"].class_counts.sum() == 64
    assert pool.stats()["t"]["grants"] == 1
    assert _nb_engine().run(_tiny_ds())["nb"].class_counts.sum() == 64
    assert pool.stats()["t"]["grants"] == 1      # unscoped: unmanaged
    hold = pool.slot(tenant="t")
    hold.__enter__()
    release = threading.Event()

    def blocker():
        with pool.slot(tenant="t"):
            release.wait(10.0)

    th = threading.Thread(target=blocker, daemon=True)
    th.start()
    deadline = time.monotonic() + 5.0
    while pool.queue_depths()["t"] < 1 and time.monotonic() < deadline:
        time.sleep(0.002)
    with tenancy.tenant_scope("t"):
        with pytest.raises(TenantShedError) as exc:
            _nb_engine().run(_tiny_ds())
    assert exc.value.tenant == "t" and exc.value.quota == "queue.depth"
    hold.__exit__(None, None, None)
    release.set()
    th.join(10.0)


def test_stream_panes_draw_slots_and_warm_does_too(tmp_path):
    from avenir_tpu_torch.core.encoding import DatasetEncoder
    from avenir_tpu_torch.core.schema import FeatureSchema
    from avenir_tpu_torch.stream import ClassDistributionConsumer, WindowedScan

    schema = tmp_path / "s.json"
    schema.write_text(json.dumps({"fields": [
        {"name": "c", "ordinal": 0, "dataType": "categorical",
         "cardinality": ["r", "g"], "feature": True},
        {"name": "y", "ordinal": 1, "dataType": "categorical",
         "cardinality": ["p", "n"]}]}))
    tenancy.configure(JobConfig({"tenant.s.share": "2"}))
    ws = WindowedScan(DatasetEncoder(FeatureSchema.from_file(str(schema))),
                      [ClassDistributionConsumer(name="cd"),
                       scan.NaiveBayesConsumer(name="nb")], 4, device="cpu")
    with tenancy.tenant_scope("s"):
        assert ws.warm() == 3
        windows = ws.feed(["r,p", "g,n"] * 5) + ws.flush()
    assert [w.rows for w in windows] == [4, 4, 2]
    assert tenancy.pool().stats()["s"]["grants"] == 3 + 3


# ---------------------------------------------------------------------------
# serving: tenant-scoped 429s, paced heartbeats, the anonymous shed
# ---------------------------------------------------------------------------

class EchoServable(ServableModel):
    family = "echo"

    def score_lines(self, lines, pad_to):
        self.compile_keys.add((pad_to,))
        return [f"{line},ok" for line in lines]

    def warmup(self, pad_to):
        self.compile_keys.add((pad_to,))


def _held_batcher(tenant="acme"):
    b = BucketedMicrobatcher(
        ModelRegistry().add("echo", EchoServable()),
        bucket_sizes=(64,), flush_deadline_ms=5000.0, queue_depth=2,
        tenant=tenant)
    held = [b.submit_nowait("echo", f"row{i}") for i in range(2)]
    return b, held


def test_serving_door_shed_names_tenant_quota_and_drain(traced):
    b, held = _held_batcher()
    try:
        with pytest.raises(TenantShedError) as exc:
            b.submit_nowait("echo", "row2")
        err = exc.value
        assert (err.tenant, err.quota) == ("acme", "serve.queue.depth")
        assert err.retry_after_s > 0
        assert b.counters.get("Tenant.acme", "shed") == 1
        sheds = [e for e in read_events(traced.journal_path)
                 if e["ev"] == "tenant.shed"]
        assert len(sheds) == 1 and sheds[0]["tenant"] == "acme"
    finally:
        b.close()
    assert all(h.wait(10.0) for h in held)


def _handle(srv, method, path, payload=None):
    """Drive ``srv``'s request handler on in-memory streams: (status,
    headers, body bytes)."""
    body = b"" if payload is None else json.dumps(payload).encode()
    h = srv.handler_class.__new__(srv.handler_class)
    h.rfile = io.BytesIO(body)
    h.wfile = io.BytesIO()
    h.path = path
    h.command = method
    h.request_version = "HTTP/1.1"
    h.requestline = f"{method} {path} HTTP/1.1"
    h.client_address = ("127.0.0.1", 0)
    h.close_connection = True
    h.headers = {"Content-Length": str(len(body))}
    getattr(h, f"do_{method}")()
    head, _, data = h.wfile.getvalue().partition(b"\r\n\r\n")
    lines = head.decode().split("\r\n")
    status = int(lines[0].split()[1])
    headers = dict(ln.split(": ", 1) for ln in lines[1:])
    return status, headers, data


def test_http_429_carries_retry_after_and_tenant_body():
    from avenir_tpu_torch.telemetry.export import fleet_identity

    b, held = _held_batcher()
    try:
        srv = ScoreHTTPServer(b, bind=False,
                              identity=fleet_identity(tenant="acme"))
        status, headers, body = _handle(srv, "POST", "/score",
                                        {"model": "echo", "rows": ["r"]})
        assert status == 429
        assert int(headers["Retry-After"]) >= 1
        doc = json.loads(body)
        assert doc["error"] == "TENANT_SHED" and doc["tenant"] == "acme"
        assert doc["quota"] == "serve.queue.depth"
        assert doc["retry_after_ms"] > 0
        status, _h, page = _handle(srv, "GET", "/metrics")
        assert status == 200 and 'tenant="acme"' in page.decode()
    finally:
        b.close()
    assert all(h.wait(10.0) for h in held)


def test_paced_dispatcher_keeps_heartbeat_fresh():
    tenancy.configure(JobConfig({"tenant.acme.share": "1"}))
    pool = tenancy.pool()
    hold = pool.slot(tenant="acme")
    hold.__enter__()
    b = BucketedMicrobatcher(
        ModelRegistry().add("echo", EchoServable()),
        bucket_sizes=(1,), flush_deadline_ms=1.0,
        request_timeout_ms=10_000.0, tenant="acme")
    try:
        req = b.submit_nowait("echo", "row")
        deadline = time.monotonic() + 5.0
        while not b._dispatching and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.6)                   # > 2 wait ticks
        assert not b.stalled(0.5)         # paced, not wedged
        assert pool.queue_depths()["acme"] == 1
        hold.__exit__(None, None, None)
        assert req.wait(10.0) == "row,ok"
        assert pool.stats()["acme"]["grants"] == 2
    finally:
        b.close()


def test_dispatch_slot_deadline_sheds_the_batch_typed():
    """A batch whose tenant is paced past the request timeout fails typed
    (``deadline``) and the replica stays up; the other tenant's plane
    dispatches throughout."""
    tenancy.configure(JobConfig({"tenant.acme.share": "1",
                                 "tenant.acme.max.inflight": "1",
                                 "tenant.other.share": "1",
                                 "tenant.pool.concurrency": "2"}))
    pool = tenancy.pool()
    hold = pool.slot(tenant="acme")
    hold.__enter__()
    b = BucketedMicrobatcher(
        ModelRegistry().add("echo", EchoServable()), bucket_sizes=(1,),
        flush_deadline_ms=1.0, request_timeout_ms=200.0, tenant="acme")
    other = BucketedMicrobatcher(
        ModelRegistry().add("echo", EchoServable()), bucket_sizes=(1,),
        flush_deadline_ms=1.0, request_timeout_ms=5000.0, tenant="other")
    try:
        req = b.submit_nowait("echo", "row")
        with pytest.raises(TenantShedError) as exc:
            req.wait(10.0)
        assert exc.value.quota == "deadline" and exc.value.tenant == "acme"
        assert b.counters.get("Serving.echo", "shed") == 1
        assert other.submit("echo", "x", timeout_s=10.0) == "x,ok"
        hold.__exit__(None, None, None)
        assert b.submit("echo", "again", timeout_s=10.0) == "again,ok"
        assert not b.failed
    finally:
        b.close()
        other.close()


def test_untenanted_batcher_keeps_anonymous_shed():
    b = BucketedMicrobatcher(
        ModelRegistry().add("echo", EchoServable()),
        bucket_sizes=(64,), flush_deadline_ms=5000.0, queue_depth=1)
    try:
        held = b.submit_nowait("echo", "row0")
        with pytest.raises(ShedError) as exc:
            b.submit_nowait("echo", "row1")
        assert not isinstance(exc.value, TenantShedError)
        assert getattr(exc.value, "tenant", None) is None
    finally:
        b.close()
    assert held.wait(10.0)


# ---------------------------------------------------------------------------
# jobs, the pipeline driver and the serving CLI arm the arbiter
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hosp(tmp_path_factory):
    from avenir_tpu_torch.core.csv_io import write_csv
    from avenir_tpu_torch.datagen.hosp_readmit import (HOSP_SCHEMA_JSON,
                                                       generate_hosp_readmit)

    root = tmp_path_factory.mktemp("tenancy_hosp")
    write_csv(str(root / "train.csv"), generate_hosp_readmit(3000, seed=3))
    (root / "hosp.json").write_text(json.dumps(HOSP_SCHEMA_JSON))
    return root


@pytest.mark.parametrize("job,extra,grants", [
    ("BayesianDistribution", {"stream.chunk.rows": "700"}, 0),
    ("StreamAnalytics", {"stream.pane.rows": "512",
                         "stream.consumers": "classDistribution,naiveBayes",
                         "stream.window.panes": "2"}, 10 + 6),
], ids=["nb", "stream"])
def test_job_runs_as_its_tenant_under_a_contract(hosp, tmp_path, job, extra,
                                                 grants):
    """A job with a contract and ``tenant.id``: its part file equals the
    untenanted run's and the JAX package's job's under the same contract,
    and the arbiter books what the JAX package's books — nothing for NB,
    whose model folds its own chunks, one slot a pane (and a warmed
    bucket) for StreamAnalytics, whose panes go through
    ``ChunkFolder.fold``."""
    props = {"feature.schema.file.path": str(hosp / "hosp.json"), **extra}
    tenanted = {**props, "tenant.alpha.share": "2", "tenant.id": "alpha",
                "tenant.beta.share": "1"}
    get_job(job).run(JobConfig(dict(props)), str(hosp / "train.csv"),
                     str(tmp_path / "plain"), device="cpu")
    get_job(job).run(JobConfig(dict(tenanted)), str(hosp / "train.csv"),
                     str(tmp_path / "ten"), device="cpu")
    jget_job(job).run(JJobConfig(dict(tenanted)), str(hosp / "train.csv"),
                      str(tmp_path / "jax"))
    part = lambda d: (tmp_path / d / "part-00000").read_text()
    assert part("ten") == part("plain") == part("jax")
    stats = tenancy.pool().stats()
    assert stats == jtenancy.pool().stats()
    assert stats["alpha"]["grants"] == grants
    assert stats["beta"]["grants"] == 0


def test_malformed_contract_refused_before_output(hosp, tmp_path):
    props = {"feature.schema.file.path": str(hosp / "hosp.json"),
             "tenant.alpha.max.inflight": "2",
             "trace.on": "true", "trace.journal.dir": str(tmp_path / "J")}
    with pytest.raises(ConfigError, match="no tenant.alpha.share"):
        get_job("BayesianDistribution").run(JobConfig(props),
                                            str(hosp / "train.csv"),
                                            str(tmp_path / "out"),
                                            device="cpu")
    assert not (tmp_path / "out").exists()
    assert not (tmp_path / "J").exists()


def test_pipeline_runs_fused_scan_as_its_tenant(hosp, tmp_path):
    from avenir_tpu_torch.pipeline import driver

    props = {"pipeline.stages": "nb,mi",
             "pipeline.bind.train": str(hosp / "train.csv"),
             "pipeline.stage.nb.job": "BayesianDistribution",
             "pipeline.stage.nb.input": "train",
             "pipeline.stage.nb.output": "nb_model",
             "pipeline.stage.mi.job": "MutualInformation",
             "pipeline.stage.mi.input": "train",
             "pipeline.stage.mi.output": "mi_out",
             "feature.schema.file.path": str(hosp / "hosp.json"),
             "stream.chunk.rows": "1000"}
    parts = {}
    for name, extra in (("plain", {}),
                        ("ten", {"tenant.batch.share": "1",
                                 "tenant.id": "batch"})):
        tenancy.reset()
        p = driver.Pipeline.from_conf(JobConfig({**props, **extra}),
                                      workspace=str(tmp_path / name),
                                      device="cpu")
        p.run()
        parts[name] = [(tmp_path / name / a / "part-00000").read_text()
                       for a in ("nb_model", "mi_out")]
    assert parts["ten"] == parts["plain"]
    assert tenancy.pool().stats()["batch"]["grants"] == 3
    # the sharded fold draws its slots under the tenant too: one a chunk
    tenancy.reset()
    driver.Pipeline.from_conf(
        JobConfig({**props, "tenant.batch.share": "1", "tenant.id": "batch",
                   "shard.devices": "2"}),
        workspace=str(tmp_path / "sh"), device="cpu").run()
    assert [(tmp_path / "sh" / a / "part-00000").read_text()
            for a in ("nb_model", "mi_out")] == parts["plain"]
    assert tenancy.pool().stats()["batch"]["grants"] == 3
    tenancy.reset()


def test_serving_cli_arms_the_arbiter_before_binding(hosp, tmp_path,
                                                     monkeypatch):
    """The serving CLI configures the arbiter from the properties before
    it loads or binds anything (the frontend here is a stand-in that
    stops the CLI where it would bind)."""
    from avenir_tpu_torch.serving import frontend
    from avenir_tpu_torch.serving.__main__ import main

    get_job("BayesianDistribution").run(
        JobConfig({"feature.schema.file.path": str(hosp / "hosp.json")}),
        str(hosp / "train.csv"), str(tmp_path / "nb"), device="cpu")
    conf = tmp_path / "serve.properties"
    conf.write_text(
        f"feature.schema.file.path={hosp / 'hosp.json'}\n"
        f"bayesian.model.file.path={tmp_path / 'nb'}\n"
        "serve.models=naiveBayes\nserve.bucket.sizes=1,2\n"
        "tenant.online.share=3\ntenant.online.priority=1\n"
        "tenant.id=online\n")
    seen = {}

    class Stop(Exception):
        pass

    class FakeServer:
        def __init__(self, batcher, **kw):
            seen["tenant"] = batcher.tenant
            seen["pool"] = tenancy.pool().stats()
            batcher.close()

        def start(self):
            raise Stop()

    monkeypatch.setattr(frontend, "ScoreHTTPServer", FakeServer)
    with pytest.raises(Stop):
        main(["--conf", str(conf), "--device", "cpu"])
    assert seen["tenant"] == "online"
    assert seen["pool"]["online"]["priority"] == 1
    tenancy.reset()
    conf.write_text(conf.read_text() + "tenant.online.queue.dpth=3\n")
    with pytest.raises(ConfigError, match="unrecognized tenant"):
        main(["--conf", str(conf), "--device", "cpu"])


def test_blackbox_state_records_the_arbiter(tmp_path):
    from avenir_tpu_torch.telemetry import blackbox

    tenancy.configure(JobConfig({"tenant.a.share": "1"}))
    with tenancy.pool().slot(tenant="a"):
        pass
    blackbox.reset()
    try:
        blackbox.configure(JobConfig({"blackbox.dir": str(tmp_path / "B"),
                                      "trace.run.id": "tt"}))
        path = blackbox.finalize("crash:Test", "tb")
        state = json.load(open(f"{path}/state.json"))
    finally:
        blackbox.reset()
    assert state["arbiter"]["stats"]["a"]["grants"] == 1
    assert state["arbiter"]["queues"] == {"a": 0}


def test_fault_plan_parses_the_flood_site():
    from avenir_tpu.utils.retry import FaultPlan as JFaultPlan
    from avenir_tpu_torch.utils.retry import FaultPlan

    props = {"fault.tenant.flood.after": "3", "fault.fold.crash.after": "2"}
    plan = FaultPlan.from_conf(JobConfig(dict(props)))
    assert plan.schedule == JFaultPlan.from_conf(
        JJobConfig(dict(props))).schedule == {"tenant.flood": 3, "fold": 2}
