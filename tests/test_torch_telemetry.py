"""The port's telemetry plane (``avenir_tpu_torch/telemetry``,
``utils/profiling.py``) held against the JAX package's on the CPU.

- The golden schema is the JAX package's, and every event the port emits
  here fits it.
- ``trace.*`` / ``tenant.id`` / ``blackbox.dir`` on a standalone job write
  the JAX package's journal (same file name, same (event, keys, span)
  sequence, same counters) and the same part files; a ``tenant.*``
  contract is refused before any output.
- ``trace.xla.dir`` runs each pipeline stage or fused group under
  ``torch.profiler`` and journals ``xla.trace`` with the JAX package's
  stage names.
- Each package reads the other's journals, and every CLI verb prints the
  same bytes on the same journal.
- Tracing and profiling change no part file and no counter.

Every comparison is exact.  Each test resets the tracer, profiler and
blackbox of both packages.
"""

import json
import os
import pathlib
import threading

import pytest

torch = pytest.importorskip("torch")

from avenir_tpu import __main__ as jmain  # noqa: E402
from avenir_tpu.pipeline import driver as jdriver  # noqa: E402
from avenir_tpu.telemetry import __main__ as jcli  # noqa: E402
from avenir_tpu.telemetry import blackbox as jblackbox  # noqa: E402
from avenir_tpu.telemetry import journal as jjournal  # noqa: E402
from avenir_tpu.telemetry import profile as jprof_mod  # noqa: E402
from avenir_tpu.telemetry import schema as jschema  # noqa: E402
from avenir_tpu.telemetry import spans as jtel  # noqa: E402
from avenir_tpu.core.config import JobConfig as JConfig  # noqa: E402
from avenir_tpu_torch import __main__ as tmain  # noqa: E402
from avenir_tpu_torch.core.config import JobConfig  # noqa: E402
from avenir_tpu_torch.core.csv_io import write_csv  # noqa: E402
from avenir_tpu_torch.datagen.hosp_readmit import (  # noqa: E402
    HOSP_SCHEMA_JSON, generate_hosp_readmit)
from avenir_tpu_torch.jobs import get_job  # noqa: E402
from avenir_tpu_torch.pipeline import driver  # noqa: E402
from avenir_tpu_torch.telemetry import __main__ as cli  # noqa: E402
from avenir_tpu_torch.telemetry import blackbox  # noqa: E402
from avenir_tpu_torch.telemetry import profile as prof_mod  # noqa: E402
from avenir_tpu_torch.telemetry import schema  # noqa: E402
from avenir_tpu_torch.telemetry import spans as tel  # noqa: E402
from avenir_tpu_torch.telemetry.journal import (  # noqa: E402
    Journal, merge_shards, read_events)
from avenir_tpu_torch.utils.locking import LockHeldError  # noqa: E402
from avenir_tpu_torch.utils.metrics import Counters  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent


def _reset_all():
    for t in (tel, jtel):
        t.tracer().disable()
    for box in (blackbox, jblackbox):
        box.reset()
        box.ring_clear()


@pytest.fixture(autouse=True)
def _fresh_planes():
    _reset_all()
    yield
    _reset_all()


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    work = tmp_path_factory.mktemp("telemetry")
    write_csv(str(work / "train.csv"), generate_hosp_readmit(2000, seed=3))
    write_csv(str(work / "train3k.csv"), generate_hosp_readmit(3000, seed=3))
    (work / "hosp.json").write_text(json.dumps(HOSP_SCHEMA_JSON))
    return work


def _labels_free(keys):
    return set(keys) - schema.STAMP_KEYS - {"replica", "tenant", "at"}


def fits_schema(events):
    """Every event's key set (stamp, labels and a retroactive ``at`` set
    aside; ``trace``/``span`` absent outside any span) is one of
    ``event_shapes``."""
    assert events
    for e in events:
        keys = _labels_free(e) | {"trace", "span"}
        shapes = [_labels_free(s) | {"trace", "span"}
                  for s in schema.event_shapes(e["ev"])]
        assert keys in shapes, (e["ev"], sorted(e))


def _journal(directory):
    names = [n for n in os.listdir(directory) if n.endswith(".jsonl")]
    assert len(names) == 1, names
    return os.path.join(directory, names[0])


def _sequence(events):
    return [(e["ev"], frozenset(e), e.get("name")) for e in events]


# the spans the port opens inside a standalone NB job and the JAX package
# does not (the accumulator's fetch and add), each with the span it opens
# under
PORT_LAYER_SPANS = {"acc.fetch": "job.BayesianDistribution",
                    "acc.add": "job.BayesianDistribution"}


def _jax_view(events):
    """The port's events less its layer spans, each of which is held to
    open under its named parent and to close."""
    names = {e["span"]: e["name"] for e in events if e["ev"] == "span.open"}
    out, seen = [], []
    for e in events:
        if e["ev"] in ("span.open", "span.close") and \
                e["name"] in PORT_LAYER_SPANS:
            if e["ev"] == "span.open":
                assert names[e["parent"]] == PORT_LAYER_SPANS[e["name"]], e
            seen.append((e["ev"], e["name"]))
            continue
        out.append(e)
    assert ("span.close", "acc.fetch") in seen
    assert seen.count(("span.open", "acc.add")) == \
        seen.count(("span.close", "acc.add"))
    return out


# ---------------------------------------------------------------------------
# the golden schema
# ---------------------------------------------------------------------------

def test_schema_equals_jax():
    assert schema.GOLDEN_EVENT_KEYS == jschema.GOLDEN_EVENT_KEYS
    assert schema.EVENT_SHAPE_VARIANTS == jschema.EVENT_SHAPE_VARIANTS
    assert schema.STAMP_KEYS == jschema.STAMP_KEYS
    assert schema.EVENT_ONCE == jschema.EVENT_ONCE
    for ev in jschema.GOLDEN_EVENT_KEYS:
        assert schema.event_shapes(ev) == jschema.event_shapes(ev)


def test_golden_event_shapes(tmp_path):
    """Every schema event written through the port's journal keeps its
    exact key set: the port's own producers where it has them (counters,
    gauges, the recompile monitor, the program registry, the sentinel,
    the SLO evaluator, the blackbox latch and watchdog), the rest with
    the JAX test's fields."""
    from avenir_tpu_torch.telemetry import sentinel
    from avenir_tpu_torch.telemetry.slo import SloEvaluator, SloRule

    tracer = tel.tracer().enable(str(tmp_path))
    counters = Counters()
    counters.increment("Records", "Processed", 5)
    blackbox.configure(JobConfig({"blackbox.dir": str(tmp_path / "bb"),
                                  "blackbox.flush.sec": "0"}))
    with tracer.span("run", attrs={"k": 1}):
        tracer.counters("run", counters)
        tracer.gauge("queue.depth", 3)
        monitor = tel.CompileKeyMonitor(counters, scope="probe")
        monitor.prime([(1,)])
        monitor.observe([(2,)])
        # every other event and variant with the schema's own keys: the
        # port has no producer of them yet (serving, stream, parallel,
        # tenancy, the planner), or none that runs on the CPU
        # (device.memory)
        produced = {"span.open", "span.close", "counters", "gauge",
                    "recompile", "slo.violation", "program.compiled",
                    "program.profile", "bench.regression", "bundle.written",
                    "hang.detected"}
        for ev in sorted(set(schema.GOLDEN_EVENT_KEYS) - produced):
            for shape in schema.event_shapes(ev):
                tracer.event(ev, **{k: 1 for k in sorted(
                    shape - {"ev", "ts", "trace", "span"})})
        slo_counters = Counters()
        slo_counters.increment("Serving.m", "requests", 10)
        slo_counters.increment("Serving.m", "shed", 90)
        SloEvaluator([SloRule("shed", "shed.rate", 0.05)]).evaluate_live(
            slo_counters, {}, {})
        prof = prof_mod.profiler().enable()
        prof.observe(("gk",), site="golden")
        prof.sample(("gk",), "golden", 0.002)
        prof.flush()
        sentinel.journal_verdict(
            {"verdict": "pass", "compared": 1, "regressed": [],
             "skipped": []}, "BASELINE.json")
        wd = blackbox.Watchdog()
        wd.sec = 0.05
        wd.enter("fold")
        wd.last_progress -= 1.0
        wd.check_once()               # hang.detected, then the latch
        wd.exit("fold")
    path = tracer.journal_path
    tel.tracer().disable()
    seen = {}
    for event in read_events(path):
        seen.setdefault(event["ev"], set()).add(frozenset(event))
    assert set(seen) == set(schema.GOLDEN_EVENT_KEYS)
    for ev in schema.GOLDEN_EVENT_KEYS:
        want = {shape | schema.STAMP_KEYS for shape in schema.event_shapes(ev)}
        assert seen[ev] == want, f"{ev} schema drifted: {seen[ev]} != {want}"


# ---------------------------------------------------------------------------
# Queue 3 fault 1: the standalone jobs' telemetry and tenancy keys
# ---------------------------------------------------------------------------

def _nb_argv(env, journal_dir, out, *extra):
    return ["BayesianDistribution",
            f"-Dfeature.schema.file.path={env / 'hosp.json'}",
            "-Dtrace.on=true", f"-Dtrace.journal.dir={journal_dir}",
            "-Dtenant.id=alpha", *extra, str(env / "train.csv"), str(out)]


def _both_clis(env, tmp_path, monkeypatch, *extra):
    monkeypatch.setenv("AVENIR_COMPILATION_CACHE", "")
    jdir, tdir = tmp_path / "J_jax", tmp_path / "J_port"
    assert jmain.main(_nb_argv(env, jdir, tmp_path / "o_jax", *extra)) == 0
    jtel.tracer().disable()
    assert tmain.main(_nb_argv(env, tdir, tmp_path / "o_port", *extra)
                      + ["--device", "cpu"]) == 0
    tel.tracer().disable()
    return jdir, tdir


def test_fault1_job_journal_equals_jax(env, tmp_path, monkeypatch):
    jdir, tdir = _both_clis(env, tmp_path, monkeypatch)
    jpath, tpath = _journal(jdir), _journal(tdir)
    name = os.path.basename(tpath)
    assert name == os.path.basename(jpath)
    assert name.startswith("run-") and name.endswith(".proc-0-alpha.jsonl")
    jev, tev = jjournal.read_events(jpath), read_events(tpath)
    assert _sequence(_jax_view(tev)) == _sequence(jev)
    assert [e["groups"] for e in tev if e["ev"] == "counters"] == \
        [e["groups"] for e in jev if e["ev"] == "counters"]
    assert all(e["tenant"] == "alpha" and e["replica"] == "alpha"
               for e in tev)
    fits_schema(tev)
    assert (tmp_path / "o_port" / "part-00000").read_bytes() == \
        (tmp_path / "o_jax" / "part-00000").read_bytes()


def test_fault1_blackbox_dir_is_created(env, tmp_path, monkeypatch):
    """Both packages arm the flight recorder from ``blackbox.dir``: the
    directory and the live bundle, named for the same run and writer
    (each run in its own directory, with the same relative paths, so the
    two confs are equal)."""
    monkeypatch.setenv("AVENIR_COMPILATION_CACHE", "")
    argv = _nb_argv(env, "J", "o", "-Dblackbox.dir=B",
                    "-Dblackbox.flush.sec=0")
    for side, main in (("jax", jmain.main), ("port", tmain.main)):
        (tmp_path / side).mkdir()
        monkeypatch.chdir(tmp_path / side)
        assert main(argv + (["--device", "cpu"] if side == "port"
                            else [])) == 0
    bundles = [sorted(os.listdir(tmp_path / side / "B"))
               for side in ("jax", "port")]
    assert bundles[0] == bundles[1]
    assert len(bundles[1]) == 1 and bundles[1][0].endswith("-proc-0-alpha")
    assert blackbox.box().armed and jblackbox.box().armed


@pytest.mark.parametrize("key", ["tenant.alpha.share",
                                 "tenant.pool.concurrency",
                                 "tenant.queue.depth",
                                 "avenir.tenant.alpha.max.inflight"])
def test_fault1_tenant_contract_refused_before_output(env, tmp_path, key,
                                                      monkeypatch):
    """The ``tenant.*`` keys once refused are honoured as the JAX package
    honours them: a well-formed contract or pool-wide key runs with the
    JAX package's journal events and part file; a quota without a share
    is refused by both packages with ConfigError, before any output (the
    port before its journal too)."""
    from avenir_tpu import tenancy as jtenancy
    from avenir_tpu.core.config import ConfigError as JConfigError
    from avenir_tpu_torch import tenancy
    from avenir_tpu_torch.core.config import ConfigError

    tenancy.reset()
    jtenancy.reset()
    try:
        if key.endswith("max.inflight"):
            for main, err, extra, side in (
                    (jmain.main, JConfigError, [], "jax"),
                    (tmain.main, ConfigError, ["--device", "cpu"], "port")):
                out, jdir = tmp_path / f"o_{side}", tmp_path / f"J_{side}"
                with pytest.raises(err, match="no tenant.alpha.share"):
                    main(_nb_argv(env, jdir, out, f"-D{key}=2") + extra)
                assert not out.exists()
            # the port checks the contract before it opens its journal
            assert not (tmp_path / "J_port").exists()
            return
        jdir, tdir = _both_clis(env, tmp_path, monkeypatch, f"-D{key}=2")
        jev = jjournal.read_events(_journal(jdir))
        tev = read_events(_journal(tdir))
        assert _sequence(_jax_view(tev)) == _sequence(jev)
        assert (tmp_path / "o_port" / "part-00000").read_bytes() == \
            (tmp_path / "o_jax" / "part-00000").read_bytes()
        assert tenancy.pool().stats() == jtenancy.pool().stats()
        assert tenancy.pool().enabled == (key == "tenant.alpha.share")
    finally:
        tenancy.reset()
        jtenancy.reset()


def test_tracer_off_is_noop_and_writes_nothing(env, tmp_path):
    tel_dir = tmp_path / "tel"
    get_job("BayesianDistribution").run(
        JobConfig({"feature.schema.file.path": str(env / "hosp.json"),
                   "stream.chunk.rows": "700",
                   "trace.journal.dir": str(tel_dir)}),
        str(env / "train.csv"), str(tmp_path / "nb"), device="cpu")
    assert not tel_dir.exists()
    assert not tel.tracer().enabled and not prof_mod.profiler().enabled
    sp = tel.tracer().span("anything")
    assert sp is tel.NOOP_SPAN
    with sp as inner:
        assert inner.block_on(123) == 123
        inner.set("k", "v").event("whatever")


# ---------------------------------------------------------------------------
# Queue 3 fault 2: the pipeline's trace.xla.dir
# ---------------------------------------------------------------------------

def _pipe_props(env, **extra):
    props = {
        "pipeline.stages": "nb,mi",
        "pipeline.bind.train": str(env / "train3k.csv"),
        "pipeline.stage.nb.job": "BayesianDistribution",
        "pipeline.stage.nb.input": "train",
        "pipeline.stage.nb.output": "nb_model",
        "pipeline.stage.mi.job": "MutualInformation",
        "pipeline.stage.mi.input": "train",
        "pipeline.stage.mi.output": "mi_out",
        "feature.schema.file.path": str(env / "hosp.json"),
        "stream.chunk.rows": "1000",
    }
    props.update(extra)
    return props


@pytest.mark.parametrize("fuse", ["true", "false"])
def test_fault2_xla_trace_per_stage(env, tmp_path, monkeypatch, fuse):
    """Fused, NB + MI are one group traced under the head's name;
    unfused, each stage is its own trace.  The JAX side runs with its
    capture stubbed, as its own tests run it: the stage names are the
    driver's."""
    import contextlib

    from avenir_tpu.utils import profiling as jprofiling

    @contextlib.contextmanager
    def stub(log_dir):
        yield

    monkeypatch.setattr(jprofiling, "trace", stub)
    keys = {"scan.fuse": fuse, "trace.on": "true"}
    xt, xj = tmp_path / "X", tmp_path / "XJ"
    jdriver.Pipeline.from_conf(
        JConfig(_pipe_props(env, **keys, **{
            "trace.journal.dir": str(tmp_path / "tj"),
            "trace.xla.dir": str(xj)})),
        workspace=str(tmp_path / "wj")).run()
    jtel.tracer().disable()
    driver.Pipeline.from_conf(
        JobConfig(_pipe_props(env, **keys, **{
            "trace.journal.dir": str(tmp_path / "tt"),
            "trace.xla.dir": str(xt)})),
        workspace=str(tmp_path / "wt"), device="cpu").run()
    tel.tracer().disable()
    stages = ["nb"] if fuse == "true" else ["nb", "mi"]
    assert sorted(os.listdir(xt)) == sorted(stages)
    for stage in stages:
        traces = os.listdir(xt / stage)
        assert len(traces) == 1 and traces[0].endswith(".pt.trace.json")
        assert "traceEvents" in json.loads((xt / stage / traces[0]).read_text())
    tev = read_events(_journal(tmp_path / "tt"))
    jev = jjournal.read_events(_journal(tmp_path / "tj"))
    got = [(e["stage"], e["dir"]) for e in tev if e["ev"] == "xla.trace"]
    want = [e["stage"] for e in jev if e["ev"] == "xla.trace"]
    assert [s for s, _d in got] == want == stages
    assert [d for _s, d in got] == [str(xt / s) for s in stages]
    fits_schema(tev)
    for art in ("nb_model", "mi_out"):
        assert (tmp_path / "wt" / art / "part-00000").exists()


def test_fault2_xla_trace_off_writes_nothing(env, tmp_path, monkeypatch):
    from avenir_tpu_torch.utils import profiling

    def boom(*a, **k):                       # must never be reached
        raise AssertionError("trace engaged without trace.xla.dir")

    monkeypatch.setattr(profiling, "trace", boom)
    driver.Pipeline.from_conf(JobConfig(_pipe_props(env)),
                              workspace=str(tmp_path / "ws"),
                              device="cpu").run()
    assert not (tmp_path / "X").exists()


# ---------------------------------------------------------------------------
# reading across packages; the CLI's bytes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def journals(env, tmp_path_factory):
    """Two traced and profiled runs of the fused NB + MI pipeline (writer
    shards w0 and w1 of one run id), a JAX journal of the same pipeline,
    and a forensics bundle."""
    work = tmp_path_factory.mktemp("journals")
    _reset_all()
    try:
        for sfx in ("w0", "w1"):
            driver.Pipeline.from_conf(
                JobConfig(_pipe_props(env, **{
                    "trace.on": "true", "profile.on": "true",
                    "trace.journal.dir": str(work / "tel"),
                    "trace.run.id": "cli", "trace.writer.suffix": sfx})),
                workspace=str(work / f"ws_{sfx}"), device="cpu").run()
            tel.tracer().disable()
        jdriver.Pipeline.from_conf(
            JConfig(_pipe_props(env, **{
                "trace.on": "true", "profile.on": "true",
                "trace.journal.dir": str(work / "jtel")})),
            workspace=str(work / "ws_jax")).run()
        jtel.tracer().disable()
        blackbox.configure(JobConfig({"blackbox.dir": str(work / "bb"),
                                      "blackbox.flush.sec": "0",
                                      "trace.run.id": "cli"}))
        blackbox.ring_record("span.open", {"span": "s1", "name": "fold"})
        bundle = blackbox.finalize("crash:CliTest", "Traceback: cli")
    finally:
        _reset_all()
    shards = sorted(str(work / "tel" / n) for n in os.listdir(work / "tel")
                    if n.endswith(".jsonl"))
    assert [os.path.basename(s) for s in shards] == [
        "run-cli.proc-0-w0.jsonl", "run-cli.proc-0-w1.jsonl"]
    return {"work": work, "shards": shards, "bundle": bundle,
            "jax": _journal(work / "jtel")}


def test_jax_reader_reads_the_port_journal(journals):
    for shard in journals["shards"]:
        ours = read_events(shard)
        fits_schema(ours)
        assert jjournal.read_events(shard) == ours
        evs = {e["ev"] for e in ours}
        assert {"span.open", "span.close", "counters", "program.compiled",
                "program.profile"} <= evs


def test_port_reader_reads_the_jax_journal(journals):
    theirs = jjournal.read_events(journals["jax"])
    assert read_events(journals["jax"]) == theirs
    assert merge_shards(journals["shards"]) == \
        jjournal.merge_shards(journals["shards"])


CLI_VERBS = {
    "tree": lambda j: [j["shards"][0]],
    "merge": lambda j: ["merge", str(j["work"] / "tel"), "--stdout"],
    "skew": lambda j: ["skew", j["shards"][0]],
    "slo": lambda j: ["slo", j["shards"][0],
                      "--rule", "rec=recompiles.total<=5",
                      "--rule", "p99=p99.latency.ms<=5000"],
    "profile": lambda j: ["profile", j["shards"][0], "--peak-tflops", "989"],
    "metrics": lambda j: ["metrics", j["shards"][0]],
    "regress": lambda j: ["regress", str(REPO / "BENCH_r05.json"),
                          "--baseline", str(REPO / "BENCH_r04.json")],
    "diff": lambda j: ["diff", j["shards"][0], j["shards"][1]],
    "bundle": lambda j: ["bundle", j["bundle"]],
}


@pytest.mark.parametrize("verb", sorted(CLI_VERBS))
def test_cli_verb_prints_the_jax_bytes(journals, verb, capsys):
    argv = CLI_VERBS[verb](journals)
    rc_port = cli.main(list(argv))
    ours = capsys.readouterr()
    rc_jax = jcli.main(list(argv))
    theirs = capsys.readouterr()
    assert rc_port == rc_jax
    assert ours.out == theirs.out and ours.out
    assert ours.err == theirs.err


def test_cli_reads_the_jax_journal(journals, capsys):
    for argv in (["tree", journals["jax"]], ["profile", journals["jax"]],
                 ["metrics", journals["jax"]]):
        assert cli.main(list(argv)) == 0
        ours = capsys.readouterr().out
        assert jcli.main(list(argv)) == 0
        assert ours == capsys.readouterr().out


def test_cli_marks_open_spans_and_slowest_path(tmp_path, capsys):
    tracer = tel.tracer().enable(str(tmp_path))
    with tracer.span("run"):
        with tracer.span("fast"):
            pass
        tracer.journal.emit("span.open", trace=tracer.current().trace_id,
                            span="s999", parent=tracer.current().span_id,
                            name="wedged", attrs={})
    path = tracer.journal_path
    tel.tracer().disable()
    assert cli.main([path]) == 0
    out = capsys.readouterr().out
    wedged_line = next(ln for ln in out.splitlines() if "wedged" in ln)
    assert "OPEN" in wedged_line and "◀" in wedged_line


def test_cli_json_and_missing_file(tmp_path, capsys):
    with Journal(str(tmp_path / "j.jsonl")) as journal:
        journal.emit("gauge", name="q", value=1)
    assert cli.main([str(tmp_path / "j.jsonl"), "--json"]) == 0
    assert json.loads(capsys.readouterr().out)[0]["ev"] == "gauge"
    assert cli.main([str(tmp_path / "nope.jsonl")]) == 2


# ---------------------------------------------------------------------------
# tracing changes no result
# ---------------------------------------------------------------------------

TRACED = {"trace.on": "true", "profile.on": "true"}


def _job_case(env, work, case, extra):
    props = {"feature.schema.file.path": str(env / "hosp.json"), **extra}
    name = {"nb": "BayesianDistribution", "mi": "MutualInformation",
            "tree": "DecisionTreeBuilder",
            "resume": "MutualInformation"}[case]
    if case in ("nb", "mi", "resume"):
        props["stream.chunk.rows"] = "700"
    if case == "tree":
        props["max.depth"] = "3"
    out = str(work / "out")
    job = get_job(name)
    if case == "resume":
        props.update({"stream.checkpoint.dir": str(work / "ck"),
                      "stream.checkpoint.interval.chunks": "1"})
        with pytest.raises(RuntimeError, match="injected crash"):
            job.run(JobConfig({**props,
                               "stream.fault.crash.after.chunks": "2"}),
                    str(env / "train.csv"), out, device="cpu")
        props["stream.resume"] = "true"
    counters = job.run(JobConfig(props), str(env / "train.csv"), out,
                       device="cpu")
    return counters.as_dict(), pathlib.Path(out, "part-00000").read_bytes()


@pytest.mark.parametrize("case", ["nb", "mi", "tree", "resume"])
def test_tracing_changes_no_result(env, tmp_path, case):
    plain = _job_case(env, tmp_path / "plain", case, {})
    tel_dir = tmp_path / "tel"
    traced = _job_case(env, tmp_path / "traced", case,
                       {**TRACED, "trace.journal.dir": str(tel_dir)})
    tel.tracer().disable()
    assert traced == plain
    events = read_events(_journal(tel_dir))
    fits_schema(events)
    names = {e.get("name") for e in events if e["ev"] == "span.open"}
    if case == "tree":
        levels = [e for e in events if e["ev"] == "program.profile"
                  and e["site"] == "tree.level"]
        assert levels and sum(e["dispatches"] for e in levels) == 3
    else:
        assert "chunk" in names
    if case == "resume":
        evs = [e["ev"] for e in events]
        assert "checkpoint.restore" in evs and "checkpoint.save" in evs


# ---------------------------------------------------------------------------
# copies of the JAX package's journal and monitor tests
# ---------------------------------------------------------------------------

def test_journal_single_writer_detected(tmp_path):
    path = str(tmp_path / "run-x.jsonl")
    journal = Journal(path)
    journal.emit("probe", n=1)
    with pytest.raises(LockHeldError):
        Journal(path)
    journal.close()
    second = Journal(path)
    second.emit("probe", n=2)
    second.close()
    assert [e["n"] for e in read_events(path)] == [1, 2]


def test_journal_tolerates_crash_mid_line(tmp_path):
    path = str(tmp_path / "run-x.jsonl")
    with Journal(path) as journal:
        journal.emit("first", n=1)
        journal.emit("second", n=2)
    with open(path, "a") as fh:
        fh.write('{"ev": "torn", "n": 3, "fiel')
    events = read_events(path)
    assert [e["ev"] for e in events] == ["first", "second"]
    assert events == jjournal.read_events(path)


def test_journal_rotation_bounds_growth(tmp_path):
    path = str(tmp_path / "run-x.jsonl")
    journal = Journal(path, max_bytes=1 << 12)
    for i in range(200):
        journal.emit("fill", n=i, pad="x" * 40)
    journal.close()
    assert os.path.exists(path + ".1")
    assert os.path.getsize(path) <= (1 << 12)
    events = read_events(path, with_rotated=True)
    assert events[-1]["n"] == 199
    assert [e["n"] for e in events] == sorted(e["n"] for e in events)


def test_journal_emit_concurrent_threads_valid_jsonl(tmp_path):
    path = str(tmp_path / "run-x.jsonl")
    journal = Journal(path)
    per_thread, n_threads = 500, 8
    threads = [threading.Thread(target=lambda: [
        journal.emit("tick", n=i) for i in range(per_thread)])
        for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    journal.close()
    events = read_events(path)
    assert len(events) == per_thread * n_threads
    assert all(e["ev"] == "tick" for e in events)


def test_compile_key_monitor_counts_fresh_keys():
    counters = Counters()
    monitor = tel.CompileKeyMonitor(counters, group="Serving.m", scope="m")
    monitor.prime([(1,), (2,)])
    assert monitor.observe([(1,)]) == 0
    assert monitor.observe([(1,), (3,)]) == 1
    assert monitor.observe([(3,)]) == 0
    assert counters.get("Serving.m", "recompiles") == 1


def test_compile_key_monitor_auto_prime_stream_mode():
    counters = Counters()
    monitor = tel.CompileKeyMonitor(counters, scope="stream",
                                    auto_prime=True)
    assert monitor.observe([("full",)]) == 0
    assert monitor.observe([("full",)]) == 0
    assert monitor.observe([("ragged",)]) == 1
    assert counters.get("Telemetry", "recompiles") == 1


def test_shape_key_equals_jax_for_numpy_and_torch_operands():
    import numpy as np

    codes = np.zeros((7, 3), np.int32)
    labels = np.zeros(7, np.int32)
    want = jtel.CompileKeyMonitor.shape_key(codes, labels, None)
    assert tel.CompileKeyMonitor.shape_key(codes, labels, None) == want
    assert tel.CompileKeyMonitor.shape_key(
        torch.from_numpy(codes), torch.from_numpy(labels), None) == want
    assert prof_mod.program_id("stream", want) == \
        jprof_mod.program_id("stream", want)


def test_resume_skip_journals_an_event(env, tmp_path):
    ws = str(tmp_path / "ws")
    driver.Pipeline.from_conf(JobConfig(_pipe_props(env)), workspace=ws,
                              device="cpu").run()
    p = driver.Pipeline.from_conf(
        JobConfig(_pipe_props(env, **{
            "trace.on": "true", "trace.journal.dir": str(tmp_path / "tel")})),
        workspace=ws, device="cpu")
    p.run(resume=True)
    path = tel.tracer().journal_path
    tel.tracer().disable()
    events = read_events(path)
    fits_schema(events)
    assert {e["stage"] for e in events if e["ev"] == "stage.skipped"} == \
        {"nb", "mi"}
    assert all(p.counters[s].get("Pipeline", "skipped") == 1
               for s in ("nb", "mi"))


def _supervisor(st_mod, orl_mod, fault_cls, crash_on, total=120):
    events, rewards, actions = (st_mod.InProcQueue(), st_mod.InProcQueue(),
                                st_mod.InProcQueue())
    for i in range(1, total + 1):
        events.push(f"ev{i},{i}")
        rewards.push(f"{'ab'[i % 2]},{float(i % 17)}")
    calls = {"n": 0}

    def factory():
        srv = st_mod.ReinforcementLearnerServer(
            orl_mod.create_learner("randomGreedy", ["a", "b"], {}, seed=9),
            st_mod.QueueEventSource(events), st_mod.QueueRewardReader(rewards),
            st_mod.QueueActionWriter(actions))
        orig = srv.process_one

        def flaky():
            calls["n"] += 1
            if calls["n"] in crash_on:
                raise fault_cls("injected")
            return orig()

        srv.process_one = flaky
        return srv

    return st_mod.ServerSupervisor(factory, checkpoint_interval=16,
                                   max_restarts=2)


def test_supervisor_journals_the_jax_events(tmp_path):
    """``ServerSupervisor``'s ``checkpoint.save`` / ``server.restart`` /
    ``checkpoint.restore`` events equal the JAX package's on the same
    crashes, field for field."""
    from avenir_tpu.models import online_rl as jorl
    from avenir_tpu.pipeline import streaming as jst
    from avenir_tpu.utils.retry import InjectedFault as JInjectedFault
    from avenir_tpu_torch.models import online_rl as orl
    from avenir_tpu_torch.pipeline import streaming as st
    from avenir_tpu_torch.utils.retry import InjectedFault

    got = {}
    for side, t, mods in (("port", tel, (st, orl, InjectedFault)),
                          ("jax", jtel, (jst, jorl, JInjectedFault))):
        tracer = t.tracer().enable(str(tmp_path / side))
        with tracer.span("serve"):
            assert _supervisor(*mods, crash_on={40, 90}).run() == 120
        path = tracer.journal_path
        t.tracer().disable()
        got[side] = [{k: v for k, v in e.items()
                      if k not in ("ts", "host", "trace", "span")}
                     for e in read_events(path)
                     if e["ev"] not in ("span.open", "span.close")]
        if side == "port":
            fits_schema(read_events(path))
    assert got["port"] == got["jax"]
    assert [e["ev"] for e in got["port"]].count("server.restart") == 2
