"""The port's program registry and device-memory gauges
(``avenir_tpu_torch/telemetry/profile.py``), the regression sentinel and
``utils/profiling.py``, on the CPU; copies of ``tests/test_profile.py``
where they apply, each held against the JAX package on the same input.

Where the JAX package captures XLA's cost analysis, the port records a
hand-written kernel's analytic cost (``kernel_cost``: the bytes and
operations of PERF.md §6's bound) and shapes elsewhere.  Memory gauges
read ``torch.cuda``; on the CPU they record nothing, and the journal
shape is pinned with ``torch.cuda``'s counters replaced.
"""

import contextlib
import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from avenir_tpu.telemetry import profile as jprof_mod  # noqa: E402
from avenir_tpu.telemetry import sentinel as jsentinel  # noqa: E402
from avenir_tpu.telemetry import spans as jtel  # noqa: E402
from avenir_tpu.utils import metrics as jmetrics  # noqa: E402
from avenir_tpu_torch.core.config import JobConfig  # noqa: E402
from avenir_tpu_torch.core.csv_io import write_csv  # noqa: E402
from avenir_tpu_torch.core.encoding import DatasetEncoder  # noqa: E402
from avenir_tpu_torch.core.schema import FeatureSchema  # noqa: E402
from avenir_tpu_torch.datagen.hosp_readmit import (  # noqa: E402
    HOSP_SCHEMA_JSON, generate_hosp_readmit)
from avenir_tpu_torch.jobs import get_job  # noqa: E402
from avenir_tpu_torch.ops import hist  # noqa: E402
from avenir_tpu_torch.telemetry import profile as prof_mod  # noqa: E402
from avenir_tpu_torch.telemetry import sentinel  # noqa: E402
from avenir_tpu_torch.telemetry import spans as tel  # noqa: E402
from avenir_tpu_torch.telemetry.__main__ import main as tel_main  # noqa: E402
from avenir_tpu_torch.telemetry.journal import read_events  # noqa: E402
from avenir_tpu_torch.utils.metrics import Counters, percentile_of  # noqa: E402


@pytest.fixture(autouse=True)
def _fresh_planes():
    """Tracer and profiler of both packages are process-wide; every test
    starts and ends with all of them off (``Tracer.disable`` tears the
    profiler down too)."""
    for t in (tel, jtel):
        t.tracer().disable()
    assert not prof_mod.profiler().enabled
    yield
    for t in (tel, jtel):
        t.tracer().disable()


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    root = tmp_path_factory.mktemp("profile")
    write_csv(str(root / "train.csv"), generate_hosp_readmit(320, seed=11))
    (root / "hosp.json").write_text(json.dumps(HOSP_SCHEMA_JSON))
    return root


def _streamed(ws, tmp_path, **extra):
    props = {"feature.schema.file.path": str(ws / "hosp.json"),
             "stream.chunk.rows": "150",           # 320 → 150 + 150 + 20
             "trace.journal.dir": str(tmp_path / "tel"), **extra}
    return get_job("BayesianDistribution").run(
        JobConfig(props), str(ws / "train.csv"), str(tmp_path / "nb"),
        device="cpu")


@contextlib.contextmanager
def _fake_cuda_memory(monkeypatch, in_use, peak):
    """``torch.cuda``'s allocator counters replaced by fixed readings per
    device index, so the gauge path runs without a card."""
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda i=None: in_use[i])
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda i=None: peak[i])
    yield


# ---------------------------------------------------------------------------
# the registry: off is free, one event per key, analytic cost, races
# ---------------------------------------------------------------------------

def test_profiler_off_is_free_and_records_nothing():
    prof = prof_mod.profiler()
    assert not prof.enabled
    assert prof.observe(("k",), site="s") is None
    prof.sample(("k",), "s", 0.1)
    prof.sample_device_memory("s", devices=[torch.device("cuda", 0)])
    assert prof.stats() == []
    assert prof.gauges() == {}


def test_registry_one_compiled_event_per_distinct_key(tmp_path):
    tracer = tel.tracer().enable(str(tmp_path))
    prof = prof_mod.profiler().enable()
    with tracer.span("run"):
        for _ in range(3):
            prof.observe(("k1",), site="seam")
        prof.observe(("k2",), site="seam")
        prof.observe(("k1",), site="other")
        prof.sample(("k1",), "seam", 0.010)
        prof.sample(("k1",), "seam", 0.020)
    path = tracer.journal_path
    tel.tracer().disable()
    events = read_events(path)
    compiled = [e for e in events if e["ev"] == "program.compiled"]
    assert len(compiled) == 3
    assert len({e["key"] for e in compiled}) == 3
    assert {e["key"] for e in compiled} == {
        jprof_mod.program_id(s, k) for s, k in
        (("seam", ("k1",)), ("seam", ("k2",)), ("other", ("k1",)))}
    totals = {e["key"]: e for e in events if e["ev"] == "program.profile"}
    k1 = prof_mod.program_id("seam", ("k1",))
    assert totals[k1]["dispatches"] == 2
    assert totals[k1]["wall_ms"] == pytest.approx(30.0, abs=1.0)


def test_kernel_cost_is_the_bound_of_the_kernel_table():
    """``scan.chunk`` on the kernel route costs what PERF.md §6's B1 row
    bounds: the hospital MI chunk (10 × 13 × 2, fmaj wp 384, 250K rows)
    reads its codes and labels once and writes G once."""
    cost = prof_mod.kernel_cost("scan.chunk", 10, 13, 2, 250_000)
    assert hist.plan(10, 13, 2) == ("fmaj", 32, 384)
    assert cost["bytes_accessed"] == 4 * 10 * 250_000 + 4 * 250_000 \
        + 4 * 384 * 384
    assert cost["flops"] == 260 * 261 * 250_000
    assert cost["output_bytes"] == 4 * 384 * 384
    assert cost["temp_bytes"] is None
    # per-class plan modes count one G per class over F·B lanes
    mode, _jcp, wp = hist.plan(20, 20, 2)
    assert mode == "cls"
    assert hist.gram_cells(20, 20, 2) == (2 * wp * wp, 400)
    # gram_moments: the continuous block read once, moments written once
    mixed = prof_mod.kernel_cost("scan.chunk", 7, 4, 2, 1000, num_cont=3)
    plain = prof_mod.kernel_cost("scan.chunk", 7, 4, 2, 1000)
    assert mixed["bytes_accessed"] - plain["bytes_accessed"] == \
        4 * 1000 * 3 + 8 * 2 * 7
    assert mixed["flops"] - plain["flops"] == 4 * 1000 * 3
    for site in ("stream", "tree.level", "scan"):
        assert prof_mod.kernel_cost(site, 10, 13, 2, 100) is None


def test_registry_analytic_cost_and_shapes_only(tmp_path):
    tracer = tel.tracer().enable(str(tmp_path))
    prof = prof_mod.profiler().enable()
    cost = prof_mod.kernel_cost("scan.chunk", 10, 13, 2, 1000)
    with tracer.span("run"):
        prof.observe(("kernel",), site="scan.chunk", cost=cost)
        prof.observe(("bare",), site="stream")
    path = tracer.journal_path
    tel.tracer().disable()
    by_shapes = {e["shapes"]: e for e in read_events(path)
                 if e["ev"] == "program.compiled"}
    rec = by_shapes["('kernel',)"]
    assert rec["source"] == "analytic"
    assert rec["bytes_accessed"] == cost["bytes_accessed"]
    assert rec["flops"] == cost["flops"]
    bare = by_shapes["('bare',)"]
    assert bare["source"] == "shapes" and bare["flops"] is None


def test_scan_chunk_costs_only_the_kernel_route(ws):
    """On the CPU the fold takes a plain route and records shapes; the
    kernel route's cost is ``kernel_cost``'s for the chunk's rows."""
    from avenir_tpu_torch.pipeline import scan

    enc = DatasetEncoder(FeatureSchema.from_json(HOSP_SCHEMA_JSON))
    ds = enc.fit_transform(generate_hosp_readmit(200, seed=1))
    folder = scan.ChunkFolder([scan.MutualInfoConsumer()], ds, "cpu")
    assert folder.step != "kernel" and folder.cost(ds) is None
    folder.step = "kernel"
    assert folder.cost(ds) == prof_mod.kernel_cost(
        "scan.chunk", ds.num_binned, ds.max_bins, ds.num_classes, 200)


def test_registry_threaded_dispatch_race_one_event_per_key(tmp_path):
    tracer = tel.tracer().enable(str(tmp_path))
    prof = prof_mod.profiler().enable()
    counters = Counters()
    first = tel.CompileKeyMonitor(counters, group="A", scope="a")
    second = tel.CompileKeyMonitor(counters, group="B", scope="b")
    keys = [((1024, "int32"),), ((512, "int32"),), ((64, "int32"),)]
    per_thread = 200
    errs = []

    def worker(monitor, site, shift):
        try:
            for i in range(per_thread):
                monitor.observe([keys[(i + shift) % len(keys)]])
                prof.sample(keys[(i + shift) % len(keys)], site, 0.001)
        except BaseException as e:                # surfaced below
            errs.append(e)

    threads = ([threading.Thread(target=worker, args=(first, "a", 0))
                for _ in range(4)]
               + [threading.Thread(target=worker, args=(second, "b", 1))
                  for _ in range(4)])
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert not errs, errs
    assert sum(r["dispatches"] for r in prof.stats()) == 8 * per_thread
    path = tracer.journal_path
    tel.tracer().disable()
    events = read_events(path)
    compiled = [e for e in events if e["ev"] == "program.compiled"]
    assert len(compiled) == 6
    assert len({(e["site"], e["key"]) for e in compiled}) == 6
    totals = {e["key"]: e["dispatches"] for e in events   # cumulative:
              if e["ev"] == "program.profile"}            # the last wins
    assert sum(totals.values()) == 8 * per_thread


# ---------------------------------------------------------------------------
# the chunk-stream seam and the tree's level program
# ---------------------------------------------------------------------------

def test_chunk_stream_program_parity_with_recompile_monitor(ws, tmp_path):
    """320 rows at 150 a chunk: two distinct dispatch shapes, so two
    programs and one recompile, as in the JAX package; the program ids
    are the JAX package's for the same shapes.  One device (no data mesh
    to pad the chunks), as on one card."""
    counters = _streamed(ws, tmp_path, **{"trace.on": "true",
                                          "profile.on": "true",
                                          "data.parallel.auto": "false"})
    path = tel.tracer().journal_path
    tel.tracer().disable()
    events = read_events(path)
    programs = [e for e in events if e["ev"] == "program.compiled"
                and e["site"] == "stream"]
    assert len(programs) == 2
    assert counters.get("Telemetry", "recompiles") == 1
    ids = {e["key"] for e in programs}
    want = {jprof_mod.program_id("stream", (((n, 10), "int32"), ((n,), "int32"),
                                            ((n, 0), "float32")))
            for n in (150, 20)}
    assert ids == want
    chunk_spans = [e for e in events if e["ev"] == "span.open"
                   and e["name"] == "chunk"]
    assert len(chunk_spans) == 3
    assert {e["attrs"]["program"] for e in chunk_spans} == ids
    assert sum(e["dispatches"] for e in events
               if e["ev"] == "program.profile" and e["site"] == "stream") == 3


def test_trace_without_profile_registers_no_programs(ws, tmp_path):
    _streamed(ws, tmp_path, **{"trace.on": "true"})
    path = tel.tracer().journal_path
    tel.tracer().disable()
    evs = {e["ev"] for e in read_events(path)}
    assert not evs & {"program.compiled", "program.profile", "device.memory"}


def test_tree_level_program_per_distinct_key(ws, tmp_path):
    """A traced, profiled tree registers one ``tree.level`` program per
    distinct selection shape, and its dispatches are the levels grown."""
    from avenir_tpu_torch.models.tree import DecisionTree

    enc = DatasetEncoder(FeatureSchema.from_json(HOSP_SCHEMA_JSON))
    ds = enc.fit_transform(generate_hosp_readmit(3000, seed=2))
    is_cat = [f.is_categorical for f in enc.binned_fields]
    tracer = tel.tracer().enable(str(tmp_path))
    prof = prof_mod.profiler().enable()
    with tracer.span("fit"):
        DecisionTree(max_depth=4, min_node_size=32, device="cpu",
                     collect_phase_stats=True).fit(ds, is_cat)
    stats = [r for r in prof.stats() if r["site"] == "tree.level"]
    path = tracer.journal_path
    tel.tracer().disable()
    compiled = [e for e in read_events(path)
                if e["ev"] == "program.compiled" and e["site"] == "tree.level"]
    assert len(compiled) == len(stats) == len({e["key"] for e in compiled})
    assert all(e["source"] == "shapes" for e in compiled)
    assert sum(r["dispatches"] for r in stats) == 4


# ---------------------------------------------------------------------------
# device-memory gauges
# ---------------------------------------------------------------------------

def test_cpu_devices_are_a_noop(tmp_path):
    """On the CPU the sampler records nothing: a CPU device, or no device
    while CUDA is not initialized in the process (the JAX package's CPU
    transport reports no stats either)."""
    tracer = tel.tracer().enable(str(tmp_path))
    prof = prof_mod.profiler().enable()
    with tracer.span("run"):
        prof.sample_device_memory("chunk", [torch.device("cpu")])
        if not torch.cuda.is_initialized():
            prof.sample_device_memory("chunk")
    assert prof.gauges() == {}
    path = tracer.journal_path
    tel.tracer().disable()
    assert [e for e in read_events(path) if e["ev"] == "device.memory"] == []


def test_device_memory_gauges_journal_and_prometheus(tmp_path, monkeypatch):
    from avenir_tpu_torch.telemetry.export import prometheus_text

    tracer = tel.tracer().enable(str(tmp_path))
    prof = prof_mod.profiler().enable()
    with _fake_cuda_memory(monkeypatch, {0: 100, 1: 300}, {0: 200, 1: 400}), \
            tracer.span("run"):
        prof.sample_device_memory(
            "pane", devices=[torch.device("cuda", 0), torch.device("cuda", 1),
                             torch.device("cpu")])
    gauges = prof.gauges()
    assert gauges[("cuda:0", "bytes_in_use")] == 100.0
    assert gauges[("cuda:1", "peak_bytes")] == 400.0
    text = prometheus_text(device_bytes=gauges)
    assert ('avenir_device_bytes{device="cuda:0",kind="bytes_in_use"} '
            '100') in text
    path = tracer.journal_path
    tel.tracer().disable()
    mem = [e for e in read_events(path) if e["ev"] == "device.memory"]
    assert {(e["device"], e["bytes_in_use"], e["peak_bytes"])
            for e in mem} == {("cuda:0", 100, 200), ("cuda:1", 300, 400)}
    assert all(e["site"] == "pane" for e in mem)


def test_device_memory_sampling_interval(tmp_path, monkeypatch):
    tracer = tel.tracer().enable(str(tmp_path))
    prof = prof_mod.profiler().enable(memory_sample=3)
    with _fake_cuda_memory(monkeypatch, {0: 1}, {0: 2}), tracer.span("run"):
        for _ in range(7):                   # calls 0..6: sampled 0, 3, 6
            prof.sample_device_memory("chunk", [torch.device("cuda", 0)])
    path = tracer.journal_path
    tel.tracer().disable()
    assert len([e for e in read_events(path)
                if e["ev"] == "device.memory"]) == 3


# ---------------------------------------------------------------------------
# the profile and metrics CLIs over a real traced run
# ---------------------------------------------------------------------------

def test_profile_cli_renders_roofline_table(ws, tmp_path, capsys):
    _streamed(ws, tmp_path, **{"trace.on": "true", "profile.on": "true"})
    tel.tracer().event("canary", ms=5.0, when="probe")
    path = tel.tracer().journal_path
    tel.tracer().disable()
    assert tel_main(["profile", path]) == 0
    out = capsys.readouterr().out
    assert "MFU%" in out and "disp" in out and "GFLOP/s" in out
    assert "peak:" in out and "TFLOP/s" in out
    lines = [ln for ln in out.splitlines() if " stream " in ln]
    assert lines and sum(int(ln.split()[2]) for ln in lines) == 3


def test_profile_cli_without_programs_says_so(tmp_path, capsys):
    tracer = tel.tracer().enable(str(tmp_path))
    with tracer.span("run"):
        pass
    path = tracer.journal_path
    tel.tracer().disable()
    assert tel_main(["profile", path]) == 0
    assert "no program.compiled" in capsys.readouterr().out


def test_metrics_cli_post_hoc_prometheus(tmp_path, capsys, monkeypatch):
    tracer = tel.tracer().enable(str(tmp_path))
    prof = prof_mod.profiler().enable()
    counters = Counters()
    counters.increment("Records", "Processed", 42)
    with _fake_cuda_memory(monkeypatch, {0: 5}, {0: 6}), tracer.span("run"):
        tracer.counters("stage1", counters)
        counters.increment("Records", "Processed", 8)
        tracer.counters("pipeline", counters)
        tracer.gauge("serve.queue.m", 2)
        prof.sample_device_memory("pane", [torch.device("cuda", 0)])
    path = tracer.journal_path
    tel.tracer().disable()
    assert tel_main(["metrics", path]) == 0
    out = capsys.readouterr().out
    assert "# last counter snapshot scope: pipeline" in out
    assert ('avenir_counter_total{group="Records",name="Processed"} 50'
            in out)
    assert 'avenir_gauge{name="serve.queue.m"} 2' in out
    assert 'avenir_device_bytes{device="cuda:0",kind="bytes_in_use"} 5' \
        in out


# ---------------------------------------------------------------------------
# the perf-regression sentinel, held against the JAX package's
# ---------------------------------------------------------------------------

# clean canary readings lie below both the card's bar (rig_canary's
# CANARY_HEALTHY_MS) and the JAX package's TPU bar of 7 ms, so the two
# sentinels' verdicts agree on them
def _bench_line(value=200.0, clean=True, fam_tree=10.0, knn=5000.0):
    return {
        "metric": "nb_mi_pipeline_throughput",
        "value": value, "unit": "rows/sec/chip",
        "value_canary_clean": value if clean else None,
        "canary_clean_passes": 3 if clean else 0,
        "canary_matmul_4096_bf16_ms": 0.21 if clean else 180.0,
        "knn": {"value": knn, "unit": "queries/sec/chip",
                "canary_matmul_4096_bf16_ms": 0.2 if clean else 190.0},
        "families": {"tree": {
            "value": fam_tree, "unit": "rows/sec/chip",
            "canary_per_pass_ms": [0.22, 0.19] if clean else [180.0, 167.0]}},
    }


SENTINEL_CASES = {
    "clean": (_bench_line(value=195.0), _bench_line(), {}, "pass"),
    "regression": (_bench_line(value=140.0), _bench_line(), {},
                   "regression"),
    "canary flagged": (_bench_line(clean=False), _bench_line(), {}, "skip"),
    "missing metric": ({k: v for k, v in _bench_line().items()
                        if k != "families"}, _bench_line(), {},
                       "regression"),
    "per-metric band": ({"parsed": _bench_line(fam_tree=6.0)},
                        {"parsed": _bench_line(fam_tree=10.0)},
                        {"families.tree": 50.0}, "pass"),
}


@pytest.mark.parametrize("case", sorted(SENTINEL_CASES))
def test_sentinel_verdicts_equal_jax(case):
    current, baseline, per_metric, verdict = SENTINEL_CASES[case]
    ours = sentinel.evaluate(current, baseline, per_metric=per_metric)
    assert ours["verdict"] == verdict
    assert ours == jsentinel.evaluate(current, baseline,
                                      per_metric=per_metric)


def test_sentinel_flags_a_reading_between_the_bars():
    # 3 ms of 4096³ bf16: contended on the card (past its bar), healthy
    # on the TPU bar the JAX package keeps — the designed difference
    between = 3.0
    assert sentinel.CANARY_HEALTHY_MS < between < jsentinel.CANARY_HEALTHY_MS
    current = _bench_line(value=140.0)
    del current["value_canary_clean"]
    current["canary_matmul_4096_bf16_ms"] = between
    baseline = {k: v for k, v in _bench_line().items()
                if k in ("metric", "value", "unit", "value_canary_clean",
                         "canary_matmul_4096_bf16_ms")}
    current = {k: current[k] for k in ("metric", "value", "unit",
                                       "canary_matmul_4096_bf16_ms")}
    ours = sentinel.evaluate(current, baseline)
    theirs = jsentinel.evaluate(current, baseline)
    assert ours["verdict"] == "skip"
    assert theirs["verdict"] == "regression"


def test_sentinel_cli_exit_codes(tmp_path, capsys):
    base = tmp_path / "base.json"
    base.write_text(json.dumps(_bench_line(value=200.0)))
    files = {}
    for name, line in (("clean", _bench_line(value=198.0)),
                       ("regressed", _bench_line(value=140.0)),
                       ("flagged", _bench_line(clean=False))):
        files[name] = tmp_path / f"{name}.json"
        files[name].write_text(json.dumps(line))
    assert tel_main(["regress", str(files["clean"]),
                     "--baseline", str(base)]) == sentinel.EXIT_PASS
    assert tel_main(["regress", str(files["regressed"]),
                     "--baseline", str(base)]) == sentinel.EXIT_REGRESSION
    assert tel_main(["regress", str(files["flagged"]),
                     "--baseline", str(base)]) == sentinel.EXIT_SKIP
    out = capsys.readouterr().out
    assert "REGRESSION" in out and "skipped_canary" in out
    assert tel_main(["regress", str(files["regressed"]), "--baseline",
                     str(base), "--tolerance",
                     "nb_mi_pipeline_throughput=40",
                     "--json"]) == sentinel.EXIT_PASS
    assert tel_main(["regress", str(base), "--baseline", str(base),
                     "--tolerance", "m=abc"]) == 2
    assert (sentinel.EXIT_PASS, sentinel.EXIT_REGRESSION,
            sentinel.EXIT_SKIP) == (jsentinel.EXIT_PASS,
                                    jsentinel.EXIT_REGRESSION,
                                    jsentinel.EXIT_SKIP)


def test_sentinel_bench_verdict_never_raises_and_journals(tmp_path):
    tracer = tel.tracer().enable(str(tmp_path / "tel"))
    with tracer.span("bench"):
        out = sentinel.bench_verdict(_bench_line(), str(tmp_path / "nope"))
    path = tracer.journal_path
    tel.tracer().disable()
    assert out["verdict"] == "no_baseline"
    evs = [e for e in read_events(path) if e["ev"] == "bench.regression"]
    assert len(evs) == 1 and evs[0]["verdict"] == "no_baseline"


# ---------------------------------------------------------------------------
# utils/profiling.py
# ---------------------------------------------------------------------------

def test_step_timer_p99_agrees_with_shared_helper():
    from avenir_tpu.utils.profiling import StepTimer as JStepTimer
    from avenir_tpu_torch.utils.profiling import StepTimer

    samples = [float(v) for v in range(1, 101)]
    timer, jtimer = StepTimer(), JStepTimer()
    timer.samples["probe"] = list(samples)
    jtimer.samples["probe"] = list(samples)
    s = timer.summary()["probe"]
    assert s == jtimer.summary()["probe"]
    assert s["count"] == 100
    assert s["p99_ms"] == percentile_of(samples, 99.0) \
        == jmetrics.percentile_of(samples, 99.0)
    assert s["max_ms"] == 100.0 and s["mean_ms"] == pytest.approx(50.5)
    with timer.step("cpu") as t:
        out = t.block_on(torch.ones(3) * 2)      # CPU: nothing to wait for
    assert out.sum().item() == 6.0 and len(timer.samples["cpu"]) == 1


def test_device_sync_returns_the_value_and_waits_on_nothing_on_the_cpu():
    from avenir_tpu_torch.utils.profiling import device_sync

    value = {"a": torch.zeros(2), "b": [np.zeros(3), torch.ones(1)]}
    assert device_sync(value) is value


def test_profiling_trace_writes_a_chrome_trace(tmp_path):
    from avenir_tpu_torch.utils import profiling

    with profiling.trace(None):
        pass
    with profiling.trace(str(tmp_path / "x"), device="cpu"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    names = list((tmp_path / "x").iterdir())
    assert len(names) == 1 and names[0].name.endswith(".pt.trace.json")
    events = json.loads(names[0].read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
