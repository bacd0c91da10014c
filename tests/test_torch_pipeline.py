"""The port's pipeline driver and CLI (``avenir_tpu_torch/pipeline``) and
its retried chunk stream (``jobs/base.py``), on the CPU.

A fused NB + MI pipeline writes the same part files as the same pipeline
with ``scan.fuse=false`` (byte for byte) and as the JAX package's
``Pipeline`` on the same conf (NB byte for byte, MI within abs 2e-6), in
one chunk and streamed; the counters are the JAX package's.  The keys the
port cannot honour are refused before anything is written.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from avenir_tpu.core.config import JobConfig as JConfig  # noqa: E402
from avenir_tpu.core.encoding import DatasetEncoder as JEncoder  # noqa: E402
from avenir_tpu.core.schema import FeatureSchema as JSchema  # noqa: E402
from avenir_tpu.jobs.base import Job as JJob  # noqa: E402
from avenir_tpu.pipeline import driver as jdriver  # noqa: E402
from avenir_tpu.runtime import native as jnative  # noqa: E402
from avenir_tpu.utils.metrics import Counters as JCounters  # noqa: E402
from avenir_tpu.utils.retry import FaultInjector as JFaultInjector  # noqa: E402
from avenir_tpu_torch.core.config import JobConfig  # noqa: E402
from avenir_tpu_torch.core.csv_io import write_csv  # noqa: E402
from avenir_tpu_torch.core.encoding import DatasetEncoder  # noqa: E402
from avenir_tpu_torch.core.schema import FeatureSchema  # noqa: E402
from avenir_tpu_torch.datagen.hosp_readmit import (  # noqa: E402
    HOSP_SCHEMA_JSON, generate_hosp_readmit)
from avenir_tpu_torch.jobs.base import Job  # noqa: E402
from avenir_tpu_torch.pipeline import driver  # noqa: E402
from avenir_tpu_torch.pipeline.__main__ import main as pipeline_main  # noqa: E402
from avenir_tpu_torch.pipeline.__main__ import parse_args  # noqa: E402
from avenir_tpu_torch.runtime import native  # noqa: E402
from avenir_tpu_torch.utils.metrics import Counters  # noqa: E402
from avenir_tpu_torch.utils.retry import (  # noqa: E402
    FaultInjector, TaskExhaustedError)

REPO = pathlib.Path(__file__).resolve().parent.parent
TOL = 2e-6
ARTIFACTS = ("nb_model", "mi_out")


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    work = tmp_path_factory.mktemp("pipeline")
    write_csv(str(work / "train.csv"), generate_hosp_readmit(3000, seed=3))
    (work / "hosp.json").write_text(json.dumps(HOSP_SCHEMA_JSON))
    return work


def _props(work, **extra):
    props = {
        "pipeline.stages": "nb,mi",
        "pipeline.bind.train": str(work / "train.csv"),
        "pipeline.stage.nb.job": "BayesianDistribution",
        "pipeline.stage.nb.input": "train",
        "pipeline.stage.nb.output": "nb_model",
        "pipeline.stage.mi.job": "MutualInformation",
        "pipeline.stage.mi.input": "train",
        "pipeline.stage.mi.output": "mi_out",
        "feature.schema.file.path": str(work / "hosp.json"),
        "mutual.info.score.algorithms": "mim,mifs,jmi,disr,mrmr",
    }
    props.update(extra)
    return props


def _parts(ws):
    return {a: pathlib.Path(ws, a, "part-00000").read_bytes()
            for a in ARTIFACTS}


def _run_port(work, ws, **extra):
    p = driver.Pipeline.from_conf(JobConfig(_props(work, **extra)),
                                  workspace=str(work / ws), device="cpu")
    counters = p.run()
    return p, {k: v.as_dict() for k, v in counters.items()}, _parts(work / ws)


def _run_jax(work, ws, **extra):
    p = jdriver.Pipeline.from_conf(JConfig(_props(work, **extra)),
                                   workspace=str(work / ws))
    counters = p.run()
    return {k: v.as_dict() for k, v in counters.items()}, _parts(work / ws)


def _same_mi(got: bytes, want: bytes) -> None:
    got, want = got.decode().splitlines(), want.decode().splitlines()
    assert len(got) == len(want) > 0
    for lg, lw in zip(got, want):
        fg, fw = lg.split(","), lw.split(",")
        assert len(fg) == len(fw), (lg, lw)
        for a, b in zip(fg, fw):
            try:
                assert abs(float(a) - float(b)) <= TOL, (lg, lw)
            except ValueError:
                assert a == b, (lg, lw)


def test_from_conf_reads_stages_bindings_and_props(env):
    props = _props(env, **{"pipeline.stage.mi.prop.laplace.smoothing": "2",
                           "pipeline.stage.mi.uses": "nb_model"})
    p = driver.Pipeline.from_conf(JobConfig(props), workspace="ws")
    jp = jdriver.Pipeline.from_conf(JConfig(props), workspace="ws")
    assert [(s.name, s.job, s.input, s.output, s.props, tuple(s.uses))
            for s in p.stages] == [
        (s.name, s.job, s.input, s.output, s.props, tuple(s.uses))
        for s in jp.stages]
    assert p.bindings == jp.bindings
    assert p.path("train") == str(env / "train.csv")
    assert p.path("mi_out") == os.path.join("ws", "mi_out")
    with pytest.raises(Exception, match="pipeline.stages"):
        driver.Pipeline.from_conf(JobConfig({}))


@pytest.mark.parametrize("chunk", [None, "700"])
def test_fused_run_equals_unfused_and_the_jax_pipeline(env, chunk):
    extra = {"stream.chunk.rows": chunk} if chunk else {}
    tag = chunk or "whole"
    _p, fused, parts = _run_port(env, f"fused_{tag}", **extra)
    _p, unfused, parts_unfused = _run_port(
        env, f"unfused_{tag}", **{**extra, "scan.fuse": "false"})
    jfused, jparts = _run_jax(env, f"jax_{tag}", **extra)
    assert parts == parts_unfused
    assert parts["nb_model"] == jparts["nb_model"]
    _same_mi(parts["mi_out"], jparts["mi_out"])
    assert fused == jfused
    chunks = 5 if chunk else 1
    for stage in ("nb", "mi"):
        assert fused[stage]["SharedScan"] == {
            "FusedStages": 2, "Scans": 1, "Chunks": chunks}
        assert "SharedScan" not in unfused[stage]
        assert fused[stage]["Records"] == {"Processed": 3000}
    if chunk:
        assert fused["nb"]["Task"] == {"attempts": 6}
        assert fused["nb"]["Telemetry"] == {"recompiles": 1}
        assert unfused["mi"]["Task"] == {"attempts": 6}


def test_per_stage_opt_out_breaks_the_group(env):
    extra = {"pipeline.stage.mi.prop.scan.fuse": "false"}
    _p, counters, parts = _run_port(env, "optout", **extra)
    jcounters, jparts = _run_jax(env, "jax_optout", **extra)
    assert "SharedScan" not in counters["nb"]
    assert "SharedScan" not in counters["mi"]
    assert counters == jcounters
    assert parts["nb_model"] == jparts["nb_model"]
    _same_mi(parts["mi_out"], jparts["mi_out"])


def test_resume_skips_finished_stages_and_rollup_sums(env):
    ws = env / "resume"
    p, first, parts = _run_port(env, "resume")
    assert p.rollup().as_dict()["Records"] == {"Processed": 6000}
    os.remove(ws / "mi_out" / "part-00000")
    os.rmdir(ws / "mi_out")
    p2 = driver.Pipeline.from_conf(JobConfig(_props(env)),
                                   workspace=str(ws), device="cpu")
    counters = {k: v.as_dict() for k, v in p2.run(resume=True).items()}
    assert counters["nb"] == {"Pipeline": {"skipped": 1}}
    assert "SharedScan" not in counters["mi"]          # a group of one
    assert counters["mi"]["Records"] == {"Processed": 3000}
    assert _parts(ws) == parts
    assert p2.rollup().as_dict() == {"Pipeline": {"skipped": 1},
                                     "Records": {"Processed": 3000}}


def test_cli_runs_the_pipeline_on_the_cpu_in_a_subprocess(env, tmp_path):
    conf = tmp_path / "pipeline.properties"
    conf.write_text("\n".join(f"{k}={v}" for k, v in _props(env).items()))
    ws = tmp_path / "ws"
    envv = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "avenir_tpu_torch.pipeline", "run", str(conf),
         f"-Dpipeline.workspace={ws}", "-Dstream.chunk.rows=1000",
         "--device", "cpu"],
        cwd=str(REPO), env=envv, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "stage nb" in res.stdout and "stage mi" in res.stdout
    assert "\tFusedStages=2" in res.stdout and "\tChunks=3" in res.stdout
    _p, _c, parts = _run_port(env, "cli_ref",
                              **{"stream.chunk.rows": "1000"})
    assert _parts(ws) == parts


def test_cli_arguments_and_the_plan_verb(env):
    assert parse_args(["run", "c.properties", "-Da=1", "--resume",
                       "--device", "cpu"]) == (
        "run", "c.properties", {"a": "1"}, True, "cpu")
    assert parse_args(["plan", "explain", "c.properties"])[:2] == (
        "plan", "c.properties")
    with pytest.raises(SystemExit):
        parse_args(["run", "c.properties", "--bogus"])
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        pipeline_main(["plan", "c.properties"])


REFUSED = {
    "plan": {"plan.on": "true"},
    "shard": {"shard.devices": "2"},
    "tenant": {"tenant.alpha.share": "2"},
    "tenant pool": {"avenir.tenant.pool.concurrency": "2"},
    "stage shard": {"pipeline.stage.mi.prop.shard.data.axis": "data"},
    "stage tenant": {"pipeline.stage.mi.prop.tenant.queue.depth": "4"},
}
# keys the pipeline refused until the port's telemetry honoured them
HONOURED = {
    "trace": {"trace.on": "true"},
    "profile": {"profile.on": "true"},
    "tenant id": {"tenant.id": "alpha"},
    "trace.xla.dir": {"trace.xla.dir": "xla"},
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refused_keys_raise_before_anything_is_written(env, case):
    ws = env / f"refused_{case.replace(' ', '_')}"
    p = driver.Pipeline.from_conf(JobConfig(_props(env, **REFUSED[case])),
                                  workspace=str(ws), device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        p.run()
    assert not ws.exists()


@pytest.mark.parametrize("case", sorted(HONOURED))
def test_honoured_keys_run_with_the_same_part_files(env, case, tmp_path):
    """Each telemetry key the pipeline once refused now runs, its part
    files equal to the untraced run's; the tracer and profiler it enabled
    are turned off again."""
    from avenir_tpu_torch.telemetry import spans as tel

    extra = dict(HONOURED[case])
    extra["trace.journal.dir"] = str(tmp_path / "tel")
    if "trace.xla.dir" in extra:
        extra["trace.xla.dir"] = str(tmp_path / "xla")
    try:
        _p, counters, parts = _run_port(env, f"honoured_{case}", **extra)
    finally:
        tel.tracer().disable()
    _p0, counters0, parts0 = _run_port(env, f"honoured_{case}_off")
    assert parts == parts0
    assert counters == counters0


def test_switches_that_are_off_run(env):
    extra = {"plan.on": "false", "trace.on": "false", "profile.on": "false"}
    _p, counters, parts = _run_port(env, "switches_off", **extra)
    assert counters["nb"]["SharedScan"]["FusedStages"] == 2


def test_unported_count_job_raises_naming_its_queue_item(env):
    """A Cramér stage, which the pipeline refused until the correlation
    jobs were ported, now fuses with NB + MI into one SharedScan, and its
    part file equals the standalone CramerCorrelation job's."""
    from avenir_tpu_torch.jobs import get_job

    props = _props(env, **{
        "pipeline.stages": "nb,mi,cramer",
        "pipeline.stage.cramer.job": "CramerCorrelation",
        "pipeline.stage.cramer.input": "train",
        "pipeline.stage.cramer.output": "cramer_out",
        "pipeline.stage.cramer.prop.dest.attributes": "11",
        "stream.chunk.rows": "700"})
    ws = env / "cramer"
    p = driver.Pipeline.from_conf(JobConfig(props), workspace=str(ws),
                                  device="cpu")
    counters = {k: v.as_dict() for k, v in p.run().items()}
    for stage in ("nb", "mi", "cramer"):
        assert counters[stage]["SharedScan"] == {
            "FusedStages": 3, "Scans": 1, "Chunks": 5}
    conf = JobConfig({"feature.schema.file.path": str(env / "hosp.json"),
                      "stream.chunk.rows": "700", "dest.attributes": "11"})
    get_job("CramerCorrelation").run(conf, str(env / "train.csv"),
                                     str(env / "cramer_alone"), device="cpu")
    got = pathlib.Path(ws, "cramer_out", "part-00000").read_bytes()
    assert got == pathlib.Path(env, "cramer_alone", "part-00000").read_bytes()
    assert got.decode().splitlines()[0].startswith("age,class,")


def test_decision_tree_pipeline_equals_the_standalone_jobs(env):
    from avenir_tpu_torch.jobs import get_job

    conf = JobConfig({"feature.schema.file.path": str(env / "hosp.json"),
                      "max.depth": "3"})
    p = driver.decision_tree_pipeline(str(env / "tree_ws"), conf,
                                      str(env / "train.csv"), device="cpu")
    counters = p.run()
    assert sorted(counters) == ["splitGenerator", "treeBuilder"]
    for stage, job in (("splits", "ClassPartitionGenerator"),
                       ("tree", "DecisionTreeBuilder")):
        out = env / f"tree_ref_{stage}"
        get_job(job).run(conf, str(env / "train.csv"), str(out), device="cpu")
        assert ((env / "tree_ws" / stage / "part-00000").read_bytes()
                == (out / "part-00000").read_bytes())


def _knn_rows(rng, n, start):
    rows = np.empty((n, 6), dtype=object)
    rows[:, 0] = [f"r{start + i}" for i in range(n)]
    codes = rng.integers(0, 5, size=(n, 2))
    cont = rng.normal(size=(n, 2))
    for j in range(2):
        rows[:, 1 + j] = [f"v{v}" for v in codes[:, j]]
        rows[:, 3 + j] = [f"{v:.6f}" for v in cont[:, j]]
    rows[:, 5] = np.where(cont[:, 0] + (codes[:, 0] < 2)
                          + rng.normal(0, 1, n) > 0.5, "b", "a")
    return rows


KNN_SCHEMA = {"fields": (
    [{"name": "id", "ordinal": 0, "id": True, "dataType": "string"}]
    + [{"name": f"c{j}", "ordinal": 1 + j, "dataType": "categorical",
        "feature": True, "cardinality": [f"v{v}" for v in range(5)]}
       for j in range(2)]
    + [{"name": f"x{j}", "ordinal": 3 + j, "dataType": "double",
        "feature": True} for j in range(2)]
    + [{"name": "label", "ordinal": 5, "dataType": "categorical",
        "cardinality": ["a", "b"]}])}


@pytest.mark.parametrize("class_cond", [False, True])
def test_knn_pipeline_equals_the_jax_pipeline(tmp_path, class_cond):
    rng = np.random.default_rng(71)
    write_csv(str(tmp_path / "train.csv"), _knn_rows(rng, 600, 0))
    write_csv(str(tmp_path / "test.csv"), _knn_rows(rng, 80, 600))
    (tmp_path / "s.json").write_text(json.dumps(KNN_SCHEMA))
    props = {"feature.schema.file.path": str(tmp_path / "s.json"),
             "top.match.count": "5"}
    p = driver.knn_pipeline(str(tmp_path / "ws"), JobConfig(dict(props)),
                            str(tmp_path / "train.csv"),
                            str(tmp_path / "test.csv"),
                            class_cond=class_cond, device="cpu")
    p.run()
    jdriver.knn_pipeline(str(tmp_path / "jws"), JConfig(dict(props)),
                         str(tmp_path / "train.csv"),
                         str(tmp_path / "test.csv"),
                         class_cond=class_cond).run()
    # the NB model's Gaussian moments of normal data are float32 sums in
    # another order (equal only where the sums are exact, Port contracts),
    # so its file is not compared; the predictions made with it are
    got = (tmp_path / "ws" / "predictions" / "part-00000").read_bytes()
    assert len(got.splitlines()) == 80
    assert got == (tmp_path / "jws" / "predictions" / "part-00000").read_bytes()


def _two_part_input(tmp_path):
    d = tmp_path / "parts"
    d.mkdir()
    write_csv(str(d / "part-00000"), generate_hosp_readmit(1000, seed=1))
    write_csv(str(d / "part-00001"), generate_hosp_readmit(450, seed=2))
    (tmp_path / "h.json").write_text(json.dumps(HOSP_SCHEMA_JSON))
    return d, {"feature.schema.file.path": str(tmp_path / "h.json"),
               "stream.chunk.rows": "400"}


@pytest.mark.parametrize("owned", [None, "even"])
def test_iter_encoded_retrying_cursors_equal_the_jax_ones(tmp_path, owned):
    d, props = _two_part_input(tmp_path)
    owner = None if owned is None else (lambda idx: idx % 2 == 0)
    enc = DatasetEncoder(FeatureSchema.from_json(HOSP_SCHEMA_JSON))
    jenc = JEncoder(JSchema.from_json(HOSP_SCHEMA_JSON))
    counters, jcounters = Counters(), JCounters()
    got = list(Job.iter_encoded_retrying(
        JobConfig(dict(props)), str(d), enc, counters, emit_cursor=True,
        owner=owner))
    want = list(JJob.iter_encoded_retrying(
        JConfig(dict(props)), str(d), jenc, jcounters, emit_cursor=True,
        owner=owner))
    assert [c for _, c in got] == [c for _, c in want]
    assert len(got) == (5 if owned is None else 3)
    for (ds, _), (jds, _) in zip(got, want):
        np.testing.assert_array_equal(ds.codes, jds.codes)
        np.testing.assert_array_equal(ds.labels, jds.labels)
    assert counters.as_dict() == jcounters.as_dict()
    lines = list(Job.iter_line_chunks_retrying(
        JobConfig(dict(props)), str(d), Counters(), emit_index=True))
    assert lines == list(JJob.iter_line_chunks_retrying(
        JConfig(dict(props)), str(d), JCounters(), emit_index=True))


@pytest.mark.parametrize("fail_on,attempts", [((1,), 2), ((1, 2), 2),
                                              ((1, 2), 3)])
def test_injected_faults_retry_then_exhaust_as_the_jax_stream(
        tmp_path, monkeypatch, fail_on, attempts):
    d, props = _two_part_input(tmp_path)
    props["mapred.map.max.attempts"] = str(attempts)
    results = {}
    for pkg, mod, inj, job, conf_cls, cnt_cls, enc in (
            ("torch", native, FaultInjector, Job, JobConfig, Counters,
             DatasetEncoder(FeatureSchema.from_json(HOSP_SCHEMA_JSON))),
            ("jax", jnative, JFaultInjector, JJob, JConfig, JCounters,
             JEncoder(JSchema.from_json(HOSP_SCHEMA_JSON)))):
        monkeypatch.setattr(mod, "encode_bytes",
                            inj(mod.encode_bytes, fail_on=fail_on))
        counters = cnt_cls()
        try:
            n = len(list(job.iter_encoded_retrying(
                conf_cls(dict(props)), str(d), enc, counters)))
            err = None
        except Exception as e:           # noqa: BLE001 — compared below
            n, err = None, type(e).__name__
        results[pkg] = (n, err, counters.as_dict())
    assert results["torch"] == results["jax"]
    n, err, counts = results["torch"]
    if len(fail_on) >= attempts:
        assert err == TaskExhaustedError.__name__ and n is None
        assert counts["Task"] == {"attempts": attempts,
                                  "failed.attempts": attempts,
                                  "exhausted": 1}
    else:
        assert err is None and n == 5
        assert counts["Task"]["failed.attempts"] == len(fail_on)
