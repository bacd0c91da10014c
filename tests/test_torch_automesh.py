"""``data.parallel.auto`` in the port against the JAX package on the CPU.

``tests/conftest.py`` forces eight host devices, so both packages' jobs
run under an eight-slot data mesh by default (``Job.auto_mesh``): the JAX
package places each batch over its eight host devices and lets XLA sum
the counts; the port splits each batch into eight row blocks, counts each
block and sums the partials in shard order (``collectives.shard_sum``).

For every count job of the slice, the port's part file under the default
conf equals the JAX package's under the same conf and the port's own with
``data.parallel.auto=false``: count lines byte for byte, float fields
within the stated tolerance.  Beside them: the accumulator key family of
each route, the stale-key refusal of a stream snapshot written without
the mesh, the planner's ``sharded`` program, and ``auto_mesh`` itself.
No test binds a socket or joins a process.
"""

import contextlib
import copy
import io
import json
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from avenir_tpu.__main__ import main as jax_main  # noqa: E402
from avenir_tpu.core.config import JobConfig as JConfig  # noqa: E402
from avenir_tpu.core.encoding import DatasetEncoder as JEncoder  # noqa: E402
from avenir_tpu.core.schema import FeatureSchema as JSchema  # noqa: E402
from avenir_tpu.jobs.base import Job as JJob  # noqa: E402
from avenir_tpu.models import correlation as jcorr  # noqa: E402
from avenir_tpu.models import mutual_info as jmi  # noqa: E402
from avenir_tpu.models import naive_bayes as jnb  # noqa: E402
from avenir_tpu.ops import agg as jagg  # noqa: E402
from avenir_tpu.pipeline import driver as jdriver  # noqa: E402
from avenir_tpu.pipeline import scan as jscan  # noqa: E402
from avenir_tpu_torch.__main__ import main as torch_main  # noqa: E402
from avenir_tpu_torch.core.config import ConfigError, JobConfig  # noqa: E402
from avenir_tpu_torch.core.csv_io import write_csv  # noqa: E402
from avenir_tpu_torch.core.encoding import DatasetEncoder  # noqa: E402
from avenir_tpu_torch.core.schema import FeatureSchema  # noqa: E402
from avenir_tpu_torch.datagen.churn import (  # noqa: E402
    CHURN_SCHEMA_JSON, generate_churn)
from avenir_tpu_torch.datagen.hosp_readmit import (  # noqa: E402
    HOSP_SCHEMA_JSON, generate_hosp_readmit)
from avenir_tpu_torch.jobs.base import Job, auto_mesh  # noqa: E402
from avenir_tpu_torch.models import correlation as corr  # noqa: E402
from avenir_tpu_torch.models import mutual_info as mi  # noqa: E402
from avenir_tpu_torch.models import naive_bayes as nb  # noqa: E402
from avenir_tpu_torch.models import tree as dtree  # noqa: E402
from avenir_tpu_torch.ops import agg  # noqa: E402
from avenir_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from avenir_tpu_torch.pipeline import driver, scan  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
OFF = "-Ddata.parallel.auto=false"
TOL = 2e-6            # statistics printed to 6 places (MI, correlation, tree)
JAX_RTOL = 1e-5       # the JAX package's own sharded-against-single bar
SELF_RTOL = 1e-12     # float64 sums in another order, same package
CHUNK = "-Dstream.chunk.rows=700"
MIXED_SCHEMA_JSON = copy.deepcopy(HOSP_SCHEMA_JSON)
for _f in MIXED_SCHEMA_JSON["fields"][1:4]:          # age, weight, height
    for _k in ("bucketWidth", "min", "max"):
        _f.pop(_k)


def _grid_rows(n, seed):
    """Hospital rows whose three continuous fields lie on a 0.5 grid in
    [0, 7.5]: every float32 partial sum of x and x² is exact, in any
    order, so the moments are the same numbers in both packages."""
    rows = generate_hosp_readmit(n, seed=seed)
    rng = np.random.default_rng(seed)
    rows[:, 1:4] = (rng.integers(0, 16, size=(n, 3)) / 2).astype(str)
    return rows


def _stats_rows(n_pairs, seed):
    """``x,group,y`` rows in pairs m ± d of one group, on a grid of 1/4:
    every group's mean is on the grid and every float32 sum of the
    shifted values and their squares is exact (NumericalAttrStats)."""
    rng = np.random.default_rng(seed)
    means = {"a": (3.25, -1.5), "b": (-20.75, 4.0), "c": (0.0, 1000.5)}
    rows = []
    for _ in range(n_pairs):
        g = "abc"[rng.integers(0, 3)]
        dx, dy = rng.integers(-32, 33, 2) / 4
        for s in (1, -1):
            rows.append(f"{means[g][0] + s * dx},{g},{means[g][1] + s * dy}")
    return rows


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    work = tmp_path_factory.mktemp("automesh")
    schemas = {"hosp": HOSP_SCHEMA_JSON, "churn": CHURN_SCHEMA_JSON,
               "grid": MIXED_SCHEMA_JSON, "mixed": MIXED_SCHEMA_JSON}
    # hospital seed 35: every split margin of the depth-3 tree holds in
    # float32 (tests/test_torch_tree.py)
    rows = {"hosp": generate_hosp_readmit(3000, seed=35)[:2500],
            "churn": generate_churn(2600, seed=4),
            "grid": _grid_rows(2600, seed=4),
            "mixed": generate_hosp_readmit(2600, seed=4)}
    for name, schema in schemas.items():
        write_csv(str(work / f"{name}.csv"), rows[name])
        (work / f"{name}.json").write_text(json.dumps(schema))
    (work / "stats.csv").write_text("\n".join(_stats_rows(650, 3)) + "\n")
    return work


def _cli(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


_NUM = re.compile(r"^-?(\d+\.?\d*|\.\d+)([eE][-+]?\d+)?$|^-?(inf|nan)$")


def _fields(line: str):
    return re.split(r"([,;:\s\[\]{}\"])", line)


def _same_text(got: str, want: str, atol: float, rtol: float) -> None:
    """Line for line, token for token: text equal, numbers within
    ``atol + rtol·|want|`` (both 0: the same bytes)."""
    if atol == rtol == 0.0:
        assert got == want
        return
    g_lines, w_lines = got.splitlines(), want.splitlines()
    assert len(g_lines) == len(w_lines) > 0
    for lg, lw in zip(g_lines, w_lines):
        fg, fw = _fields(lg), _fields(lw)
        assert len(fg) == len(fw), (lg, lw)
        for a, b in zip(fg, fw):
            if a == b:
                continue
            assert _NUM.match(a) and _NUM.match(b), (lg, lw)
            assert abs(float(a) - float(b)) <= atol + rtol * abs(float(b)), \
                (lg, lw)


# case → (data, job, -D arguments, (atol, rtol) against the JAX package)
JOBS = {
    "nb binned streamed": ("hosp", "BayesianDistribution", [CHUNK], (0, 0)),
    "nb binned whole": ("hosp", "BayesianDistribution", [], (0, 0)),
    "nb gaussian grid": ("grid", "BayesianDistribution", [CHUNK], (0, 0)),
    "nb gaussian mixed": ("mixed", "BayesianDistribution", [CHUNK],
                          (0, JAX_RTOL)),
    "mi streamed": ("hosp", "MutualInformation", [CHUNK], (TOL, 0)),
    "mi whole": ("hosp", "MutualInformation", [], (TOL, 0)),
    "cramer against class": ("churn", "CramerCorrelation",
                             ["-Ddest.attributes=6", CHUNK], (TOL, 0)),
    "cramer pairs": ("churn", "CramerCorrelation", [CHUNK], (TOL, 0)),
    "heterogeneity against class": (
        "churn", "HeterogeneityReductionCorrelation",
        ["-Dheterogeneity.algorithm=uncertainty", "-Ddest.attributes=6",
         CHUNK], (TOL, 0)),
    "heterogeneity selection": (
        "hosp", "HeterogeneityReductionCorrelation",
        ["-Dheterogeneity.algorithm=concentration",
         "-Dsource.attributes=1,4,5", "-Ddest.attributes=6,7,10"], (TOL, 0)),
    "class partition": ("hosp", "ClassPartitionGenerator",
                        ["-Doutput.split.prob=true"], (TOL, 0)),
    "tree exhaustive": ("hosp", "DecisionTreeBuilder", ["-Dmax.depth=3"],
                        (TOL, 0)),
    "tree binary subtract": ("hosp", "DecisionTreeBuilder",
                             ["-Dmax.depth=3", "-Dsplit.search=binary",
                              "-Dtree.hist.mode=subtract"], (TOL, 0)),
    "fisher grid": ("grid", "FisherDiscriminant", [], (0, 0)),
    "fisher mixed": ("mixed", "FisherDiscriminant", [], (0, JAX_RTOL)),
    "stats whole": ("stats", "NumericalAttrStats",
                    ["-Dattr.list=0,2", "-Dcond.attr.ord=1"], (0, 0)),
    "stats streamed": ("stats", "NumericalAttrStats",
                       ["-Dattr.list=0,2", "-Dcond.attr.ord=1",
                        "-Dstream.chunk.rows=250"], (0, 0)),
}


def _job_argv(work, data, job, extra):
    schema = [] if data == "stats" else [
        f"-Dfeature.schema.file.path={work / (data + '.json')}"]
    return [job, *schema, *extra]


@pytest.mark.parametrize("case", sorted(JOBS))
def test_job_part_files_under_the_auto_mesh(inputs, case):
    """The port's part file under the default conf (an eight-slot data
    mesh) equals the JAX package's under the same conf, and the port's own
    with ``data.parallel.auto=false`` (count lines byte for byte, float64
    moments within 1e-12); the rows processed are counted once."""
    data, job, extra, (atol, rtol) = JOBS[case]
    work = inputs
    argv = _job_argv(work, data, job, extra)
    src = str(work / f"{data}.csv")
    slug = case.replace(" ", "_")
    parts, counters = {}, {}
    for tag, main, more in (("jax", jax_main, []),
                            ("port", torch_main, ["--device", "cpu"]),
                            ("port_off", torch_main,
                             [OFF, "--device", "cpu"])):
        out = work / f"{tag}_{slug}"
        counters[tag] = _cli(main, argv + [src, str(out)] + more)
        parts[tag] = (out / "part-00000").read_text()
    assert parts["port"]
    _same_text(parts["port"], parts["jax"], atol, rtol)
    self_tol = SELF_RTOL if rtol else 0.0
    _same_text(parts["port"], parts["port_off"], 0.0, self_tol)
    if "Processed" in counters["jax"]:
        want = re.search(r"Processed=(\d+)", counters["jax"]).group(1)
        assert f"Processed={want}" in counters["port"]


def test_streamed_job_counters_equal_jax_under_the_mesh(inputs):
    """A streamed MI job's counters under the mesh are the JAX package's:
    one task attempt a chunk and one for the end of the file, one
    recompile for the ragged (mesh-padded) last chunk."""
    work = inputs
    argv = _job_argv(work, "hosp", "MutualInformation", [CHUNK])
    src = str(work / "hosp.csv")
    got = _cli(torch_main, argv + [src, str(work / "ctr_port"), "--device",
                                   "cpu"])
    want = _cli(jax_main, argv + [src, str(work / "ctr_jax")])
    assert got == want
    assert "Telemetry\n\trecompiles=1" in got


# ---------------------------------------------------------------------------
# pipelines and the stream
# ---------------------------------------------------------------------------

def _pipeline_props(work, **extra):
    props = {"pipeline.stages": "nb,mi,cramer",
             "pipeline.bind.train": str(work / "churn.csv"),
             "feature.schema.file.path": str(work / "churn.json"),
             "pipeline.stage.nb.job": "BayesianDistribution",
             "pipeline.stage.nb.input": "train",
             "pipeline.stage.nb.output": "nb_model",
             "pipeline.stage.mi.job": "MutualInformation",
             "pipeline.stage.mi.input": "train",
             "pipeline.stage.mi.output": "mi_out",
             "pipeline.stage.cramer.job": "CramerCorrelation",
             "pipeline.stage.cramer.input": "train",
             "pipeline.stage.cramer.output": "cramer_out",
             "pipeline.stage.cramer.dest.attributes": "6"}
    props.update(extra)
    return props


def _parts(ws):
    return [(pathlib.Path(ws) / a / "part-00000").read_bytes()
            for a in ("nb_model", "mi_out", "cramer_out")]


@pytest.mark.parametrize("planned", [False, True])
@pytest.mark.parametrize("chunk", ["700", "whole"])
def test_fused_pipeline_under_the_auto_mesh(inputs, chunk, planned):
    """The fused NB + MI + Cramér pipeline (staged, or planned with
    ``plan.on``) under the default conf: part files byte-identical to the
    port's with ``data.parallel.auto=false``, and to the JAX package's
    under the same conf (NB byte for byte, the MI and Cramér statistics
    within 2e-6); one fused scan, no ``Shard`` group (the mesh is not a
    ``shard.*`` plan)."""
    work = inputs
    extra = {} if chunk == "whole" else {"stream.chunk.rows": chunk}
    if planned:
        extra["plan.on"] = "true"
    tag = f"{chunk}_{planned}"
    port = driver.Pipeline.from_conf(
        JobConfig(_pipeline_props(work, **extra)),
        workspace=str(work / f"pp_{tag}"), device="cpu").run()
    driver.Pipeline.from_conf(
        JobConfig(_pipeline_props(work, **extra,
                                  **{"data.parallel.auto": "false"})),
        workspace=str(work / f"po_{tag}"), device="cpu").run()
    jdriver.Pipeline.from_conf(JConfig(_pipeline_props(work, **extra)),
                               workspace=str(work / f"pj_{tag}")).run()
    got = _parts(work / f"pp_{tag}")
    assert got == _parts(work / f"po_{tag}")
    want = _parts(work / f"pj_{tag}")
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        _same_text(g.decode(), w.decode(), TOL, 0.0)
    stage = next(iter(port.values()))
    assert stage.get("SharedScan", "Scans") == 1
    assert stage.get("Shard", "chunks") in (None, 0)


def test_plan_explain_under_the_auto_mesh(inputs, capsys):
    """``plan explain`` under the default conf names the ``sharded``
    program, as the JAX package's does on its host mesh; the two texts
    are equal once costs are masked (each package's own numbers)."""
    from avenir_tpu.pipeline.__main__ import main as jplan_main
    from avenir_tpu_torch.pipeline.__main__ import main as plan_main

    work = inputs
    conf = work / "plan.properties"
    conf.write_text("\n".join(f"{k}={v}" for k, v in _pipeline_props(
        work, **{"stream.chunk.rows": "700"}).items()) + "\n")
    capsys.readouterr()
    assert plan_main(["plan", "explain", str(conf), "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert jplan_main(["plan", "explain", str(conf)]) == 0
    want = capsys.readouterr().out
    assert "program: sharded" in got
    mask = lambda s: re.sub(r"\d+(\.\d+)?(e[-+]?\d+)?", "#", s)  # noqa: E731
    assert mask(got) == mask(want)


def _stream(work, out, jax_pkg=False, **extra):
    from avenir_tpu.jobs import get_job as jget_job
    from avenir_tpu_torch.jobs import get_job

    props = {"feature.schema.file.path": str(work / "churn.json"),
             "stream.pane.rows": "256", "stream.window.panes": "2",
             "stream.consumers": "classDistribution,naiveBayes,mutualInfo,"
                                 "cramer",
             "stream.drift.threshold": "0.01", **extra}
    if jax_pkg:
        jget_job("StreamAnalytics").run(JConfig(props),
                                        str(work / "churn.csv"), str(out))
    else:
        get_job("StreamAnalytics").run(JobConfig(props),
                                       str(work / "churn.csv"), str(out),
                                       device="cpu")
    return (out / "part-00000").read_text()


def test_stream_analytics_under_the_auto_mesh(inputs, tmp_path):
    work = inputs
    got = _stream(work, tmp_path / "port")
    assert got == _stream(work, tmp_path / "jax", jax_pkg=True)
    assert got == _stream(work, tmp_path / "off",
                          **{"data.parallel.auto": "false"})
    assert got.count("w=") >= 10


def test_stream_snapshot_without_the_mesh_refused_under_it(inputs, tmp_path):
    """A pane snapshot written with ``data.parallel.auto=false`` and
    resumed under the default conf (the mesh) is refused before any
    output, in both packages and with the same message (the key is part
    of the run's identity); a resume under the conf that wrote it
    continues."""
    from avenir_tpu.core.config import ConfigError as JConfigError
    from avenir_tpu_torch.utils.retry import InjectedFault

    work = inputs
    errors = {}
    for pkg, exc in (("port", ConfigError), ("jax", JConfigError)):
        ck = tmp_path / f"ck_{pkg}"
        durable = {"stream.checkpoint.dir": str(ck),
                   "stream.checkpoint.interval.panes": "2",
                   "data.parallel.auto": "false"}
        with pytest.raises(InjectedFault if pkg == "port" else Exception,
                           match="injected"):
            _stream(work, tmp_path / f"x_{pkg}", jax_pkg=pkg == "jax",
                    **durable, **{"fault.fold.crash.after": "5"})
        resumed = dict(durable, **{"stream.resume": "true",
                                   "data.parallel.auto": "true"})
        with pytest.raises(exc) as refused:
            _stream(work, tmp_path / f"r_{pkg}", jax_pkg=pkg == "jax",
                    **resumed)
        assert not (tmp_path / f"r_{pkg}").exists()
        errors[pkg] = str(refused.value)
    mask = lambda s: re.sub(r"'[^']*'", "'#'", s)  # noqa: E731
    assert mask(errors["port"]) == mask(errors["jax"])
    assert "configuration changed" in errors["port"]
    tail = _stream(work, tmp_path / "r_ok", **{
        "stream.checkpoint.dir": str(tmp_path / "ck_port"),
        "stream.checkpoint.interval.panes": "2",
        "data.parallel.auto": "false", "stream.resume": "true"})
    assert tail.count("w=") >= 1


# ---------------------------------------------------------------------------
# routes and key families
# ---------------------------------------------------------------------------

def _encoded(schema_json, rows):
    enc = DatasetEncoder(FeatureSchema.from_json(schema_json))
    jenc = JEncoder(JSchema.from_json(schema_json))
    return enc.fit_transform(rows), jenc.fit_transform(rows)


def _chunks(ds, size=700):
    return [ds.slice(s, min(s + size, ds.num_rows))
            for s in range(0, ds.num_rows, size)]


@pytest.fixture(scope="module")
def encoded():
    return {"hosp": _encoded(HOSP_SCHEMA_JSON,
                             generate_hosp_readmit(2100, seed=5)),
            "churn": _encoded(CHURN_SCHEMA_JSON, generate_churn(2100, seed=7)),
            "grid": _encoded(MIXED_SCHEMA_JSON, _grid_rows(2100, seed=8))}


def _meshes():
    return (auto_mesh(JobConfig({}), "cpu"), JJob.auto_mesh(JConfig({})))


def _fit_keys(kind, ds, jds, mesh, jmesh):
    acc, jacc = agg.Accumulator(), jagg.Accumulator()
    if kind == "nb":
        got = nb.NaiveBayes(mesh=mesh, device="cpu").fit(
            _chunks(ds), accumulator=acc)
        want = jnb.NaiveBayes(mesh=jmesh).fit(iter(_chunks(jds)),
                                              accumulator=jacc)
        out = (got.bin_counts, want.bin_counts)
    elif kind == "mi":
        got = mi.MutualInformation(mesh=mesh, device="cpu").fit(
            _chunks(ds), accumulator=acc)
        want = jmi.MutualInformation(mesh=jmesh).fit(iter(_chunks(jds)),
                                                     accumulator=jacc)
        out = (got.pair_class_counts, want.pair_class_counts)
    else:
        against = kind == "cramer against class"
        got = corr.CramerCorrelation(mesh=mesh, device="cpu").fit(
            _chunks(ds), against_class=against, accumulator=acc)
        want = jcorr.CramerCorrelation(mesh=jmesh).fit(
            iter(_chunks(jds)), against_class=against, accumulator=jacc)
        out = (got.contingency, want.contingency)
    return acc, jacc, out


@pytest.mark.parametrize("kind,data", [("nb", "grid"), ("mi", "hosp"),
                                       ("cramer pairs", "churn"),
                                       ("cramer against class", "churn")])
def test_model_key_families_equal_jax_on_the_mesh(encoded, kind, data):
    """Under the CPU mesh each model accumulates the JAX package's key
    family (its CPU-mesh route: the einsum keys) with equal totals, and
    equal to the port's unsharded fit."""
    ds, jds = encoded[data]
    mesh, jmesh = _meshes()
    assert mesh.sizes == dict(jmesh.shape) == {"data": 8}
    acc, jacc, (got, want) = _fit_keys(kind, ds, jds, mesh, jmesh)
    assert sorted(acc.names()) == sorted(jacc.names())
    for k in acc.names():
        np.testing.assert_array_equal(acc.get(k), np.asarray(jacc.get(k)))
    np.testing.assert_array_equal(got, np.asarray(want))
    plain, _j, (alone, _w) = _fit_keys(kind, ds, jds, None, None)
    assert sorted(plain.names()) == sorted(acc.names())
    np.testing.assert_array_equal(got, alone)


def test_mesh_fit_refuses_a_foreign_gram_key(encoded):
    """An MI snapshot holding another layout's gram is refused under the
    mesh with the JAX package's message, as without it."""
    ds, jds = encoded["hosp"]
    mesh, jmesh = _meshes()
    acc, jacc = agg.Accumulator(), jagg.Accumulator()
    acc.add("g:jmaj:f1:b1:c1", np.zeros(4, np.int64))
    jacc.add("g:jmaj:f1:b1:c1", np.zeros(4, np.int64))
    with pytest.raises(ValueError) as got:
        mi.MutualInformation(mesh=mesh, device="cpu").fit(
            _chunks(ds), accumulator=acc)
    with pytest.raises(ValueError) as want:
        jmi.MutualInformation(mesh=jmesh).fit(iter(_chunks(jds)),
                                              accumulator=jacc)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("mesh_on", [True, False])
def test_chunk_folder_route_and_keys_equal_jax(encoded, mesh_on):
    """ChunkFolder under the CPU mesh takes the einsum route with no pack
    (the JAX package's ``pack requires self.mesh is None``) and fills the
    JAX folder's keys with equal totals; without it, the pack route."""
    ds, jds = encoded["grid"]
    mesh, jmesh = _meshes() if mesh_on else (None, None)
    cons = [scan.NaiveBayesConsumer(name="nb"),
            scan.MutualInfoConsumer(name="mi"),
            scan.FisherConsumer(name="fisher")]
    jcons = [jscan.NaiveBayesConsumer(name="nb"),
             jscan.MutualInfoConsumer(name="mi"),
             jscan.FisherConsumer(name="fisher")]
    folder = scan.ChunkFolder(cons, ds, "cpu", mesh=mesh)
    jfolder = jscan.ChunkFolder(jcons, jds, mesh=jmesh)
    assert folder.step == jfolder.step == ("einsum" if mesh_on else "packed")
    acc, jacc = agg.Accumulator(), jagg.Accumulator()
    for c, jc in zip(_chunks(ds), _chunks(jds)):
        folder.fold(c, acc)
        jfolder.fold(jc, jacc)
    assert sorted(acc.names()) == sorted(jacc.names())
    for k in acc.names():
        np.testing.assert_array_equal(acc.get(k), np.asarray(jacc.get(k)))


def test_tree_fit_on_the_mesh_equals_the_unsharded_fit(encoded):
    """DecisionTree over the CPU mesh: per-shard level tables summed give
    the unsharded tree, level by level on the plain route (no pack)."""
    ds, _jds = encoded["hosp"]
    mesh, _ = _meshes()
    kw = dict(max_depth=3, device="cpu", collect_phase_stats=True,
              level_packed="on")
    sharded = dtree.DecisionTree(mesh=mesh, **kw)
    alone = dtree.DecisionTree(**kw)
    assert sharded.fit(ds).to_string() == alone.fit(ds).to_string()
    assert {st["path"] for st in sharded.level_stats} == {"plain"}
    assert {st["path"] for st in alone.level_stats} == {"packed"}


def test_place_batch_pads_and_splits_as_the_jax_mesh(encoded):
    ds, _ = encoded["hosp"]
    mesh, _ = _meshes()
    codes, labels = pmesh.place_batch(mesh, "cpu", ds.codes[:1001],
                                      ds.labels[:1001])
    assert isinstance(codes, pmesh.Blocks) and len(codes.parts) == 8
    assert codes.shape == (1008, ds.codes.shape[1])
    assert (labels.parts[-1][-7:] == -1).all()
    alone = pmesh.place_batch(None, "cpu", ds.codes[:5])
    assert isinstance(alone[0], torch.Tensor)


# ---------------------------------------------------------------------------
# Job.auto_mesh
# ---------------------------------------------------------------------------

def test_auto_mesh_follows_the_key_and_the_host_slots():
    on = JobConfig({})
    off = JobConfig({"data.parallel.auto": "false"})
    mesh = auto_mesh(on, "cpu")
    assert mesh.axis_names == ("data",) and mesh.sizes == {"data": 8}
    assert auto_mesh(off, "cpu") is None
    job = Job()
    job.device = torch.device("cpu")
    assert job.auto_mesh(on).sizes == {"data": 8}
    assert job.auto_mesh(off) is None
    assert JJob.auto_mesh(JConfig({"data.parallel.auto": "false"})) is None


@pytest.mark.parametrize("flags,want", [("", None), ("--xla_foo=1", None),
                                        ("--xla_force_host_platform_"
                                         "device_count=1", None),
                                        ("--xla_force_host_platform_"
                                         "device_count=3", 3)])
def test_auto_mesh_without_the_host_flag_is_none(flags, want):
    """In a process whose XLA_FLAGS force fewer than two host devices the
    CPU has one shard slot and ``auto_mesh`` is None; three forced slots
    give a three-slot mesh (a subprocess: the flag is read per call)."""
    code = ("from avenir_tpu_torch.core.config import JobConfig\n"
            "from avenir_tpu_torch.jobs.base import auto_mesh\n"
            "m = auto_mesh(JobConfig({}), 'cpu')\n"
            "print(None if m is None else m.sizes['data'])\n")
    env = dict(os.environ, XLA_FLAGS=flags, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str(want)


def test_card_mesh_routes_per_shard_on_the_cpu(encoded, monkeypatch):
    """The routes a mesh of cards takes, run on the CPU's eight slots with
    ``mesh_on_cuda`` answering yes (the wrappers then run their plain
    versions): MI grams every shard (``sharded_cooc_step``) under the
    plain ``g_key``; Cramér keeps its einsum keys, each shard's tables
    read out of its gram; ChunkFolder takes the ``sharded`` step; the
    tree counts each level per shard through the cross wrapper.  Every
    table equals the unsharded fit's, and each wrapper is called once a
    shard (tests/test_torch_cuda.py holds the kernels on two cards)."""
    from avenir_tpu_torch.models import correlation as corr_mod
    from avenir_tpu_torch.models import mutual_info as mi_mod
    from avenir_tpu_torch.ops import hist

    for mod in (mi_mod, corr_mod, dtree, pmesh):
        monkeypatch.setattr(mod, "mesh_on_cuda", lambda m: m is not None)
    calls = {"gram": 0, "cross": 0}

    def counted(name, fn):
        def call(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return call

    monkeypatch.setattr(hist, "cooc_counts",
                        counted("gram", hist.cooc_counts))
    monkeypatch.setattr(hist, "cross_cooc_counts_cols",
                        counted("cross", hist.cross_cooc_counts_cols))
    mesh, _ = _meshes()
    ds, _ = encoded["hosp"]
    chunks = _chunks(ds)
    acc = agg.Accumulator()
    got = mi.MutualInformation(mesh=mesh, device="cpu").fit(
        chunks, accumulator=acc)
    assert calls["gram"] == 8 * len(chunks)
    assert sorted(acc.names()) == ["class", "g:fmaj:f10:b13:c2"]
    mi_want = mi.MutualInformation(device="cpu").fit(chunks)
    np.testing.assert_array_equal(got.pair_class_counts,
                                  mi_want.pair_class_counts)
    cds, _ = encoded["churn"]
    for against in (False, True):
        calls["gram"] = 0
        acc = agg.Accumulator()
        got = corr.CramerCorrelation(mesh=mesh, device="cpu").fit(
            _chunks(cds), against_class=against, accumulator=acc)
        assert calls["gram"] == 8 * len(_chunks(cds))
        assert all(k.startswith("c5x") for k in acc.names())
        want = corr.CramerCorrelation(device="cpu").fit(
            _chunks(cds), against_class=against)
        np.testing.assert_array_equal(got.contingency, want.contingency)
    cons = [scan.NaiveBayesConsumer(name="nb"),
            scan.MutualInfoConsumer(name="mi")]
    folder = scan.ChunkFolder(cons, ds, "cpu", mesh=mesh)
    assert folder.step == "sharded" and folder.gk == "g:fmaj:f10:b13:c2"
    calls["gram"] = 0
    acc = agg.Accumulator()
    for c in chunks:
        folder.fold(c, acc)
    assert calls["gram"] == 8 * len(chunks)
    tables = folder.tables(acc, ds.num_rows)
    np.testing.assert_array_equal(tables.pcc, mi_want.pair_class_counts)
    np.testing.assert_array_equal(tables.fbc, mi_want.feature_class_counts)
    sharded = dtree.DecisionTree(max_depth=3, mesh=mesh, device="cpu",
                                 collect_phase_stats=True)
    tree_got = sharded.fit(ds)
    levels = len(sharded.level_stats)
    assert {st["path"] for st in sharded.level_stats} == {"cross"}
    assert calls["cross"] == 8 * levels
    assert tree_got.to_string() == dtree.DecisionTree(
        max_depth=3, device="cpu").fit(ds).to_string()
