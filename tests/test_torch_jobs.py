"""The port's CLI jobs (``python -m avenir_tpu_torch``) held against
``python -m avenir_tpu`` on the CPU, plus the port's isolation and
no-fallback rules.

Whole slice: BayesianDistribution, BayesianPredictor and MutualInformation
run on a small hospital-readmission CSV through both CLIs.  The NB model
and prediction part files are byte-identical; the MI part file is equal
field by field, its numbers within abs 2e-6 (float32 statistics from equal
counts, reduced in a different order, printed to 6 places).
"""

import contextlib
import io
import json
import os
import pathlib
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from avenir_tpu.__main__ import main as jax_main  # noqa: E402
from avenir_tpu_torch.__main__ import main as torch_main  # noqa: E402
from avenir_tpu_torch.__main__ import parse_args  # noqa: E402
from avenir_tpu_torch.core.csv_io import write_csv  # noqa: E402
from avenir_tpu_torch.datagen.hosp_readmit import (  # noqa: E402
    HOSP_SCHEMA_JSON, generate_hosp_readmit)

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "avenir_tpu_torch"
TOL = 2e-6


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    """Part files of the three jobs from both CLIs, keyed (package, job)."""
    work = tmp_path_factory.mktemp("slice")
    rows = generate_hosp_readmit(2500, seed=3)
    write_csv(str(work / "train.csv"), rows[:2000])
    write_csv(str(work / "test.csv"), rows[2000:])
    (work / "hosp.json").write_text(json.dumps(HOSP_SCHEMA_JSON))
    common = [f"-Dfeature.schema.file.path={work / 'hosp.json'}"]
    out = {}
    for pkg, main, extra in (("jax", jax_main, []),
                             ("torch", torch_main, ["--device", "cpu"])):
        o = lambda job: str(work / f"{pkg}_{job}")  # noqa: E731
        _run(main, ["BayesianDistribution", *common, "-Dstream.chunk.rows=700",
                    str(work / "train.csv"), o("nb"), *extra])
        _run(main, ["BayesianPredictor", *common,
                    f"-Dbayesian.model.file.path={o('nb')}",
                    "-Dprediction.mode=validation",
                    "-Dclass.prob.diff.threshold=5",
                    str(work / "test.csv"), o("pred"), *extra])
        counters = _run(main, [
            "MutualInformation", *common, "-Dstream.chunk.rows=700",
            "-Dmutual.info.score.algorithms=mim,mifs,jmi,disr,mrmr",
            str(work / "train.csv"), o("mi"), *extra])
        out[pkg] = {job: pathlib.Path(o(job), "part-00000").read_bytes()
                    for job in ("nb", "pred", "mi")}
        out[pkg]["mi_counters"] = counters
    return out


@pytest.mark.parametrize("job", ["nb", "pred"])
def test_nb_part_files_byte_identical(outputs, job):
    assert outputs["torch"][job], "empty part file"
    assert outputs["torch"][job] == outputs["jax"][job]


def _same_mi_lines(got: bytes, want: bytes) -> None:
    """MI part files equal field by field, numbers within TOL."""
    got, want = got.decode().splitlines(), want.decode().splitlines()
    assert len(got) == len(want) > 0
    numeric = 0
    for lg, lw in zip(got, want):
        fg, fw = lg.split(","), lw.split(",")
        assert len(fg) == len(fw), (lg, lw)
        for a, b in zip(fg, fw):
            try:
                x, y = float(a), float(b)
            except ValueError:
                assert a == b, (lg, lw)
                continue
            assert abs(x - y) <= TOL, (lg, lw)
            numeric += 1
    assert numeric > 100


def test_mi_part_file_equal_field_by_field(outputs):
    _same_mi_lines(outputs["torch"]["mi"], outputs["jax"]["mi"])


def test_mi_job_counts_its_chunks(outputs):
    """The streamed MI job's counters are the JAX package's: one task
    attempt per chunk and one for the end of the file, one recompile for
    the ragged last chunk, every row processed."""
    assert outputs["torch"]["mi_counters"] == outputs["jax"]["mi_counters"]
    assert outputs["torch"]["mi_counters"] == (
        "Records\n\tProcessed=2000\nTask\n\tattempts=4\n"
        "Telemetry\n\trecompiles=1\n")


def test_cli_device_argument():
    assert parse_args(["MutualInformation", "in", "out", "--device", "cpu"]) == (
        "MutualInformation", {}, ["in", "out"], "cpu")
    assert parse_args(["X", "-Da=1", "in", "out", "--device=cuda"])[1:] == (
        {"a": "1"}, ["in", "out"], "cuda")
    assert parse_args(["X", "in", "out"])[3] is None
    with pytest.raises(SystemExit):
        parse_args(["X", "in", "out", "--device"])
    with pytest.raises(SystemExit):
        parse_args(["X", "in", "out", "--bogus"])


NEW_JOBS = [("BaggingSampler", "explore"), ("UnderSamplingBalancer", "explore"),
            ("MarkovStateTransitionModel", "markov"),
            ("HiddenMarkovModelBuilder", "markov"),
            ("ViterbiStatePredictor", "markov"),
            ("LogisticRegressionJob", "regress"),
            ("GreedyRandomBandit", "reinforce"), ("AuerDeterministic", "reinforce"),
            ("SoftMaxBandit", "reinforce"),
            ("RandomFirstGreedyBandit", "reinforce"), ("WordCounter", "text")]


@pytest.mark.parametrize("job,pkg", NEW_JOBS)
def test_new_jobs_registered_and_need_cuda_or_cpu(tmp_path, job, pkg):
    """Reachable by short and ``org.avenir.<pkg>.`` name, listed by
    ``--list``; without CUDA each raises unless ``--device cpu`` is given,
    before writing anything."""
    from avenir_tpu_torch.jobs import REGISTRY

    assert REGISTRY[job] is REGISTRY[f"org.avenir.{pkg}.{job}"]
    assert job in _run(torch_main, ["--list"]).split()
    if torch.cuda.is_available():
        return
    (tmp_path / "in.csv").write_text("C1,a,b\n")
    with pytest.raises(RuntimeError, match="--device cpu"):
        torch_main([f"org.avenir.{pkg}.{job}", str(tmp_path / "in.csv"),
                    str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()


def test_cli_without_device_needs_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    rows = generate_hosp_readmit(50, seed=1)
    write_csv(str(tmp_path / "train.csv"), rows)
    (tmp_path / "hosp.json").write_text(json.dumps(HOSP_SCHEMA_JSON))
    with pytest.raises(RuntimeError, match="--device cpu"):
        torch_main(["MutualInformation",
                    f"-Dfeature.schema.file.path={tmp_path / 'hosp.json'}",
                    str(tmp_path / "train.csv"), str(tmp_path / "mi")])
    assert not (tmp_path / "mi").exists()


def test_package_imports_neither_jax_nor_avenir_tpu():
    code = ("import sys, avenir_tpu_torch, avenir_tpu_torch.__main__, "
            "avenir_tpu_torch.jobs, avenir_tpu_torch.convert, "
            "avenir_tpu_torch.ops._build, avenir_tpu_torch.runtime.native, "
            "avenir_tpu_torch.runtime.feeder, avenir_tpu_torch.utils.retry, "
            "avenir_tpu_torch.utils.locking, avenir_tpu_torch.pipeline.scan, "
            "avenir_tpu_torch.pipeline.driver, "
            "avenir_tpu_torch.pipeline.__main__, "
            "avenir_tpu_torch.models.correlation, "
            "avenir_tpu_torch.models.fisher, avenir_tpu_torch.jobs.regress, "
            "avenir_tpu_torch.utils.checkpoint, avenir_tpu_torch.datagen.churn, "
            "avenir_tpu_torch.utils.prng, avenir_tpu_torch.models.samplers, "
            "avenir_tpu_torch.models.markov, avenir_tpu_torch.models.logistic, "
            "avenir_tpu_torch.jobs.markov, avenir_tpu_torch.datagen.event_seq, "
            "avenir_tpu_torch.datagen.buy_xaction, "
            "avenir_tpu_torch.datagen.hmm_seq, avenir_tpu_torch.text, "
            "avenir_tpu_torch.jobs.text, avenir_tpu_torch.jobs.reinforce, "
            "avenir_tpu_torch.jobs.chombo, avenir_tpu_torch.models.bandits, "
            "avenir_tpu_torch.models.online_rl, "
            "avenir_tpu_torch.pipeline.streaming, avenir_tpu_torch.datagen, "
            "avenir_tpu_torch.datagen.lead_gen, "
            "avenir_tpu_torch.datagen.price_opt, "
            "avenir_tpu_torch.datagen.disease, "
            "avenir_tpu_torch.telemetry, avenir_tpu_torch.telemetry.schema, "
            "avenir_tpu_torch.telemetry.journal, "
            "avenir_tpu_torch.telemetry.blackbox, "
            "avenir_tpu_torch.telemetry.spans, "
            "avenir_tpu_torch.telemetry.profile, "
            "avenir_tpu_torch.telemetry.export, "
            "avenir_tpu_torch.telemetry.slo, "
            "avenir_tpu_torch.telemetry.sentinel, "
            "avenir_tpu_torch.telemetry.__main__, "
            "avenir_tpu_torch.utils.profiling, "
            "avenir_tpu_torch.pipeline.plan, avenir_tpu_torch.serving, "
            "avenir_tpu_torch.serving.errors, "
            "avenir_tpu_torch.serving.registry, "
            "avenir_tpu_torch.serving.batcher, "
            "avenir_tpu_torch.serving.pool, "
            "avenir_tpu_torch.serving.frontend, "
            "avenir_tpu_torch.serving.replay, "
            "avenir_tpu_torch.serving.__main__, avenir_tpu_torch.launch, "
            "avenir_tpu_torch.launch.__main__, avenir_tpu_torch.checkpoint, "
            "avenir_tpu_torch.checkpoint.reshard, "
            "avenir_tpu_torch.pipeline.resp, "
            "avenir_tpu_torch.serving.global_pool, "
            "avenir_tpu_torch.tenancy.contract, "
            "avenir_tpu_torch.utils.roofline, "
            "avenir_tpu_torch.utils.rig_canary\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib')) or m == 'avenir_tpu' "
            "or m.startswith('avenir_tpu.'))\n"
            "print(','.join(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == ""


def test_package_sources_name_neither_jax_nor_avenir_tpu():
    pattern = re.compile(r"^\s*(import\s+jax|from\s+jax)\b"
                         r"|\bimport\s+avenir_tpu\b|\bavenir_tpu\.\w",
                         re.MULTILINE)
    files = (sorted(PKG.rglob("*.py")) + sorted(PKG.rglob("*.cu"))
             + sorted(PKG.rglob("*.cuh")) + sorted(PKG.rglob("*.cpp")))
    assert PKG / "runtime" / "native" / "csv_encode.cpp" in files
    assert PKG / "pipeline" / "scan.py" in files
    for new in ("models/correlation.py", "models/fisher.py",
                "jobs/regress.py", "utils/checkpoint.py", "datagen/churn.py",
                "utils/prng.py", "models/samplers.py", "models/markov.py",
                "models/logistic.py", "jobs/markov.py", "datagen/event_seq.py",
                "datagen/buy_xaction.py", "datagen/hmm_seq.py",
                "text/__init__.py", "text/analyzer.py", "text/wordcount.py",
                "jobs/text.py", "jobs/reinforce.py", "jobs/chombo.py",
                "models/bandits.py", "models/online_rl.py",
                "pipeline/streaming.py", "datagen/lead_gen.py",
                "datagen/price_opt.py", "datagen/disease.py",
                "telemetry/schema.py", "telemetry/journal.py",
                "telemetry/blackbox.py", "telemetry/spans.py",
                "telemetry/profile.py", "telemetry/export.py",
                "telemetry/slo.py", "telemetry/sentinel.py",
                "telemetry/__init__.py", "telemetry/__main__.py",
                "utils/profiling.py", "pipeline/plan.py",
                "serving/__init__.py", "serving/errors.py",
                "serving/registry.py", "serving/batcher.py",
                "serving/pool.py", "serving/frontend.py",
                "serving/replay.py", "serving/__main__.py",
                "launch/__init__.py", "launch/__main__.py",
                "checkpoint/__init__.py", "checkpoint/reshard.py",
                "pipeline/resp.py", "serving/global_pool.py",
                "tenancy/contract.py", "utils/roofline.py",
                "utils/rig_canary.py"):
        assert PKG / new in files
    assert len(files) > 40
    hits = [f"{p.relative_to(REPO)}: {m.group(0).strip()}"
            for p in files for m in pattern.finditer(p.read_text())]
    assert hits == []


@pytest.fixture(scope="module")
def crash_input(tmp_path_factory):
    """3,000 hospital rows and the durability keys of a stream that crashes
    after its second chunk, snapshotting every chunk."""
    work = tmp_path_factory.mktemp("ckpt")
    write_csv(str(work / "train.csv"), generate_hosp_readmit(3000, seed=3))
    (work / "hosp.json").write_text(json.dumps(HOSP_SCHEMA_JSON))
    keys = {"stream.chunk.rows": "700",
            "stream.checkpoint.dir": str(work / "D"),
            "stream.checkpoint.interval.chunks": "1",
            "stream.fault.crash.after.chunks": "2"}
    return work, keys


def _argv(job, work, keys, out):
    return [job, f"-Dfeature.schema.file.path={work / 'hosp.json'}",
            *(f"-D{k}={v}" for k, v in keys.items()),
            str(work / "train.csv"), str(out)]


def test_stream_checkpoint_refused_where_jax_checkpoints(crash_input):
    """Where the JAX package checkpoints the stream, so does the port (the
    refusal it had before StreamCheckpointer was ported is gone): on the
    same input both raise the injected crash after chunk 2, write no part
    file and leave snapshots in their directories."""
    work, keys = crash_input
    for pkg, main, extra in (("jax", jax_main, []),
                             ("torch", torch_main, ["--device", "cpu"])):
        for job in ("BayesianDistribution", "MutualInformation"):
            d = work / f"D_{pkg}_{job}"
            theirs = {**keys, "stream.checkpoint.dir": str(d)}
            out = work / f"{pkg}_crash_{job}"
            with pytest.raises(RuntimeError,
                               match="injected crash after chunk 2"):
                _run(main, _argv(job, work, theirs, out) + extra)
            assert not (out / "part-00000").exists()
            assert sorted(os.listdir(d)) == ["step_1", "step_2"], (pkg, job)


@pytest.mark.parametrize("job", ["BayesianDistribution", "MutualInformation"])
def test_streamed_counters_equal_jax_package(crash_input, job):
    """3,000 rows in 700-row chunks: five chunk tasks and the end-of-file
    task, one recompile (the 200-row tail), every row, NB's model rows."""
    from avenir_tpu.core.config import JobConfig as JConfig
    from avenir_tpu.jobs import get_job as jget_job
    from avenir_tpu_torch.core.config import JobConfig
    from avenir_tpu_torch.jobs import get_job

    work, _keys = crash_input
    props = {"feature.schema.file.path": str(work / "hosp.json"),
             "stream.chunk.rows": "700"}
    got = get_job(job).run(JobConfig(dict(props)), str(work / "train.csv"),
                           str(work / f"counters_torch_{job}"),
                           device="cpu").as_dict()
    want = jget_job(job).run(JConfig(dict(props)), str(work / "train.csv"),
                             str(work / f"counters_jax_{job}")).as_dict()
    assert got == want
    expect = {"Task": {"attempts": 6}, "Telemetry": {"recompiles": 1},
              "Records": {"Processed": 3000}}
    if job == "BayesianDistribution":
        expect["Model"] = {"Rows": got["Model"]["Rows"]}
        assert got["Model"]["Rows"] > 0
    assert got == expect


NO_CHECKPOINTER = {
    "dir without chunks": {"stream.checkpoint.dir": "D_unread",
                           "stream.checkpoint.interval.chunks": "1",
                           "stream.fault.crash.after.chunks": "2"},
    "resume alone": {"stream.chunk.rows": "700", "stream.resume": "true"},
}


@pytest.mark.parametrize("case", sorted(NO_CHECKPOINTER))
def test_stream_keys_run_without_a_checkpointer(crash_input, case):
    """With either key of the checkpointer missing, both packages ignore
    the other durability keys, and the port gives the JAX package's part
    files."""
    work, _keys = crash_input
    keys = dict(NO_CHECKPOINTER[case])
    if "stream.checkpoint.dir" in keys:
        keys["stream.checkpoint.dir"] = str(work / keys["stream.checkpoint.dir"])
    parts = {}
    for pkg, main, extra in (("jax", jax_main, []),
                             ("torch", torch_main, ["--device", "cpu"])):
        for job in ("BayesianDistribution", "MutualInformation"):
            out = work / f"{pkg}_{job}_{case.replace(' ', '_')}"
            _run(main, _argv(job, work, keys, out) + extra)
            parts[pkg, job] = (out / "part-00000").read_bytes()
    assert parts["torch", "BayesianDistribution"]
    assert (parts["torch", "BayesianDistribution"]
            == parts["jax", "BayesianDistribution"])
    _same_mi_lines(parts["torch", "MutualInformation"],
                   parts["jax", "MutualInformation"])
