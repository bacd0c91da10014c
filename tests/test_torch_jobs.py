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


def test_mi_part_file_equal_field_by_field(outputs):
    got = outputs["torch"]["mi"].decode().splitlines()
    want = outputs["jax"]["mi"].decode().splitlines()
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


def test_mi_job_counts_its_chunks(outputs):
    assert "\tChunks=3" in outputs["torch"]["mi_counters"]
    assert "\tProcessed=2000" in outputs["torch"]["mi_counters"]


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
            "avenir_tpu_torch.ops._build\n"
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
             + sorted(PKG.rglob("*.cuh")))
    assert len(files) > 25
    hits = [f"{p.relative_to(REPO)}: {m.group(0).strip()}"
            for p in files for m in pattern.finditer(p.read_text())]
    assert hits == []
