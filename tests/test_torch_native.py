"""The port's native CSV encoder (``avenir_tpu_torch/runtime/native.py``,
its own copy of ``csv_encode.cpp``) held against the JAX package's native
encoder and against the Python encoders, bit for bit, on seeded hospital,
elearn and mixed data; its edge cases and errors; and its build rule:
built on first use into the port's build directory, raising when the build
fails, safe when two processes build at once.
"""

import copy
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from avenir_tpu.core.encoding import DatasetEncoder as JEncoder  # noqa: E402
from avenir_tpu.core.schema import FeatureSchema as JSchema  # noqa: E402
from avenir_tpu.runtime import native as jnative  # noqa: E402
from avenir_tpu_torch.core.config import JobConfig  # noqa: E402
from avenir_tpu_torch.core.csv_io import write_csv  # noqa: E402
from avenir_tpu_torch.core.encoding import DatasetEncoder  # noqa: E402
from avenir_tpu_torch.core.schema import FeatureSchema  # noqa: E402
from avenir_tpu_torch.datagen.elearn import (  # noqa: E402
    ELEARN_SCHEMA_JSON, generate_elearn)
from avenir_tpu_torch.datagen.hosp_readmit import (  # noqa: E402
    HOSP_SCHEMA_JSON, generate_hosp_readmit)
from avenir_tpu_torch.jobs.base import Job  # noqa: E402
from avenir_tpu_torch.runtime import native  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the hospital schema with age, weight and height continuous (no buckets)
MIXED_SCHEMA_JSON = copy.deepcopy(HOSP_SCHEMA_JSON)
for _f in MIXED_SCHEMA_JSON["fields"][1:4]:
    for _k in ("bucketWidth", "min", "max"):
        _f.pop(_k)

SCHEMAS = {
    "hospital": (HOSP_SCHEMA_JSON, generate_hosp_readmit),
    "elearn": (ELEARN_SCHEMA_JSON, generate_elearn),
    "mixed": (MIXED_SCHEMA_JSON, generate_hosp_readmit),
}


def _csv_bytes(rows, eol="\n") -> bytes:
    return (eol.join(",".join(map(str, r)) for r in rows) + eol).encode()


def _encoders(schema_json, rows):
    """(port encoder, JAX encoder), both fitted on ``rows``."""
    enc = DatasetEncoder(FeatureSchema.from_json(schema_json)).fit(rows)
    jenc = JEncoder(JSchema.from_json(schema_json)).fit(rows)
    return enc, jenc


def _assert_same(got, want):
    np.testing.assert_array_equal(got.codes, want.codes)
    assert got.cont.dtype == want.cont.dtype == np.float32
    np.testing.assert_array_equal(got.cont.view(np.int32),
                                  want.cont.view(np.int32))
    if want.labels is None:
        assert got.labels is None
    else:
        np.testing.assert_array_equal(got.labels, want.labels)
    if want.ids is None:
        assert got.ids is None
    else:
        assert [str(x) for x in got.ids] == [str(x) for x in want.ids]


@pytest.mark.parametrize("name", sorted(SCHEMAS))
def test_encode_bytes_equals_jax_native_and_python(name):
    schema_json, gen = SCHEMAS[name]
    rows = gen(800, seed=13)
    enc, jenc = _encoders(schema_json, rows)
    data = _csv_bytes(rows)
    got = native.encode_bytes(data, enc, ncols=rows.shape[1])
    _assert_same(got, jnative.encode_bytes(data, jenc, ncols=rows.shape[1]))
    _assert_same(got, jenc.transform(rows))
    _assert_same(got, enc.transform(rows))


def test_encode_bytes_without_labels():
    rows = generate_hosp_readmit(100, seed=1)
    enc, jenc = _encoders(HOSP_SCHEMA_JSON, rows)
    got = native.encode_bytes(_csv_bytes(rows), enc, ncols=12,
                              with_labels=False)
    assert got.labels is None and got.codes.shape == (100, 10)
    _assert_same(got, jnative.encode_bytes(_csv_bytes(rows), jenc, ncols=12,
                                           with_labels=False))


def _messy(rows, case):
    lines = [",".join(r) for r in rows]
    if case == "crlf":
        return ("\r\n".join(lines) + "\r\n\r\n\n").encode()
    if case == "blank":
        lines.insert(7, "")
        lines.insert(3, "")
        return ("\n" + "\n".join(lines) + "\n\n").encode()
    # whitespace-only lines: the Python reader's strip() drops them, and the
    # native encoder skips them too
    lines.insert(10, " \t ")
    lines.insert(5, "   ")
    return ("   \n" + "\n".join(lines) + "\n \r \n\r\r\n\n").encode()


@pytest.mark.parametrize("case", ["crlf", "blank", "whitespace"])
def test_crlf_blank_and_whitespace_lines(case):
    rows = generate_hosp_readmit(20, seed=4)
    enc, jenc = _encoders(HOSP_SCHEMA_JSON, rows)
    data = _messy(rows, case)
    got = native.encode_bytes(data, enc, ncols=12)
    _assert_same(got, jnative.encode_bytes(data, jenc, ncols=12))
    _assert_same(got, enc.transform(rows))


def test_negative_numbers_after_the_delimiter():
    rows = generate_elearn(200, seed=11)
    rng = np.random.default_rng(11)
    for i in range(rows.shape[0]):
        for j in rng.choice(np.arange(1, rows.shape[1] - 1), size=3,
                            replace=False):
            if not rows[i, j].startswith("-"):
                rows[i, j] = "-" + rows[i, j]
    enc, jenc = _encoders(ELEARN_SCHEMA_JSON, rows)
    got = native.encode_bytes(_csv_bytes(rows), enc, ncols=rows.shape[1])
    _assert_same(got, jnative.encode_bytes(_csv_bytes(rows), jenc,
                                           ncols=rows.shape[1]))
    _assert_same(got, enc.transform(rows))


def test_oov_categorical_takes_the_oov_bin():
    rows = generate_hosp_readmit(10, seed=2)
    enc, jenc = _encoders(HOSP_SCHEMA_JSON, rows)
    rows[0, 4] = "never-seen-level"
    got = native.encode_bytes(_csv_bytes(rows), enc, ncols=12)
    _assert_same(got, jnative.encode_bytes(_csv_bytes(rows), jenc, ncols=12))
    _assert_same(got, enc.transform(rows))
    assert got.codes[0, 3] == enc.n_bins[4] - 1


def _bad(case):
    rows = generate_hosp_readmit(12, seed=3)
    if case == "ragged":
        return rows, _csv_bytes(rows)[:-1] + b"\na,b\n"
    if case == "numeric":
        rows[2, 2] = "xx"
    else:
        rows[3, 11] = "not-a-class"
    return rows, _csv_bytes(rows)


@pytest.mark.parametrize("case,match", [
    ("ragged", "ragged CSV record at row 12"),
    ("numeric", "unparseable numeric field at row 2"),
    ("label", "unknown class label at row 3")])
def test_errors_name_the_row_as_the_jax_encoder_does(case, match):
    rows, data = _bad(case)
    enc, jenc = _encoders(HOSP_SCHEMA_JSON, generate_hosp_readmit(12, seed=3))
    with pytest.raises(ValueError) as want:
        jnative.encode_bytes(data, jenc, ncols=12)
    with pytest.raises(ValueError, match=match) as got:
        native.encode_bytes(data, enc, ncols=12)
    assert str(got.value) == str(want.value)


def test_multithreaded_large_buffer_and_absolute_error_row():
    rows = generate_hosp_readmit(30000, seed=11)
    enc, jenc = _encoders(HOSP_SCHEMA_JSON, rows)
    data = _csv_bytes(rows)
    assert len(data) > (1 << 20)          # the multithreaded split engages
    mt = native.encode_bytes(data, enc, ncols=12, nthreads=8)
    _assert_same(mt, native.encode_bytes(data, enc, ncols=12, nthreads=1))
    _assert_same(mt, jnative.encode_bytes(data, jenc, ncols=12, nthreads=8))
    _assert_same(mt, enc.transform(rows))
    bad = rows.copy()
    bad[20011, 11] = "zzz-not-a-class"
    with pytest.raises(ValueError, match="unknown class label at row 20011"):
        native.encode_bytes(_csv_bytes(bad), enc, ncols=12, nthreads=8)


@pytest.mark.parametrize("stated, want", [
    ("1", 1), ("3", 3), ("64", 8), ("", None), ("0", None), ("x", None)])
def test_default_threads_follow_omp_num_threads(monkeypatch, stated, want):
    """The encoder's default pool is the process's stated compute threads
    (at most 8), else the CPU count's."""
    monkeypatch.setenv("OMP_NUM_THREADS", stated)
    assert native.threads() == (want or min(os.cpu_count() or 1, 8))


def test_iter_encoded_native_chunks_equal_whole():
    rows = generate_hosp_readmit(1000, seed=5)
    enc, _ = _encoders(HOSP_SCHEMA_JSON, rows)
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "h.csv")
        with open(path, "wb") as fh:
            fh.write(_csv_bytes(rows))
        chunks = list(native.iter_encoded_native(path, enc, ncols=12,
                                                 chunk_bytes=4096))
    assert len(chunks) > 1
    np.testing.assert_array_equal(np.concatenate([c.codes for c in chunks]),
                                  enc.transform(rows).codes)


# fuzz schema: binned numeric, categorical values next to the delimiter's
# bit patterns, a continuous field, an id and a label
FUZZ_CATS = ["a", "-", "+x", "..", "zz-9", "e9", "n/a", "0"]
FUZZ_SCHEMA = {"fields": [
    {"name": "id", "ordinal": 0, "id": True, "dataType": "string"},
    {"name": "num", "ordinal": 1, "dataType": "int", "feature": True,
     "bucketWidth": 3, "min": -50, "max": 50},
    {"name": "cat", "ordinal": 2, "dataType": "categorical",
     "feature": True, "cardinality": FUZZ_CATS},
    {"name": "x", "ordinal": 3, "dataType": "double", "feature": True},
    {"name": "cls", "ordinal": 4, "dataType": "categorical",
     "cardinality": ["N", "Y"]},
]}

_numbers = st.one_of(
    st.integers(-50, 50).map(str),
    st.floats(-50, 50, allow_nan=False).map(lambda v: f"{v:.9f}"),
    st.floats(-1, 1, allow_nan=False).map(lambda v: f"{v:.2e}"),
    st.integers(-9, 9).map(lambda v: f"  {v}"),
    st.tuples(st.integers(0, 8), st.integers(0, 10**12)).map(
        lambda t: f"-{t[0]}.{t[1]}"),
    st.integers(-5, 4).map(lambda v: f"{v}."))
_rows = st.lists(st.tuples(
    _numbers, st.one_of(st.sampled_from(FUZZ_CATS), st.just("OOV!")),
    _numbers, st.sampled_from("NY")), min_size=1, max_size=60)


@settings(max_examples=40, deadline=None, derandomize=True)
@given(rows=_rows, eol=st.sampled_from(["\n", "\r\n"]),
       lead=st.sampled_from(["", "\n", "\n\r\n", " \n"]))
def test_fuzz_native_equals_the_python_encoder(rows, eol, lead):
    enc = DatasetEncoder(FeatureSchema.from_json(FUZZ_SCHEMA))
    arr = np.array([[f"id-{i}", *r] for i, r in enumerate(rows)], dtype=object)
    data = lead.encode() + _csv_bytes(arr, eol)
    got = native.encode_bytes(data, enc, ncols=5)
    _assert_same(got, enc.transform(arr))


def _job_conf(tmp_path):
    rows = generate_hosp_readmit(50, seed=1)
    write_csv(str(tmp_path / "h.csv"), rows)
    import json
    (tmp_path / "h.json").write_text(json.dumps(HOSP_SCHEMA_JSON))
    return JobConfig({"feature.schema.file.path": str(tmp_path / "h.json")})


@pytest.mark.parametrize("fault", ["missing compiler", "source error"])
def test_failed_build_raises_and_nothing_falls_back(tmp_path, monkeypatch,
                                                    fault):
    build = tmp_path / "build"
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD", str(build))
    if fault == "missing compiler":
        monkeypatch.setattr(native, "CXX", str(tmp_path / "no" / "g++"))
        match = "could not run"
    else:
        bad = tmp_path / "bad.cpp"
        bad.write_text("this is not C++\n")
        monkeypatch.setattr(native, "SRC", str(bad))
        match = "exit"
    conf = _job_conf(tmp_path)
    with pytest.raises(RuntimeError, match=match):
        native.load()
    # the job path that takes the native encoder raises too: no Python
    # encoder stands in for a failed build
    with pytest.raises(RuntimeError, match="native encoder build failed"):
        Job.encode_input(conf, str(tmp_path / "h.csv"), need_rows=False)
    assert [n for n in os.listdir(build) if not n.endswith(".lock")] == []


def test_two_processes_building_at_once_both_load(tmp_path):
    build = tmp_path / "build"
    rows = generate_hosp_readmit(300, seed=7)
    csv = tmp_path / "h.csv"
    csv.write_bytes(_csv_bytes(rows))
    code = (
        "import sys, json\n"
        "from avenir_tpu_torch.runtime import native\n"
        "from avenir_tpu_torch.core.encoding import DatasetEncoder\n"
        "from avenir_tpu_torch.core.schema import FeatureSchema\n"
        "from avenir_tpu_torch.datagen.hosp_readmit import HOSP_SCHEMA_JSON\n"
        "native.BUILD = sys.argv[1]\n"
        "enc = DatasetEncoder(FeatureSchema.from_json(HOSP_SCHEMA_JSON))\n"
        "ds = native.encode_bytes(open(sys.argv[2], 'rb').read(), enc, 12)\n"
        "print(int(ds.codes.sum()), int(ds.labels.sum()))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(build),
                               str(csv)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [e for _, e in outs]
    enc = DatasetEncoder(FeatureSchema.from_json(HOSP_SCHEMA_JSON))
    want = enc.transform(rows)
    assert [o.strip() for o, _ in outs] == [
        f"{int(want.codes.sum())} {int(want.labels.sum())}"] * 2
    built = sorted(os.listdir(build))
    assert [n for n in built if n.endswith(".so")] == [
        os.path.basename(native.lib_path())]
    assert not [n for n in built if n.endswith(".build")]
