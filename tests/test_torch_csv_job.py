"""The north-star job as its users run it, on the CPU at a small size:
the conf-declared NB + MI pipeline over CSV part files.

- Its written part files equal the plain reference of the benchmark's
  CSV configuration (``cardbench/configs/hosp_readmit_csv/``), which
  parses the same bytes itself: every count exact, NB and MI within the
  cell's limits.
- Traced, every chunk is one ``input.read`` and one ``input.encode``
  span (each file's end one more read, of nothing), children of the
  span open where the stream was built although they ran on the
  feeder's worker thread, and each stage's write is one
  ``output.write`` span; every row takes the native encoder.
- Untraced, the chunk stream reaches the feeder as it was built, and
  every input span it opens is the shared inert one.
"""

import importlib
import json
import os

import pytest

torch = pytest.importorskip("torch")

from avenir_tpu_torch.core.config import JobConfig  # noqa: E402
from avenir_tpu_torch.jobs import base  # noqa: E402
from avenir_tpu_torch.pipeline.driver import Pipeline  # noqa: E402
from avenir_tpu_torch.runtime import feeder  # noqa: E402
from avenir_tpu_torch.telemetry import spans as tel  # noqa: E402
from avenir_tpu_torch.telemetry.journal import read_events  # noqa: E402

from cardbench import harness  # noqa: E402

CELL = "hosp_readmit.csv"
SEED = 2**31 + 77
PARTS, PART_ROWS, CHUNK_ROWS = 3, 2500, 1000
CHUNKS = PARTS * -(-PART_ROWS // CHUNK_ROWS)


def _config_module(name):
    harness.config_module("hosp_readmit_csv")       # the package, by path
    return importlib.import_module(f"cardbench_config_hosp_readmit_csv.{name}")


@pytest.fixture(autouse=True)
def _tracer_off():
    tel.tracer().disable()
    yield
    tel.tracer().disable()


@pytest.fixture(scope="module")
def cell():
    return harness.Cell(harness.load_benchmark(), CELL)


@pytest.fixture
def job(tmp_path, cell):
    """The seeded part files, the schema and the properties file as the
    cell writes them; calling the value runs the pipeline into a fresh
    workspace and returns it."""
    generator = _config_module("generator")
    data = tmp_path / "data"
    data.mkdir()
    paths = [str(data / f"part-{p:05d}") for p in range(PARTS)]
    generator.write_pool(paths, cell.config["schema"], SEED, PART_ROWS, "cpu")
    schema = tmp_path / "hosp_readmit.json"
    schema.write_text(json.dumps(cell.config["schema"]))
    props = dict(cell.config["properties"],
                 **{"stream.chunk.rows": str(CHUNK_ROWS),
                    "feature.schema.file.path": str(schema),
                    "pipeline.bind.data": str(data)})
    conf_path = tmp_path / "job.properties"
    conf_path.write_text("".join(f"{k}={v}\n" for k, v in props.items()))

    def run(name="ws"):
        conf = JobConfig.from_file(str(conf_path))
        conf.set("pipeline.workspace", str(tmp_path / name))
        counters = Pipeline.from_conf(conf, device="cpu").run()
        return str(tmp_path / name), counters

    run.paths = paths
    return run


def test_written_part_files_equal_the_plain_reference(job, cell):
    reference = _config_module("reference")
    compare = _config_module("compare")
    ws, counters = job()
    assert counters["bayes"].get("SharedScan", "FusedStages") == 2
    assert counters["mi"].get("SharedScan", "Chunks") == CHUNKS
    schema, laplace = cell.config["schema"], cell.config["laplace"]
    tables = [reference.part_tables(p, schema) for p in job.paths]
    assert int(tables[0]["class"].sum()) == PART_ROWS
    ref = reference.from_tables(reference.job_tables(tables), schema, laplace)
    files = {s: compare.read_part(os.path.join(ws, s)) for s in ("bayes", "mi")}
    gaps = compare.job_gaps(files, ref, schema)
    assert gaps["counts_off"] == 0, gaps
    assert all(gaps[k] <= cell.limits[k] for k in cell.limits), gaps
    # the control, one precision step down, is outside the limits
    control = compare.job_gaps(reference.control_lines(tables, schema), ref,
                               schema)
    assert any(control[k] > cell.limits[k] for k in cell.limits), control


def _spans(events):
    opens = {e["span"]: e for e in events if e.get("ev") == "span.open"}
    closes = [e for e in events if e.get("ev") == "span.close"]
    return opens, closes


def _ancestors(opens, span_id):
    out = []
    while span_id in opens:
        out.append(opens[span_id]["name"])
        span_id = opens[span_id].get("parent")
    return out


def test_traced_input_and_output_spans_descend_from_the_run(job, tmp_path):
    native, python = (base.encode_chunk.rows_native,
                      base.encode_chunk.rows_python)
    tracer = tel.tracer().enable(journal_dir=str(tmp_path / "tel"))
    path = tracer.journal_path
    with tracer.span("test.run"):
        job()
    tracer.disable()
    opens, closes = _spans(read_events(path))
    by_name = {}
    for e in closes:
        by_name.setdefault(e["name"], []).append(e)
    assert len(by_name["scan.chunk"]) == CHUNKS
    assert len(by_name["input.encode"]) == CHUNKS
    # a read a chunk, and one of nothing at each file's end
    assert len(by_name["input.read"]) == CHUNKS + PARTS
    for name in ("input.read", "input.encode"):
        for e in by_name[name]:
            # run on the feeder's thread, parented where the stream was
            # built: the chain reaches the span open around the run
            assert _ancestors(opens, e["span"])[-1] == "test.run"
            assert "scan.fused" in _ancestors(opens, e["span"])
    assert sorted(e["attrs"]["lines"] for e in by_name["input.read"]) \
        == sorted([CHUNK_ROWS] * (CHUNKS - PARTS)
                  + [PART_ROWS % CHUNK_ROWS or CHUNK_ROWS] * PARTS
                  + [0] * PARTS)
    assert sum(e["attrs"]["bytes"] for e in by_name["input.read"]) \
        == sum(os.path.getsize(p) for p in job.paths)
    assert {e["attrs"]["route"] for e in by_name["input.encode"]} == {"native"}
    assert sum(e["attrs"]["rows"] for e in by_name["input.encode"]) \
        == PARTS * PART_ROWS
    writes = by_name["output.write"]
    assert sorted(e["attrs"]["stage"] for e in writes) == ["bayes", "mi"]
    assert all(e["attrs"]["lines"] > 0 for e in writes)
    for e in writes:
        assert _ancestors(opens, e["span"])[-1] == "test.run"
    assert base.encode_chunk.rows_native - native == PARTS * PART_ROWS
    assert base.encode_chunk.rows_python == python


def test_untraced_stream_reaches_the_feeder_unwrapped(job, monkeypatch):
    handed = []
    traced_pipeline = feeder._traced_pipeline

    def spy_pipeline(source, stage, device):
        out = traced_pipeline(source, stage, device)
        handed.append((source, out[0]))
        return out

    opened = []
    span = tel.Tracer.span

    def spy_span(self, name, *args, **kw):
        sp = span(self, name, *args, **kw)
        if name.startswith("input."):
            opened.append(sp)
        return sp

    monkeypatch.setattr(feeder, "_traced_pipeline", spy_pipeline)
    monkeypatch.setattr(tel.Tracer, "span", spy_span)
    ws, counters = job()
    (source, fed), = handed
    assert fed is source
    assert len(opened) == 2 * CHUNKS + PARTS
    assert all(sp is tel.NOOP_SPAN for sp in opened)
    assert counters["mi"].get("SharedScan", "Chunks") == CHUNKS
    assert os.path.exists(os.path.join(ws, "bayes", "part-00000"))
