"""The CSV cell (``hosp_readmit.csv``) driven on the CPU at a small size,
with a traffic of its own: the cell reads ``correct`` and its control
does not, every fault planted underneath the timed path reads not
``correct``, the jobs' input sets never repeat, and its three readers
read the program's input and output spans (None without them)."""

import os
import shutil
import time
from types import SimpleNamespace

import pytest

from cardbench import harness

CELL = "hosp_readmit.csv"
SMALL = {"rows": 6000, "part_rows": 3000, "pool_parts": 6,
         "parts_per_job": 2, "chunk_rows": 2000}
SEED = 2**31 + 4243


def run(bench, trace=False, seconds=0.3):
    cell = harness.Cell(bench, CELL)
    out = harness.run_cell(cell, SEED, seconds, trace, time.perf_counter(),
                           device="cpu", traffic=SMALL)
    return cell, out["result"]


def test_cell_is_correct_on_the_cpu(bench):
    cell, result = run(bench)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 2 and result["failed"] == 0
    assert set(result["metrics"]) == {"rows_per_s", "setup_s"}


def test_traced_run_reports_the_input_and_output_metrics(bench):
    cell, result = run(bench, trace=True)
    assert result["correct"], result["checks"]
    assert {m["name"] for m in cell.per_layer} == {
        "csv.read_ms", "csv.encode_ms", "csv.write_ms"}
    for name in ("csv.read_ms", "csv.encode_ms", "csv.write_ms"):
        assert result["metrics"][name]["value"] > 0


def test_control_is_not_correct(bench):
    cell = harness.Cell(bench, CELL)
    wl = harness.config_module("hosp_readmit_csv").Workload(
        cell.config, SMALL, SEED, "cpu")
    wl.make_inputs()
    readings = wl.control()
    assert any(readings[k] > cell.limits[k] for k in cell.limits), readings


# -- faults planted underneath the timed path ---------------------------------

def _part_skipped(monkeypatch):
    """The reader leaves out a job's last part file."""
    from avenir_tpu_torch.jobs import base

    files = base.input_files
    monkeypatch.setattr(base, "input_files", lambda path: files(path)[:-1])


def _line_dropped(monkeypatch):
    """One line of the whole window is read and never encoded."""
    from avenir_tpu_torch.jobs import base

    read = base._read_lines
    calls = []

    def dropping(fh, chunk_rows, mine):
        raw, n = read(fh, chunk_rows, mine)
        if raw:
            calls.append(1)
        if len(calls) == 5 and raw:     # the warm-up job reads 4 chunks
            raw = raw[1:]
        return raw, n

    monkeypatch.setattr(base, "_read_lines", dropping)


def _count_altered(monkeypatch):
    """One count of the NB part file one more than the job's."""
    from avenir_tpu_torch.jobs import base

    write = base.write_output

    def altered(path, lines, *args, **kw):
        if os.path.basename(path) == "bayes":
            cls, ordinal, label, n = lines[0].split(",")
            lines = [f"{cls},{ordinal},{label},{int(n) + 1}"] + list(lines[1:])
        return write(path, lines, *args, **kw)

    monkeypatch.setattr(base, "write_output", altered)


def _first_files_copied(monkeypatch):
    """Every job's part files are the first job's, as a memo of the job
    would leave them."""
    from avenir_tpu_torch.pipeline import driver

    run_ = driver.Pipeline.run
    first = {}

    def cached(self, *args, **kw):
        if "ws" not in first:
            first["ws"] = self.workspace
            return run_(self, *args, **kw)
        shutil.copytree(first["ws"], self.workspace)
        return {}

    monkeypatch.setattr(driver.Pipeline, "run", cached)


def _stage_unwritten(monkeypatch):
    """The MI stage's part file is never written."""
    from avenir_tpu_torch.jobs import base

    write = base.write_output

    def skipping(path, lines, *args, **kw):
        if os.path.basename(path) != "mi":
            return write(path, lines, *args, **kw)

    monkeypatch.setattr(base, "write_output", skipping)


FAULTS = [_part_skipped, _line_dropped, _count_altered, _first_files_copied,
          _stage_unwritten]


@pytest.mark.parametrize("plant", FAULTS,
                         ids=[p.__name__.lstrip("_") for p in FAULTS])
def test_fault_is_not_correct(bench, monkeypatch, plant):
    plant(monkeypatch)
    _, result = run(bench)
    assert result["correct"] is False, result["checks"]


# -- every job reads input of its own ------------------------------------------

def test_job_input_sets_never_repeat(bench):
    cell = harness.Cell(bench, CELL)
    module = harness.config_module("hosp_readmit_csv")
    t = cell.traffic
    sets = module.job_sets(SEED, t["pool_parts"], t["parts_per_job"], 1000)
    assert len(set(sets)) == len(sets) == 1000
    rounds = t["pool_parts"] // t["parts_per_job"]
    for r in range(0, 1000 - rounds + 1, rounds):
        # every part is read once in each round
        assert sorted(p for s in sets[r:r + rounds] for p in s) \
            == list(range(t["pool_parts"]))
    wl = module.Workload(cell.config, t, SEED, "cpu")
    assert [wl.parts_of(i) for i in range(-1, 40)] == sets[:41]


# -- the readers of the new spans -----------------------------------------------

class Journal:
    def __init__(self):
        self.events = []

    def span(self, name, dur_ms, parent=None, **attrs):
        sid = f"s{len(self.events)}"
        self.events += [
            {"ev": "span.open", "span": sid, "parent": parent, "name": name,
             "attrs": attrs},
            {"ev": "span.close", "span": sid, "name": name,
             "dur_ms": dur_ms, "attrs": attrs}]
        return sid


def _job(j, index, chunks, writes, new_spans=True):
    """One CSV job: per chunk its (read, encode) ms, then its writes."""
    unit = j.span(harness.UNIT_SPAN, 100.0, index=index)
    run_ = j.span("pipeline.run", 95.0, unit)
    fused = j.span("scan.fused", 90.0, run_)
    scan = j.span("scan", 80.0, fused)
    for read, encode in chunks:
        if new_spans:
            j.span("input.read", read, fused, lines=10)
            j.span("input.encode", encode, fused, route="native")
        j.span("scan.read", read + encode, scan)
        j.span("scan.chunk", 1.0, scan)
    if new_spans:
        for stage, ms in zip(("bayes", "mi"), writes):
            j.span("output.write", ms, fused, stage=stage)


def _ctx(events, profiled):
    wl = SimpleNamespace(shape=lambda: {})
    window = SimpleNamespace(items=[], latencies=[])
    return harness.LayerContext(None, wl, window, None, events, {}, profiled)


def test_csv_readers_take_the_spans_per_chunk_and_per_job():
    j = Journal()
    _job(j, 0, [(90.0, 90.0)], (90.0, 90.0))                 # profiled
    _job(j, 1, [(700.0, 150.0), (710.0, 170.0)], (2.0, 3.0))
    _job(j, 2, [(690.0, 160.0)], (1.0, 2.0))
    ctx = _ctx(j.events, {0})
    read = lambda name: harness.reader("layer_metrics", name).read(ctx)  # noqa: E731
    assert read("csv.read_ms") == pytest.approx(2100.0 / 3)
    assert read("csv.encode_ms") == pytest.approx(480.0 / 3)
    assert read("csv.write_ms") == pytest.approx(4.0)


@pytest.mark.parametrize("name", ["csv.read_ms", "csv.encode_ms",
                                  "csv.write_ms"])
def test_csv_readers_read_none_without_the_spans(bench, name):
    j = Journal()
    _job(j, 0, [(1.0, 1.0)], (1.0, 1.0), new_spans=False)
    assert harness.reader("layer_metrics", name).read(_ctx(j.events, set())) \
        is None
    entry = [m for m in bench["per_layer"] if m["name"] == name][0]
    assert entry["workloads"] == [CELL] and entry["moves"] == "rows_per_s"
