"""Each cell driven on the CPU at a small size: the unit of work and the
plain reference agree, the result line has the contract's shape, the
control comes out not correct, and so does every fault the cell can
have, planted underneath the timed path."""

import json
import time

import numpy as np
import pytest

from cardbench import harness
from cardbench.tests.small import SMALL

CELLS = ["hosp_readmit.c16m", "elearn_knn.r1m", "hosp_readmit.c1m",
         "elearn_knn.r10k"]
SEED = 2**31 + 4242


def run(bench, name, trace=False, seconds=0.3):
    cell = harness.Cell(bench, name)
    out = harness.run_cell(cell, SEED, seconds, trace, time.perf_counter(),
                           device="cpu",
                           traffic=SMALL[cell.entry["config"]])
    return cell, out["result"]


@pytest.mark.parametrize("name", CELLS)
def test_cell_is_correct_on_the_cpu(bench, name):
    cell, result = run(bench, name)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}


@pytest.mark.parametrize("name", ["hosp_readmit.c16m", "elearn_knn.r1m"])
def test_result_line_has_the_contracts_shape(bench, name):
    cell, result = run(bench, name)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "checks"
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    for k, c in result["checks"].items():
        assert set(c) == {"value", "limit"} and c["limit"] == cell.limits[k]
    json.loads(json.dumps(result, allow_nan=False))


def test_traced_run_reports_per_layer_metrics(bench):
    cell, result = run(bench, "hosp_readmit.c16m", trace=True)
    assert result["correct"]
    # the span metrics need no card; the trace metrics are left out here
    assert {"scan.fold_ms", "scan.finalize_ms"} <= set(result["metrics"])
    for name in result["metrics"]:
        assert name in {m["name"] for m in cell.per_layer}


def test_traced_knn_run_reports_its_tail_per_layer(bench):
    cell, result = run(bench, "elearn_knn.r10k", trace=True)
    assert result["correct"]
    assert "query_batch_p95_ms" not in {m["name"] for m in cell.end_to_end}
    assert result["metrics"]["knn.batch_p95_ms"]["value"] > 0
    assert "knn.fallback_pct.b6" in result["metrics"]
    for name in result["metrics"]:
        assert name in {m["name"] for m in cell.per_layer}


@pytest.mark.parametrize("config,name", [
    ("hosp_readmit", "hosp_readmit.c16m"), ("elearn_knn", "elearn_knn.r1m")])
def test_control_is_not_correct(bench, config, name):
    cell = harness.Cell(bench, name)
    wl = harness.config_module(config).Workload(cell.config, SMALL[config],
                                                SEED, "cpu")
    wl.make_inputs()
    readings = wl.control()
    assert any(readings[k] > cell.limits[k] for k in cell.limits), readings


# -- faults planted underneath the timed path ---------------------------------

def _hosp_state_unchanged(monkeypatch):
    from avenir_tpu_torch.ops import agg

    monkeypatch.setattr(agg.Accumulator, "add", lambda self, name, v: None)


def _hosp_cached_answer(monkeypatch):
    """Every job answered with the first job's result, as a memo of the
    job would: wrong wherever two jobs read different rows."""
    from avenir_tpu_torch.pipeline import scan

    run = scan.SharedScan.run
    first = {}

    def cached(self, chunks, *args, **kw):
        if "r" not in first:
            first["r"] = run(self, chunks, *args, **kw)
        return first["r"]

    monkeypatch.setattr(scan.SharedScan, "run", cached)


def _hosp_half_batch(monkeypatch):
    from avenir_tpu_torch.core.encoding import EncodedDataset
    from avenir_tpu_torch.pipeline import scan

    fold = scan.ChunkFolder.fold

    def half(self, ds, acc):
        n = ds.num_rows // 2
        fold(self, EncodedDataset(
            codes=ds.codes[:n], cont=ds.cont[:n], labels=ds.labels[:n],
            n_bins=ds.n_bins, class_values=ds.class_values,
            binned_ordinals=ds.binned_ordinals,
            cont_ordinals=ds.cont_ordinals), acc)

    monkeypatch.setattr(scan.ChunkFolder, "fold", half)


def _hosp_count_altered(monkeypatch):
    from avenir_tpu_torch.ops import agg

    add = agg.Accumulator.add

    def altered(self, name, value):
        arr = np.array(value.cpu().numpy() if hasattr(value, "cpu")
                       else value)
        if name == "class":
            arr.reshape(-1)[0] += 1
        add(self, name, arr)

    monkeypatch.setattr(agg.Accumulator, "add", altered)


def _knn_state_unchanged(monkeypatch):
    from avenir_tpu_torch.models import knn

    predict = knn.KNN.predict
    first = {}

    def stale(self, model, test, validate=False):
        if "r" not in first:
            first["r"] = predict(self, model, test, validate)
        return first["r"]

    monkeypatch.setattr(knn.KNN, "predict", stale)


def _knn_half_batch(monkeypatch):
    from avenir_tpu_torch.ops import knn as kops

    search = kops.search

    def half(codes_q, cont01_q, *args, **kw):
        m = codes_q.shape[0] // 2
        d, i, c = search(codes_q[:m], cont01_q[:m], *args, **kw)
        import torch

        return (torch.cat([d, d])[:codes_q.shape[0]],
                torch.cat([i, i])[:codes_q.shape[0]],
                torch.cat([c, c])[:codes_q.shape[0]])

    monkeypatch.setattr(kops, "search", half)


def _knn_answer_altered(monkeypatch):
    from avenir_tpu_torch.ops import knn as kops

    search = kops.search

    def altered(*args, **kw):
        d, i, c = search(*args, **kw)
        i = i.clone()
        i[0, 0] = (i[0, 0] + 1) % 20000
        return d, i, c

    monkeypatch.setattr(kops, "search", altered)


FAULTS = [
    ("hosp_readmit.c16m", _hosp_state_unchanged),
    ("hosp_readmit.c16m", _hosp_cached_answer),
    ("hosp_readmit.c1m", _hosp_cached_answer),
    ("hosp_readmit.c16m", _hosp_half_batch),
    ("hosp_readmit.c16m", _hosp_count_altered),
    ("elearn_knn.r1m", _knn_state_unchanged),
    ("elearn_knn.r10k", _knn_state_unchanged),
    ("elearn_knn.r1m", _knn_half_batch),
    ("elearn_knn.r1m", _knn_answer_altered),
]


@pytest.mark.parametrize("name,plant", FAULTS,
                         ids=[f"{n}-{p.__name__.lstrip('_')}"
                              for n, p in FAULTS])
def test_fault_is_not_correct(bench, monkeypatch, name, plant):
    plant(monkeypatch)
    _, result = run(bench, name)
    assert result["correct"] is False, result["checks"]


# -- every unit of a window reads inputs of its own ----------------------------

@pytest.mark.parametrize("config", ["hosp_readmit", "elearn_knn"])
def test_units_never_repeat_their_inputs(bench, config):
    name = {"hosp_readmit": "hosp_readmit.c16m",
            "elearn_knn": "elearn_knn.r1m"}[config]
    cell = harness.Cell(bench, name)
    for traffic in (SMALL[config], cell.traffic):
        wl = harness.config_module(config).Workload(cell.config, traffic,
                                                    SEED, "cpu")
        starts = {wl.start(i) for i in range(-1, wl.starts - 1)}
        assert len(starts) == wl.starts
    assert wl.starts >= 4000    # more than the units of a full window


def test_job_tables_are_the_tables_of_the_jobs_rows():
    import torch

    from cardbench.configs.hosp_readmit import reference

    n_bins, classes = [3, 4, 2], 2
    rows, slack, granule = 1000, 96, 16
    gen = torch.Generator().manual_seed(5)
    codes = torch.randint(-1, 5, (rows + slack, 3), generator=gen,
                          dtype=torch.int32)
    labels = torch.randint(-1, 3, (rows + slack,), generator=gen,
                           dtype=torch.int32)
    tables = reference.JobTables(codes, labels, n_bins, classes, rows, slack,
                                 granule, block=64)
    for first in range(0, slack + 1, granule):
        want = reference.on_host(reference.count_tables(
            codes[first:first + rows], labels[first:first + rows], n_bins,
            classes, block=128))
        got = tables.at(first)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
