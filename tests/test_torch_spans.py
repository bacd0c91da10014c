"""The port's spans inside the fused scan and the kNN call, on the CPU.

- A traced ``SharedScan.run`` journals ``scan`` ⊃ {``scan.read``,
  ``scan.chunk`` ⊃ {``scan.launch``, ``acc.fetch``, ``acc.add``}}, then
  ``scan.finalize`` beside ``scan``, on each of the scan's routes.
- A traced ``KNN.predict`` on the kernel route journals ``knn.predict`` ⊃
  {``knn.prep``, ``knn.launch``, ``knn.fetch``, ``knn.vote``} and, for
  rows whose certificate fails, ``knn.fallback``; the answers are an
  untraced call's.  Over several query tiles every route journals one
  ``knn.fetch``, after each tile's ``knn.prep`` and ``knn.launch``.
- While a ``torch.profiler`` capture runs, every live span is a
  ``record_function`` range (``user_annotation`` in the Chrome trace),
  tracer on or off.
- A span's duration holds no journal write, its own or its children's.
"""

import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from avenir_tpu_torch.core.encoding import (DatasetEncoder,  # noqa: E402
                                            EncodedDataset)
from avenir_tpu_torch.core.schema import FeatureSchema  # noqa: E402
from avenir_tpu_torch.datagen.hosp_readmit import (  # noqa: E402
    HOSP_SCHEMA_JSON, generate_hosp_readmit)
from avenir_tpu_torch.models import knn as mknn  # noqa: E402
from avenir_tpu_torch.models import naive_bayes as nb  # noqa: E402
from avenir_tpu_torch.ops import hist  # noqa: E402
from avenir_tpu_torch.ops import knn as kops  # noqa: E402
from avenir_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from avenir_tpu_torch.pipeline import scan  # noqa: E402
from avenir_tpu_torch.telemetry import spans as tel  # noqa: E402
from avenir_tpu_torch.telemetry.journal import read_events  # noqa: E402
from avenir_tpu_torch.utils import profiling  # noqa: E402

CHUNKS = 3


@pytest.fixture(autouse=True)
def _tracer_off():
    tel.tracer().disable()
    yield
    tel.tracer().disable()


@pytest.fixture
def journal(tmp_path):
    """Turns the process tracer on with its journal under ``tmp_path``;
    calling the fixture's value turns it off and returns the spans."""
    tracer = tel.tracer().enable(journal_dir=str(tmp_path / "tel"))
    path = tracer.journal_path

    def close():
        tel.tracer().disable()
        return _spans(read_events(path))

    return close


def _spans(events):
    """span id → (name, parent id, close attrs, dur_ms, close position)."""
    opens = {e["span"]: e for e in events if e["ev"] == "span.open"}
    out = {}
    for pos, e in enumerate(events):
        if e["ev"] == "span.close":
            o = opens[e["span"]]
            out[e["span"]] = (e["name"], o["parent"], e["attrs"],
                              e["dur_ms"], pos)
    return out


def _named(spans, name):
    return [sid for sid, s in spans.items() if s[0] == name]


def _children(spans, parent):
    return [s[0] for s in spans.values() if s[1] == parent]


@pytest.fixture(scope="module")
def hosp_chunks():
    enc = DatasetEncoder(FeatureSchema.from_json(HOSP_SCHEMA_JSON))
    ds = enc.fit_transform(generate_hosp_readmit(1500, seed=4))
    size = -(-ds.num_rows // CHUNKS)
    return enc, [ds.slice(s, min(s + size, ds.num_rows))
                 for s in range(0, ds.num_rows, size)]


def _run_scan(enc, chunks, pack_on=True):
    eng = scan.SharedScan(device="cpu", pack_on=pack_on)
    eng.register(scan.NaiveBayesConsumer(name="nb"))
    eng.register(scan.MutualInfoConsumer(
        feature_names=[f.name for f in enc.binned_fields], name="mi"))
    out = eng.run(chunks)
    return eng, out


@pytest.mark.parametrize("route", ["kernel", "packed", "einsum"])
def test_traced_scan_spans_each_layer(hosp_chunks, journal, monkeypatch,
                                      route):
    enc, chunks = hosp_chunks
    if route == "kernel":
        monkeypatch.setattr(hist, "use_kernel", lambda f, b, c, d: True)
    with tel.tracer().span("job.test"):
        eng, out = _run_scan(enc, chunks, pack_on=route != "einsum")
    spans = journal()
    assert eng.count_path.split(":")[0] == route
    (job,) = _named(spans, "job.test")
    assert _children(spans, job) == ["scan", "scan.finalize"]
    (scan_id,) = _named(spans, "scan")
    (fin,) = _named(spans, "scan.finalize")
    assert spans[scan_id][4] < spans[fin][4]
    inside = _children(spans, scan_id)
    assert inside.count("scan.read") == CHUNKS + 1    # the last finds none
    assert inside.count("scan.chunk") == CHUNKS
    assert set(inside) == {"scan.read", "scan.chunk"}
    for chunk in _named(spans, "scan.chunk"):
        names = _children(spans, chunk)
        assert {"scan.launch", "acc.fetch", "acc.add"} == set(names)
        if route == "kernel":
            # the class count is fetched before B1 is launched
            assert names == ["scan.launch", "acc.fetch", "acc.add"] * 2
        assert names.count("acc.fetch") == names.count("acc.add")
        for sid, s in spans.items():
            if s[1] == chunk and s[0] == "acc.fetch":
                assert s[2]["bytes"] > 0
    # the leaves are the layers' leaves: nothing opens inside them
    parents = {s[1] for s in spans.values()}
    for name in ("scan.launch", "acc.fetch", "acc.add", "scan.read"):
        assert not parents & set(_named(spans, name))
    _, plain = _run_scan(enc, chunks, pack_on=route != "einsum")
    assert (nb.model_to_lines(out["nb"], enc)
            == nb.model_to_lines(plain["nb"], enc))
    assert out["mi"].to_lines() == plain["mi"].to_lines()


def _refs(n, m, seed):
    rng = np.random.default_rng(seed)

    def ds(rows, labels):
        return EncodedDataset(
            codes=np.zeros((rows, 0), np.int32),
            cont=rng.random((rows, 9)).astype(np.float32), labels=labels,
            n_bins=np.zeros(0, np.int32), class_values=["a", "b", "c"],
            binned_ordinals=[], cont_ordinals=list(range(1, 10)))

    train = ds(n, rng.integers(0, 3, n).astype(np.int32))
    test = ds(m, None)
    return mknn.fit_knn(train), test


@pytest.mark.parametrize("refs,route", [(3000, "b6"), (20000, "b5")])
def test_traced_knn_predict_spans_and_same_answers(tmp_path, refs, route):
    model, test = _refs(refs, 64, seed=refs)
    knn = mknn.KNN(k=10, device="cpu")
    want = knn.predict(model, test)
    got, spans = _traced(knn, model, test, tmp_path)
    np.testing.assert_array_equal(got.neighbor_idx, want.neighbor_idx)
    np.testing.assert_array_equal(got.neighbor_dist, want.neighbor_dist)
    np.testing.assert_array_equal(got.predicted, want.predicted)
    (call,) = _named(spans, "knn.predict")
    assert spans[call][2] == {"queries": 64, "route": route}
    inside = _children(spans, call)
    assert {"knn.prep", "knn.launch", "knn.fetch", "knn.vote"} <= set(inside)
    assert inside.count("knn.fetch") == 1          # one tile
    (fetch,) = _named(spans, "knn.fetch")
    assert spans[fetch][2]["bytes"] == 64 * (10 * 4 + 10 * 8 + 1)
    assert inside[-1] == "knn.vote"


@pytest.mark.parametrize("metric,meshed,route", [
    ("manhattan", False, "scan"), ("euclidean", False, "b6"),
    ("euclidean", True, "sharded")])
def test_traced_multi_tile_call_fetches_once(tmp_path, metric, meshed,
                                             route):
    """64 queries in tiles of 24, 24 and 16: one ``knn.launch`` a tile,
    one ``knn.prep`` for the normalisation and one a tile's upload (and,
    on the kernel route, one a tile's query pack), then one
    ``knn.fetch`` for the whole call."""
    model, test = _refs(3000, 64, seed=29)
    mesh = pmesh.make_mesh(("data",), device="cpu") if meshed else None
    knn = mknn.KNN(k=10, metric=metric, test_tile=24, mesh=mesh,
                   device="cpu")
    want = knn.predict(model, test)
    got, spans = _traced(knn, model, test, tmp_path)
    np.testing.assert_array_equal(got.neighbor_idx, want.neighbor_idx)
    np.testing.assert_array_equal(got.neighbor_dist, want.neighbor_dist)
    (call,) = _named(spans, "knn.predict")
    assert spans[call][2] == {"queries": 64, "route": route}
    inside = _children(spans, call)
    assert inside.count("knn.launch") == 3
    assert inside.count("knn.prep") == 1 + 3 * (2 if route == "b6" else 1)
    assert inside.count("knn.fetch") == 1
    assert inside.index("knn.fetch") == len(inside) - 2    # then the vote
    (fetch,) = _named(spans, "knn.fetch")
    assert spans[fetch][2]["bytes"] == 64 * (10 * 4 + 10 * 8 + 1)


def _traced(knn, model, test, directory):
    path = tel.tracer().enable(journal_dir=str(directory)).journal_path
    try:
        got = knn.predict(model, test)
    finally:
        tel.tracer().disable()
    return got, _spans(read_events(path))


def test_forced_certificate_failure_spans_the_fallback(tmp_path,
                                                       monkeypatch):
    model, test = _refs(3000, 64, seed=11)
    knn = mknn.KNN(k=10, device="cpu")
    want = knn.predict(model, test)
    search = kops.search

    def failing(*args, **kwargs):
        d, idx, cert = search(*args, **kwargs)
        cert = cert.clone()
        cert[:5] = False
        return d, idx, cert

    monkeypatch.setattr(kops, "search", failing)
    before = mknn._nearest_neighbors_kernel.fallback_rows
    got, spans = _traced(knn, model, test, tmp_path)
    delta = mknn._nearest_neighbors_kernel.fallback_rows - before
    assert delta >= 5
    (call,) = _named(spans, "knn.predict")
    (fb,) = _named(spans, "knn.fallback")
    assert spans[fb][1] == call and spans[fb][2] == {"rows": delta}
    # no span of the query side opens inside the fallback
    assert not [s for s in spans.values() if s[1] == fb]
    np.testing.assert_array_equal(got.neighbor_idx, want.neighbor_idx)
    np.testing.assert_array_equal(got.neighbor_dist, want.neighbor_dist)


def _annotations(directory):
    (name,) = [n for n in os.listdir(directory)
               if n.endswith(".pt.trace.json")]
    with open(os.path.join(directory, name)) as fh:
        doc = json.load(fh)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    return {e.get("name") for e in events
            if e.get("cat") == "user_annotation"}


@pytest.mark.parametrize("traced", [False, True])
def test_spans_are_profiler_ranges_tracer_on_or_off(hosp_chunks, tmp_path,
                                                    traced):
    enc, chunks = hosp_chunks
    if traced:
        tel.tracer().enable(journal_dir=str(tmp_path / "tel"))
    path = tel.tracer().journal_path
    with profiling.trace(str(tmp_path / "xla" / "nbmi"), device="cpu"):
        _run_scan(enc, chunks)
    tel.tracer().disable()
    names = _annotations(tmp_path / "xla" / "nbmi")
    assert {"nbmi", "scan", "scan.read", "scan.chunk", "scan.launch",
            "acc.fetch", "acc.add", "scan.finalize"} <= names
    assert (path is not None) == traced
    if traced:
        spans = _spans(read_events(path))
        assert len(_named(spans, "scan.chunk")) == CHUNKS
        assert _named(spans, "acc.fetch")
    else:
        assert not (tmp_path / "tel").exists()


def test_span_with_tracer_off_holds_a_range_only_under_a_profiler():
    from torch.profiler import ProfilerActivity, profile

    tracer = tel.tracer()
    assert tracer.span("x") is tel.NOOP_SPAN
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sp = tracer.span("outside.range")
        assert sp is not tel.NOOP_SPAN and not sp.enabled
        with sp as inner:
            assert inner.block_on(7) == 7
            inner.set("k", "v").event("ignored")
            torch.ones(4).sum()
    assert tracer.span("x") is tel.NOOP_SPAN
    assert "outside.range" in {e.key for e in prof.key_averages()}


def test_span_duration_leaves_out_the_journal_writes(tmp_path, monkeypatch):
    """An empty leaf span reads under 10 ms although each of its events
    takes 20 ms to write, and so does its parent, whose children's writes
    are taken out too; the events' wall times keep the writes."""
    tracer = tel.tracer().enable(journal_dir=str(tmp_path))
    path = tracer.journal_path
    emit = tracer.journal.emit

    def slow(ev, **fields):
        time.sleep(0.02)
        emit(ev, **fields)

    monkeypatch.setattr(tracer.journal, "emit", slow)
    with tracer.span("parent") as parent:
        with tracer.span("leaf"):
            pass
        parent.event("checkpoint.save", dir="d")
    tracer.disable()
    events = read_events(path)
    spans = _spans(events)
    (leaf,) = _named(spans, "leaf")
    (parent,) = _named(spans, "parent")
    assert spans[leaf][3] < 10.0
    assert spans[parent][3] < 10.0
    ts = [e["ts"] for e in events if e.get("name") == "parent"]
    assert ts[1] - ts[0] >= 0.06       # the leaf's two writes, the event
