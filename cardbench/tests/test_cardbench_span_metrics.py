"""The per-layer readers of the program's spans inside the fused scan and
the kNN call, fed synthetic journals: units a profile slowed are left
out, a chunk's launches, fetches and adds are summed then divided by the
chunk count, a kNN call without a fallback counts 0, and a program
without the spans reads None."""

from types import SimpleNamespace

import pytest

from cardbench import harness

SCAN = ("scan.launch_ms", "scan.fetch_ms", "scan.add_ms", "scan.readout_ms")
KNN = ("knn.prep_ms", "knn.launch_ms", "knn.wait_ms", "knn.fallback_ms",
       "knn.vote_ms")


class Journal:
    """span.open / span.close events, each span under its parent."""

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


def _ctx(events, profiled):
    wl = SimpleNamespace(shape=lambda: {})
    window = SimpleNamespace(items=[], latencies=[])
    return harness.LayerContext(None, wl, window, None, events, {},
                                profiled)


def _read(name, ctx):
    return harness.reader("layer_metrics", name).read(ctx)


def _job(j, index, chunks, finalize_ms, new_spans=True):
    """One hospital job: its chunks, each a list of (launch, fetch, add)
    triples, and its read-out."""
    unit = j.span(harness.UNIT_SPAN, 100.0, index=index)
    run = j.span("cardbench.scan.run", 90.0, unit)
    scan = j.span("scan", 80.0, run)
    for groups in chunks:
        j.span("scan.read", 0.01, scan)
        chunk = j.span("scan.chunk", 5.0, scan)
        if new_spans:
            for launch, fetch, add in groups:
                j.span("scan.launch", launch, chunk)
                j.span("acc.fetch", fetch, chunk, bytes=8)
                j.span("acc.add", add, chunk)
    if new_spans:
        j.span("scan.finalize", finalize_ms, run)


def test_scan_readers_sum_a_chunks_spans_over_the_chunks():
    j = Journal()
    _job(j, 0, [[(90.0, 90.0, 90.0)]], 90.0)         # profiled: left out
    _job(j, 1, [[(0.1, 0.3, 0.05), (0.2, 0.4, 0.05)],
                [(0.1, 0.2, 0.1), (0.1, 0.2, 0.1)]], 3.0)
    _job(j, 2, [[(0.3, 0.6, 0.2), (0.0, 0.1, 0.0)]], 5.0)
    ctx = _ctx(j.events, {0})
    assert _read("scan.launch_ms", ctx) == pytest.approx(0.8 / 3)
    assert _read("scan.fetch_ms", ctx) == pytest.approx(1.8 / 3)
    assert _read("scan.add_ms", ctx) == pytest.approx(0.5 / 3)
    assert _read("scan.readout_ms", ctx) == pytest.approx(4.0)
    assert _read("scan.fold_ms", ctx) == pytest.approx(5.0)


def _call(j, index, prep, launch, fetch, vote, fallback=None,
          new_spans=True):
    unit = j.span(harness.UNIT_SPAN, 10.0, index=index)
    if not new_spans:
        return
    call = j.span("knn.predict", 9.0, unit, queries=4096, route="b5")
    for ms in prep:
        j.span("knn.prep", ms, call)
    j.span("knn.launch", launch, call)
    j.span("knn.fetch", fetch, call, bytes=8)
    if fallback is not None:
        j.span("knn.fallback", fallback, call, rows=2)
    j.span("knn.vote", vote, call)


def test_knn_readers_take_the_mean_per_call_a_missing_fallback_as_zero():
    j = Journal()
    _call(j, 0, [50.0], 50.0, 50.0, 50.0, fallback=50.0)   # profiled
    _call(j, 1, [0.1, 0.2], 0.5, 1.0, 0.3, fallback=4.0)
    _call(j, 2, [0.1, 0.1], 0.4, 0.8, 0.2)
    ctx = _ctx(j.events, {0})
    assert _read("knn.prep_ms", ctx) == pytest.approx(0.25)
    assert _read("knn.launch_ms", ctx) == pytest.approx(0.45)
    assert _read("knn.wait_ms", ctx) == pytest.approx(0.9)
    assert _read("knn.fallback_ms", ctx) == pytest.approx(2.0)
    assert _read("knn.vote_ms", ctx) == pytest.approx(0.25)
    # no call fell back: the fallback reads 0, not nothing
    j = Journal()
    _call(j, 0, [0.1], 0.4, 0.8, 0.2)
    assert _read("knn.fallback_ms", _ctx(j.events, set())) == 0.0


@pytest.mark.parametrize("name", SCAN + KNN)
def test_readers_read_none_from_a_program_without_the_spans(name):
    j = Journal()
    _job(j, 0, [[(0.1, 0.2, 0.3)]], 1.0, new_spans=False)
    _call(j, 1, [0.1], 0.4, 0.8, 0.2, new_spans=False)
    assert _read(name, _ctx(j.events, set())) is None


@pytest.mark.parametrize("name", SCAN + KNN)
def test_each_reader_is_a_program_span_metric_of_its_cells(bench, name):
    entry = [m for m in bench["per_layer"] if m["name"] == name][0]
    assert entry["source"] == "program_span" and entry["unit"] == "ms"
    e2e = {m["name"]: m.get("workloads") for m in bench["end_to_end"]}
    for cell in entry["workloads"]:
        assert cell in e2e[entry["moves"]]
