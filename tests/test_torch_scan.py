"""The port's SharedScan (``avenir_tpu_torch/pipeline/scan.py``) and the
gram helpers it folds through (``ops/hist.py``, ``ops/agg.py``) on the CPU.

The scan's NB + MI results equal the port's standalone fits over the same
chunks (NB model lines byte-identical, MI lines identical), on each of its
three routes — ``kernel`` (forced here through ``hist.use_kernel``, so the
plain B1 version runs), ``packed`` and ``einsum``; and they equal the JAX
package's SharedScan on the same chunks: NB lines byte-identical, MI
statistics within abs 2e-6, count tensors integer for integer.  Class
moments are compared on float32-exact grid data (the port contract).
"""

import copy
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from avenir_tpu.core.encoding import DatasetEncoder as JEncoder  # noqa: E402
from avenir_tpu.core.schema import FeatureSchema as JSchema  # noqa: E402
from avenir_tpu.models import naive_bayes as jnb  # noqa: E402
from avenir_tpu.ops import agg as jagg  # noqa: E402
from avenir_tpu.ops import pallas_hist as ph  # noqa: E402
from avenir_tpu.pipeline import scan as jscan  # noqa: E402
from avenir_tpu_torch.core.config import JobConfig  # noqa: E402
from avenir_tpu_torch.core.encoding import DatasetEncoder  # noqa: E402
from avenir_tpu_torch.core.schema import FeatureSchema  # noqa: E402
from avenir_tpu_torch.datagen.hosp_readmit import (  # noqa: E402
    HOSP_SCHEMA_JSON, generate_hosp_readmit)
from avenir_tpu_torch.models import mutual_info as mi  # noqa: E402
from avenir_tpu_torch.models import naive_bayes as nb  # noqa: E402
from avenir_tpu_torch.ops import agg, hist  # noqa: E402
from avenir_tpu_torch.pipeline import scan  # noqa: E402

TOL = 2e-6
MIXED_SCHEMA_JSON = copy.deepcopy(HOSP_SCHEMA_JSON)
for _f in MIXED_SCHEMA_JSON["fields"][1:4]:
    for _k in ("bucketWidth", "min", "max"):
        _f.pop(_k)


def _rows(n, seed, mixed=False):
    rows = generate_hosp_readmit(n, seed=seed)
    if mixed:
        # float32-exact grid values: every partial sum of x and x² is exact
        rng = np.random.default_rng(seed)
        rows[:, 1:4] = (rng.integers(0, 16, size=(n, 3)) / 2).astype(str)
    return rows


def _encoded(schema_json, rows):
    """(port encoder, port dataset, JAX encoder, JAX dataset)."""
    enc = DatasetEncoder(FeatureSchema.from_json(schema_json))
    jenc = JEncoder(JSchema.from_json(schema_json))
    return enc, enc.fit_transform(rows), jenc, jenc.fit_transform(rows)


def _chunks(ds, size):
    return [ds.slice(s, min(s + size, ds.num_rows))
            for s in range(0, ds.num_rows, size)]


@pytest.fixture(scope="module")
def hosp():
    return _encoded(HOSP_SCHEMA_JSON, _rows(2100, seed=5))


@pytest.fixture(scope="module")
def mixed():
    return _encoded(MIXED_SCHEMA_JSON, _rows(2100, seed=8, mixed=True))


def _names(enc):
    return [f.name for f in enc.binned_fields]


def _port_scan(chunks, enc, pack_on=True):
    eng = scan.SharedScan(device="cpu", pack_on=pack_on)
    eng.register(scan.NaiveBayesConsumer(name="nb"))
    eng.register(scan.MutualInfoConsumer(feature_names=_names(enc), name="mi"))
    return eng, eng.run(chunks if isinstance(chunks, list) and len(chunks) > 1
                        else chunks[0])


def _assert_same_mi(got, want, exact):
    np.testing.assert_array_equal(got.class_counts, want.class_counts)
    np.testing.assert_array_equal(got.feature_class_counts,
                                  want.feature_class_counts)
    np.testing.assert_array_equal(got.pair_class_counts,
                                  want.pair_class_counts)
    np.testing.assert_array_equal(got.pair_index, want.pair_index)
    for key in ("feature_class_mi", "feature_pair_mi", "pair_class_mi",
                "feature_pair_class_cond_mi", "feature_entropy"):
        a, b = getattr(got, key), getattr(want, key)
        if exact:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=TOL)


@pytest.mark.parametrize("size", [2100, 500])
@pytest.mark.parametrize("route", ["kernel", "packed", "einsum"])
def test_scan_equals_the_standalone_fits(hosp, monkeypatch, route, size):
    enc, ds, _, _ = hosp
    chunks = _chunks(ds, size)
    if route == "kernel":
        monkeypatch.setattr(hist, "use_kernel", lambda f, b, c, d: True)
    eng, out = _port_scan(chunks, enc, pack_on=route != "einsum")
    assert eng.count_path.split(":")[0] == route
    assert eng.chunks_seen == len(chunks)
    model = nb.NaiveBayes(device="cpu").fit(chunks)
    assert nb.model_to_lines(out["nb"], enc) == nb.model_to_lines(model, enc)
    want = mi.MutualInformation(device="cpu").fit(chunks,
                                                  feature_names=_names(enc))
    _assert_same_mi(out["mi"], want, exact=True)
    assert out["mi"].to_lines() == want.to_lines()


@pytest.mark.parametrize("data", ["hosp", "mixed"])
@pytest.mark.parametrize("route", ["kernel", "packed", "einsum"])
def test_scan_equals_the_jax_shared_scan(request, monkeypatch, data, route):
    enc, ds, jenc, jds = request.getfixturevalue(data)
    chunks, jchunks = _chunks(ds, 700), _chunks(jds, 700)
    if route == "kernel":
        monkeypatch.setattr(hist, "use_kernel", lambda f, b, c, d: True)
    eng, out = _port_scan(chunks, enc, pack_on=route != "einsum")
    assert eng.count_path.split(":")[0] == route
    jeng = jscan.SharedScan()
    jeng.register(jscan.NaiveBayesConsumer(name="nb"))
    jeng.register(jscan.MutualInfoConsumer(feature_names=_names(jenc),
                                           name="mi"))
    jout = jeng.run(iter(jchunks))
    assert (nb.model_to_lines(out["nb"], enc)
            == jnb.model_to_lines(jout["nb"], jenc))
    if data == "mixed":
        np.testing.assert_array_equal(out["nb"].cont_sum, jout["nb"].cont_sum)
        np.testing.assert_array_equal(out["nb"].cont_sumsq,
                                      jout["nb"].cont_sumsq)
    _assert_same_mi(out["mi"], jout["mi"], exact=False)


def test_mixed_schema_takes_gram_moments_on_the_kernel_route(mixed,
                                                             monkeypatch):
    enc, ds, _, _ = mixed
    assert ds.num_cont == 3 and ds.num_binned == 7
    calls = []
    real = hist.gram_moments

    def spy(*args):
        calls.append(args[0].shape)
        return real(*args)

    monkeypatch.setattr(hist, "use_kernel", lambda f, b, c, d: True)
    monkeypatch.setattr(hist, "gram_moments", spy)
    chunks = _chunks(ds, 700)
    _eng, out = _port_scan(chunks, enc)
    assert calls == [(700, 7)] * 3
    model = nb.NaiveBayes(device="cpu").fit(chunks)
    assert nb.model_to_lines(out["nb"], enc) == nb.model_to_lines(model, enc)


def _codes(n, f, b, c, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(-1, b + 1, size=(f, n)).astype(np.int32)
    labels = rng.integers(-1, c + 1, size=n).astype(np.int32)
    return codes, labels


@pytest.mark.parametrize("shape,mode", [
    ((10, 13, 2), "fmaj"), ((20, 3, 2), "jmaj"), ((20, 20, 2), "cls"),
    ((100, 20, 2), "clsb")])
def test_gram_counts_cols_equals_the_jax_gram(shape, mode):
    f, b, c = shape
    assert hist.plan(f, b, c)[0] == ph.plan(f, b, c)[0] == mode
    codes, labels = _codes(300, f, b, c, seed=f)
    got = hist.gram_counts_cols(torch.from_numpy(codes),
                                torch.from_numpy(labels), b, c)
    want = np.asarray(ph.gram_counts_cols(codes, labels, b, c))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        hist.gram_counts(torch.from_numpy(codes.T.copy()),
                         torch.from_numpy(labels), b, c).numpy(), want)


def test_gram_moments_and_gram_counts_moments_equal_the_jax_ones(mixed):
    _, ds, _, _ = mixed
    codes, labels, cont = (torch.from_numpy(ds.codes),
                           torch.from_numpy(ds.labels),
                           torch.from_numpy(ds.cont))
    b, c = ds.max_bins, ds.num_classes
    want = [np.asarray(x) for x in ph.gram_counts_moments(
        ds.codes, ds.labels, ds.cont, b, c)]
    for fn in (hist.gram_moments, hist.gram_counts_moments):
        got = fn(codes, labels, cont, b, c)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)


SHAPES = [(f, b, c, p) for f in (1, 3, 10, 30, 100) for b in (2, 13, 40)
          for c in (2, 3, 9) for p in (0, f * (f - 1) // 2)]


def test_pack_tables_plans_equal_the_jax_planner():
    for f, b, c, p in SHAPES:
        for width in (None, 512):
            got = hist.pack_tables(f, b, c, p, max_width=width)
            want = ph.pack_tables(f, b, c, p, max_width=width)
            if want is None:
                assert got is None, (f, b, c, p, width)
                continue
            assert got.signature == want.signature
            assert got.g_key == want.g_key
            assert [tuple(m) for m in got.members] == \
                [tuple(m) for m in want.members]
            assert (got.band_bins, got.stripe_bins, got.disjoint) == \
                (want.band_bins, want.stripe_bins, want.disjoint)


class _JConf:
    """The JAX package's JobConfig over the same properties."""

    def __new__(cls, props):
        from avenir_tpu.core.config import JobConfig as JConfig
        return JConfig(dict(props))


FUSE_CASES = [
    ("MutualInformation", {"feature.schema.file.path": "s.json"}),
    ("BayesianDistribution", {"feature.schema.file.path": "s.json"}),
    ("CramerCorrelation", {"feature.schema.file.path": "s.json"}),
    ("NearestNeighbor", {"feature.schema.file.path": "s.json"}),
    ("MutualInformation", {"feature.schema.file.path": "s.json",
                           "scan.fuse": "false"}),
    ("MutualInformation", {"feature.schema.file.path": "s.json",
                           "stream.checkpoint.dir": "D"}),
    ("BayesianDistribution", {"feature.schema.file.path": "s.json",
                              "tabular.input": "false"}),
    ("MutualInformation", {}),
]


@pytest.mark.parametrize("job,props", FUSE_CASES)
def test_fuse_refusal_reasons_equal_the_jax_ones(job, props):
    assert (scan.fuse_refusal(job, JobConfig(dict(props)))
            == jscan.fuse_refusal(job, _JConf(props)))
    assert scan.stage_fusable(job, JobConfig(dict(props))) == (
        jscan.fuse_refusal(job, _JConf(props)) is None)


def test_stages_compatible(tmp_path):
    path = tmp_path / "s.json"
    path.write_text(json.dumps(HOSP_SCHEMA_JSON))
    base = {"feature.schema.file.path": str(path), "stream.chunk.rows": "700"}
    assert scan.stages_compatible([JobConfig(dict(base)), JobConfig(dict(base))])
    assert not scan.stages_compatible(
        [JobConfig(dict(base)),
         JobConfig(dict(base, **{"stream.chunk.rows": "500"}))])
    no_class = copy.deepcopy(HOSP_SCHEMA_JSON)
    no_class["fields"] = no_class["fields"][:-1]
    path2 = tmp_path / "nc.json"
    path2.write_text(json.dumps(no_class))
    assert not scan.stages_compatible(
        [JobConfig({"feature.schema.file.path": str(path2)})] * 2)


def test_scan_requires_labels_and_consumers(hosp):
    enc, ds, _, _ = hosp
    with pytest.raises(scan.ScanError, match="no consumers"):
        scan.SharedScan(device="cpu").run(ds)
    eng = scan.SharedScan(device="cpu")
    eng.register(scan.NaiveBayesConsumer(name="nb"))
    with pytest.raises(scan.ScanError, match="duplicate"):
        eng.register(scan.NaiveBayesConsumer(name="nb"))
    unlabeled = ds.slice(0, 100)
    unlabeled.labels = None
    with pytest.raises(scan.ScanError, match="requires labels"):
        eng.run(unlabeled)


def test_tables_refuse_a_foreign_gram_key(hosp):
    _, ds, _, _ = hosp
    folder = scan.ChunkFolder([scan.MutualInfoConsumer()], ds, "cpu")
    acc = agg.Accumulator()
    folder.fold(ds, acc)
    acc.add("g:jmaj:f10:b13:c2", np.zeros((2, 2), np.int32))
    with pytest.raises(scan.ScanError, match="layout changed"):
        folder.tables(acc, ds.num_rows)


def test_agg_additions_equal_the_jax_ops(hosp):
    _, ds, _, _ = hosp
    codes, labels = ds.codes, ds.labels
    tc, tl = torch.from_numpy(codes), torch.from_numpy(labels)
    b, c = ds.max_bins, ds.num_classes
    np.testing.assert_array_equal(agg.feature_counts(tc, b).numpy(),
                                  np.asarray(jagg.feature_counts(codes, b)))
    pairs = mi.all_pairs(codes.shape[1])
    ci, cj = pairs[:, 0], pairs[:, 1]
    np.testing.assert_array_equal(
        agg.pair_counts(tc[:, ci], tc[:, cj], b).numpy(),
        np.asarray(jagg.pair_counts(codes[:, ci], codes[:, cj], b)))
    got = agg.nb_mi_pipeline_step(tc, tl, ci, cj, c, b)
    want = jagg.nb_mi_pipeline_step(codes, labels, ci, cj, c, b)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(hist.nb_mi_step(tc, tl, ci, cj, c, b), want):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("kernel", [True, False])
def test_chunk_pipeline_routes_as_use_kernel(hosp, monkeypatch, kernel):
    _, ds, _, _ = hosp
    if kernel:
        monkeypatch.setattr(hist, "use_kernel", lambda f, b, c, d: True)
    f, b, c = ds.num_binned, ds.max_bins, ds.num_classes
    pairs = mi.all_pairs(f)
    step, chain, is_kernel = hist.chunk_pipeline(
        f, b, c, pairs[:, 0], pairs[:, 1], "cpu")
    assert is_kernel is kernel
    tc, tl = torch.from_numpy(ds.codes), torch.from_numpy(ds.labels)
    out = step(tc, tl + chain(step(tc, tl)))
    fbc, pcc = (hist.counts_from_cooc(out, f, b, c, pairs[:, 0], pairs[:, 1])
                if kernel else [x.numpy() for x in out])
    want = agg.nb_mi_pipeline_step(tc, tl, pairs[:, 0], pairs[:, 1], c, b)
    np.testing.assert_array_equal(fbc, want[0].numpy())
    np.testing.assert_array_equal(pcc, want[1].numpy())
