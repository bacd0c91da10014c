"""The port's models (avenir_tpu_torch.models) and state conversion held
against the JAX package on the CPU, on hospital-readmission data made from
a numpy seed.

Counts are equal exactly.  Float32 statistics are within abs 2e-6: both
packages compute them in float32 from the same counts, but reduce in a
different order.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from avenir_tpu.core.encoding import DatasetEncoder as JEncoder  # noqa: E402
from avenir_tpu.core.schema import FeatureSchema as JSchema  # noqa: E402
from avenir_tpu.datagen.hosp_readmit import (  # noqa: E402
    HOSP_SCHEMA_JSON as J_HOSP_SCHEMA, generate_hosp_readmit as j_generate)
from avenir_tpu.models import mutual_info as jmi  # noqa: E402
from avenir_tpu.models import naive_bayes as jnb  # noqa: E402
from avenir_tpu.ops import agg as jagg  # noqa: E402
from avenir_tpu.ops import pallas_hist as ph  # noqa: E402
from avenir_tpu_torch import convert  # noqa: E402
from avenir_tpu_torch.core.encoding import DatasetEncoder  # noqa: E402
from avenir_tpu_torch.core.schema import FeatureSchema  # noqa: E402
from avenir_tpu_torch.datagen.hosp_readmit import (  # noqa: E402
    HOSP_SCHEMA_JSON, generate_hosp_readmit)
from avenir_tpu_torch.models import mutual_info as mi  # noqa: E402
from avenir_tpu_torch.models import naive_bayes as nb  # noqa: E402
from avenir_tpu_torch.ops import agg, hist  # noqa: E402

TOL = 2e-6
SCORERS = ["mim", "mifs", "jmi", "disr", "mrmr"]


@pytest.fixture(scope="module")
def hosp():
    """(port encoder, port dataset, JAX encoder, JAX dataset) on the same rows."""
    rows = generate_hosp_readmit(3000, seed=5)
    enc = DatasetEncoder(FeatureSchema.from_json(HOSP_SCHEMA_JSON))
    jenc = JEncoder(JSchema.from_json(J_HOSP_SCHEMA))
    return enc, enc.fit_transform(rows), jenc, jenc.fit_transform(rows)


def test_datagen_and_encoding_are_copies(hosp):
    assert HOSP_SCHEMA_JSON == J_HOSP_SCHEMA
    np.testing.assert_array_equal(generate_hosp_readmit(500, seed=9),
                                  j_generate(500, seed=9))
    _, ds, _, jds = hosp
    np.testing.assert_array_equal(ds.codes, jds.codes)
    np.testing.assert_array_equal(ds.labels, jds.labels)
    np.testing.assert_array_equal(ds.n_bins, jds.n_bins)
    assert ds.class_values == jds.class_values


def _chunks(ds, size):
    return [ds.slice(s, s + size) for s in range(0, ds.num_rows, size)]


def test_mi_fit_counts_and_stats_match_jax(hosp):
    _, ds, _, jds = hosp
    got = mi.MutualInformation(device="cpu").fit(_chunks(ds, 700))
    want = jmi.MutualInformation().fit(jds)
    for name in ("class_counts", "feature_class_counts", "pair_class_counts",
                 "pair_index"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    for name in ("feature_class_mi", "feature_entropy", "feature_pair_mi",
                 "pair_class_mi", "pair_class_entropy",
                 "feature_pair_class_cond_mi"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=0, atol=TOL, err_msg=name)
    assert abs(got.class_entropy - want.class_entropy) <= TOL


def test_result_from_counts_matches_jax(hosp):
    _, ds, _, _ = hosp
    f, b, c = ds.num_binned, ds.max_bins, ds.num_classes
    pairs = mi.all_pairs(f)
    g = hist.cooc_counts(torch.from_numpy(ds.codes),
                         torch.from_numpy(ds.labels), b, c)
    fbc, pcc = hist.counts_from_cooc(g, f, b, c, pairs[:, 0], pairs[:, 1])
    cc = np.bincount(ds.labels, minlength=c)
    args = (["a%d" % i for i in range(f)], ["N", "Y"], ds.n_bins, cc, fbc,
            pairs, pcc)
    got, want = mi.result_from_counts(*args), jmi.result_from_counts(*args)
    np.testing.assert_allclose(got.pair_class_mi, want.pair_class_mi,
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(got.feature_pair_class_cond_mi,
                               want.feature_pair_class_cond_mi, rtol=0, atol=TOL)


@pytest.mark.parametrize("algo", SCORERS)
def test_scorer_rankings_match_jax(hosp, algo):
    _, ds, _, jds = hosp
    got = mi.score_features(mi.MutualInformation(device="cpu").fit(ds), algo)
    want = jmi.score_features(jmi.MutualInformation().fit(jds), algo)
    assert [f for f, _ in got] == [f for f, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               rtol=0, atol=4 * TOL)


def test_nb_model_file_byte_identical(hosp):
    enc, ds, jenc, jds = hosp
    model = nb.NaiveBayes(device="cpu").fit(_chunks(ds, 1000))
    jmodel = jnb.NaiveBayes().fit(jds)
    np.testing.assert_array_equal(model.bin_counts, jmodel.bin_counts)
    assert nb.model_to_lines(model, enc) == jnb.model_to_lines(jmodel, jenc)


def test_nb_predictions_match_jax(hosp):
    enc, ds, jenc, jds = hosp
    model = nb.NaiveBayes(device="cpu").fit(ds)
    jmodel = jnb.NaiveBayes().fit(jds)
    got = nb.NaiveBayes(device="cpu").predict(model, ds, validate=True,
                                              ambiguity_threshold=0.05)
    want = jnb.NaiveBayes().predict(jmodel, jds, validate=True,
                                    ambiguity_threshold=0.05)
    np.testing.assert_array_equal(got.predicted, want.predicted)
    np.testing.assert_array_equal(got.ambiguous, want.ambiguous)
    np.testing.assert_allclose(got.log_scores, want.log_scores, rtol=1e-6,
                               atol=1e-5)
    assert got.counters.as_dict() == want.counters.as_dict()
    cost = np.array([[0.0, 1.0], [3.0, 0.0]])
    np.testing.assert_array_equal(
        nb.NaiveBayes(device="cpu").predict(model, ds, cost=cost).predicted,
        jnb.NaiveBayes().predict(jmodel, jds, cost=cost).predicted)


def test_nb_gaussian_features_match_jax():
    """A continuous (Gaussian) feature: integer-valued data keeps the
    float32 moment sums exact, so model files are byte-identical."""
    schema = {"fields": [
        {"name": "id", "ordinal": 0, "id": True, "dataType": "string"},
        {"name": "color", "ordinal": 1, "dataType": "categorical",
         "feature": True, "cardinality": ["red", "green", "blue"]},
        {"name": "size", "ordinal": 2, "dataType": "int", "feature": True},
        {"name": "label", "ordinal": 3, "dataType": "categorical",
         "cardinality": ["a", "b"]},
    ]}
    rng = np.random.default_rng(4)
    n = 600
    rows = np.empty((n, 4), dtype=object)
    rows[:, 0] = [f"r{i:04d}" for i in range(n)]
    rows[:, 1] = rng.choice(["red", "green", "blue"], n)
    lab = rng.integers(0, 2, n)
    rows[:, 2] = (rng.integers(0, 40, n) + 20 * lab).astype(str)
    rows[:, 3] = np.where(lab == 1, "b", "a")
    enc = DatasetEncoder(FeatureSchema.from_json(schema))
    jenc = JEncoder(JSchema.from_json(schema))
    ds, jds = enc.fit_transform(rows), jenc.fit_transform(rows)
    model = nb.NaiveBayes(device="cpu").fit(ds)
    jmodel = jnb.NaiveBayes().fit(jds)
    assert nb.model_to_lines(model, enc) == jnb.model_to_lines(jmodel, jenc)
    np.testing.assert_array_equal(
        nb.NaiveBayes(device="cpu").predict(model, ds).predicted,
        jnb.NaiveBayes().predict(jmodel, jds).predicted)


def test_jax_model_file_loads_unchanged(hosp):
    enc, _, jenc, jds = hosp
    lines = jnb.model_to_lines(jnb.NaiveBayes().fit(jds), jenc)
    model = nb.model_from_lines(lines, enc)
    jmodel = jnb.model_from_lines(lines, jenc)
    np.testing.assert_array_equal(model.bin_counts, jmodel.bin_counts)
    np.testing.assert_array_equal(model.class_counts, jmodel.class_counts)
    np.testing.assert_array_equal(model.log_posterior, jmodel.log_posterior)
    assert nb.model_to_lines(model, enc) == lines


def test_accumulator_from_jax_carries_g(hosp):
    _, ds, _, jds = hosp
    f, b, c = ds.num_binned, ds.max_bins, ds.num_classes
    gk = ph.g_key(f, b, c)
    assert gk == "g:fmaj:f10:b13:c2"          # the CSV job's shape, wp 384
    jacc = jagg.Accumulator()
    for s in range(0, jds.num_rows, 1500):
        codes = jnp.asarray(jds.codes[s:s + 1500])
        labels = jnp.asarray(jds.labels[s:s + 1500])
        jacc.add(gk, ph.cooc_counts(codes, labels, b, c, block_cols=512,
                                    interpret=True))
        jacc.add("class", jagg.class_counts(labels, c))
    acc = convert.accumulator_from_jax(jacc.state())
    assert sorted(acc.names()) == sorted(jacc.names())
    pairs = mi.all_pairs(f)
    fbc, pcc = hist.counts_from_cooc(acc.get(gk), f, b, c,
                                     pairs[:, 0], pairs[:, 1])
    want = mi.MutualInformation(device="cpu").fit(ds)
    np.testing.assert_array_equal(fbc, want.feature_class_counts)
    np.testing.assert_array_equal(pcc, want.pair_class_counts)
    np.testing.assert_array_equal(acc.get("class"), want.class_counts)


def test_accumulator_from_jax_reads_the_bench_shape_g():
    """The bench.py shape 11×12×2 (key g:fmaj:f11:b12:c2) from the Pallas
    kernel in interpret mode reads out as the port's own counts."""
    f, b, c, n = 11, 12, 2, 900
    rng = np.random.default_rng(8)
    codes = rng.integers(0, b, size=(n, f)).astype(np.int32)
    labels = rng.integers(0, c, size=n).astype(np.int32)
    jacc = jagg.Accumulator()
    jacc.add("g:fmaj:f11:b12:c2", ph.cooc_counts(
        jnp.asarray(codes), jnp.asarray(labels), b, c, block_cols=256,
        interpret=True))
    acc = convert.accumulator_from_jax(jacc.state())
    pairs = mi.all_pairs(f)
    fbc, pcc = hist.counts_from_cooc(acc.get("g:fmaj:f11:b12:c2"), f, b, c,
                                     pairs[:, 0], pairs[:, 1])
    tc, tl = torch.from_numpy(codes), torch.from_numpy(labels)
    np.testing.assert_array_equal(fbc, agg.feature_class_counts(tc, tl, c, b))
    ip, jp = torch.from_numpy(pairs[:, 0]).long(), torch.from_numpy(pairs[:, 1]).long()
    np.testing.assert_array_equal(
        pcc, agg.pair_class_counts(tc[:, ip], tc[:, jp], tl, c, b))


@pytest.mark.parametrize("name,shape", [
    ("g", (384, 384)),                         # pre-layout bare key
    ("g:jmaj:f11:b12:c2", (384, 384)),         # a layout this build never picks
    ("g:packed:fmaj:f11:b12:c2", (384, 384)),  # packed provenance
    ("g:fmaj:f11:b12:c2", (256, 256)),         # wrong padded width
])
def test_accumulator_from_jax_refuses_foreign_layouts(name, shape):
    with pytest.raises(ValueError):
        convert.accumulator_from_jax({name: np.zeros(shape, np.int64)})


def test_entry_points_need_cuda_or_an_explicit_cpu_request():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        nb.NaiveBayes()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mi.MutualInformation()
    with pytest.raises(RuntimeError):
        nb.predict_batch(None, np.zeros((1, 1), np.int32),
                         np.zeros((1, 0), np.float32))
    with pytest.raises(ValueError):
        nb.NaiveBayes(device="meta")
