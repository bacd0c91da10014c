"""The library methods the port carries for parity with the JAX package's
public surface, each held against ``avenir_tpu`` on the same seeded input
on the CPU: NB's ``predicted_labels``, MI's distribution views,
correlation's ``top``, LR's ``predict_batch`` method, the schema's
``FeatureField`` / ``FeatureSchema`` helpers and JSON round trip (unknown
keys included), ``JobConfig.debug_on``, ``EncodedDataset.bin_mask``, the
native encoder's ``is_available`` / ``build_error`` and the planner's
``REWRITES``.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from avenir_tpu.core.config import JobConfig as JConf  # noqa: E402
from avenir_tpu.core.encoding import DatasetEncoder as JEncoder  # noqa: E402
from avenir_tpu.core.schema import FeatureSchema as JSchema  # noqa: E402
from avenir_tpu.datagen.hosp_readmit import (  # noqa: E402
    HOSP_SCHEMA_JSON as J_HOSP_SCHEMA)
from avenir_tpu.models import correlation as jcorr  # noqa: E402
from avenir_tpu.models import logistic as jlr  # noqa: E402
from avenir_tpu.models import mutual_info as jmi  # noqa: E402
from avenir_tpu.models import naive_bayes as jnb  # noqa: E402
from avenir_tpu.pipeline import plan as jplan  # noqa: E402
from avenir_tpu_torch.core.config import JobConfig  # noqa: E402
from avenir_tpu_torch.core.encoding import DatasetEncoder  # noqa: E402
from avenir_tpu_torch.core.schema import FeatureSchema  # noqa: E402
from avenir_tpu_torch.datagen.hosp_readmit import (  # noqa: E402
    HOSP_SCHEMA_JSON, generate_hosp_readmit)
from avenir_tpu_torch.models import correlation as corr  # noqa: E402
from avenir_tpu_torch.models import logistic as lr  # noqa: E402
from avenir_tpu_torch.models import mutual_info as mi  # noqa: E402
from avenir_tpu_torch.models import naive_bayes as nb  # noqa: E402
from avenir_tpu_torch.pipeline import plan  # noqa: E402
from avenir_tpu_torch.runtime import native  # noqa: E402

TOL = 2e-6


@pytest.fixture(scope="module")
def hosp():
    """(port encoder, port dataset, JAX encoder, JAX dataset), same rows."""
    rows = generate_hosp_readmit(2400, seed=11)
    enc = DatasetEncoder(FeatureSchema.from_json(HOSP_SCHEMA_JSON))
    jenc = JEncoder(JSchema.from_json(J_HOSP_SCHEMA))
    return enc, enc.fit_transform(rows), jenc, jenc.fit_transform(rows)


def _chunks(ds, size):
    return [ds.slice(s, min(s + size, ds.num_rows))
            for s in range(0, ds.num_rows, size)]


def test_nb_predicted_labels_equal_the_jax_ones(hosp):
    _, ds, _, jds = hosp
    est = nb.NaiveBayes(device="cpu")
    got = est.predict(est.fit(_chunks(ds, 700)), ds)
    jest = jnb.NaiveBayes()
    want = jest.predict(jest.fit(jds), jds)
    labels = got.predicted_labels(ds.class_values)
    assert labels == want.predicted_labels(jds.class_values)
    assert len(labels) == ds.num_rows and set(labels) <= set(ds.class_values)


@pytest.mark.parametrize("view", ["class_distr", "feature_distr",
                                  "feature_class_cond_distr",
                                  "feature_pair_distr",
                                  "feature_pair_class_cond_distr"])
def test_mi_distribution_views_equal_the_jax_ones(hosp, view):
    _, ds, _, jds = hosp
    got = getattr(mi.MutualInformation(device="cpu").fit(
        _chunks(ds, 700)), view)()
    want = np.asarray(getattr(jmi.MutualInformation().fit(jds), view)())
    assert got.shape == want.shape
    # both divide the same integer counts in float64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [1, 5, 100])
def test_correlation_top_equals_the_jax_one(hosp, k):
    enc, ds, jenc, jds = hosp
    names = [f.name for f in enc.binned_fields]
    got = corr.CategoricalCorrelation("cramerIndex", device="cpu").fit(
        _chunks(ds, 700), feature_names=names).top(k)
    want = jcorr.CategoricalCorrelation("cramerIndex").fit(
        iter(_chunks(jds, 700)),
        feature_names=[f.name for f in jenc.binned_fields]).top(k)
    assert [p for p, _ in got] == [p for p, _ in want]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               rtol=0, atol=TOL)
    assert len(got) == min(k, len(names) * (len(names) - 1) // 2)


def test_lr_predict_batch_method_equals_the_jax_one(hosp):
    _, ds, _, jds = hosp
    x = jlr.design_matrix(jds)
    rng = np.random.default_rng(4)
    w = rng.normal(0, 0.3, x.shape[1]).astype(np.float32)
    probs, labels = lr.LogisticRegression.predict_batch(
        w, x, threshold=0.4, device="cpu")
    jprobs, jlabels = jlr.LogisticRegression.predict_batch(w, x,
                                                           threshold=0.4)
    np.testing.assert_allclose(probs, jprobs, rtol=0, atol=1e-6)
    far = np.abs(jprobs - 0.4) > 1e-5             # away from the threshold
    np.testing.assert_array_equal(labels[far], jlabels[far])
    model = lr.LogisticRegressionModel(weights=w.astype(np.float64),
                                       history=[w], converged=True,
                                       iterations=1, n_rows=ds.num_rows)
    np.testing.assert_array_equal(
        lr.LogisticRegression.predict_batch(model, x, device="cpu")[0],
        lr.predict_batch(w, x, device="cpu")[0])


SCHEMA_WITH_EXTRAS = {
    "fields": [
        {"name": "id", "ordinal": 0, "dataType": "string", "id": True},
        {"name": "color", "ordinal": 1, "dataType": "categorical",
         "feature": True, "cardinality": ["red", "green", "blue"],
         "maxSplit": 2, "comment": "kept", "weight": 0.5},
        {"name": "age", "ordinal": 2, "dataType": "int", "feature": True,
         "bucketWidth": 10, "min": 0, "max": 90},
        {"name": "score", "ordinal": 3, "dataType": "double",
         "feature": True, "bucketWidth": 0.5},
        {"name": "cls", "ordinal": 4, "dataType": "categorical",
         "classAttr": True, "cardinality": ["N", "Y"]},
    ],
}


def test_schema_helpers_and_json_round_trip_equal_the_jax_ones(tmp_path):
    import avenir_tpu.core.schema as jschema_mod
    import avenir_tpu_torch.core.schema as schema_mod

    # the port keeps its own copy of the JAX-free module, kept verbatim
    assert open(schema_mod.__file__).read() == \
        open(jschema_mod.__file__).read()
    text = json.dumps(SCHEMA_WITH_EXTRAS)
    got, want = FeatureSchema.from_string(text), JSchema.from_string(text)
    assert got.to_json() == want.to_json()
    # unknown keys and maxSplit survive the round trip
    color = got.field_by_name("color")
    assert color.max_split == 2 and color.extra == {"comment": "kept",
                                                   "weight": 0.5}
    assert got.to_json()["fields"][1]["weight"] == 0.5
    assert FeatureSchema.from_json(got.to_json()).to_json() == got.to_json()
    assert got.feature_ordinals == want.feature_ordinals == [1, 2, 3]
    for f, jf in zip(got.fields, want.fields):
        assert f.to_json() == jf.to_json()
        assert f.is_integer == jf.is_integer
        for v in ("red", "blue", "mauve", "N"):
            assert f.cardinality_index(v) == jf.cardinality_index(v)
    assert [f.is_integer for f in got.fields] == [False, False, True,
                                                  False, False]
    assert color.cardinality_index("blue") == 2
    assert color.cardinality_index("mauve") == -1
    path = tmp_path / "schema.json"
    got.to_file(str(path))
    assert FeatureSchema.from_file(str(path)).to_json() == \
        JSchema.from_file(str(path)).to_json() == got.to_json()
    assert len(got) == len(want) and repr(got) == repr(want)
    with pytest.raises(KeyError):
        got.field_by_name("nope")


@pytest.mark.parametrize("props", [{}, {"debug.on": "true"},
                                   {"avenir.debug.on": "yes"},
                                   {"debug.on": "false"}])
def test_job_config_debug_on_equals_the_jax_one(props):
    assert JobConfig(dict(props)).debug_on == JConf(dict(props)).debug_on


def test_bin_mask_equals_the_jax_one(hosp):
    _, ds, _, jds = hosp
    got, want = ds.bin_mask(), jds.bin_mask()
    assert got.dtype == bool and got.shape == (ds.num_binned, ds.max_bins)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got.sum(1), ds.n_bins)


def test_native_is_available_and_build_error():
    """The encoder builds with g++ here: available, no error."""
    assert native.build_error() is None
    assert native.is_available() is True


def test_native_build_error_reports_a_failed_build(monkeypatch):
    def fail():
        raise RuntimeError("native encoder build failed (g++ exit 1)")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "build", fail)
    assert native.build_error() == \
        "native encoder build failed (g++ exit 1)"
    assert native.is_available() is False


def test_plan_rewrites_equal_the_jax_ones():
    assert plan.REWRITES == jplan.REWRITES
    # every rewrite the planner names on a unit is one of them
    src = open(plan.__file__).read()
    for r in plan.REWRITES:
        assert f'unit.rewrites.append("{r}")' in src
