"""The port's correlation family (Cramér, heterogeneity) and Fisher
discriminant held against the JAX package on the CPU.

- ``ops/info.py``'s four new statistics on seeded count stacks: within abs
  1e-6 of the JAX package's (both float32).
- ``CategoricalCorrelation.fit`` in both modes, with the three algorithms
  and with ``src``/``dst`` selections, on churn and hospital data in
  chunks: contingency tables equal integer for integer, statistics within
  abs 2e-6 (float32 reductions in another order).
- The port's kernel route, forced on the CPU where it runs B1's plain
  version, against the JAX package's einsum route.
- ``model_from_moments`` and the ``FisherDiscriminant`` job: byte-identical
  on float32-exact grid data; within rtol 1e-4 on the mixed hospital schema
  (the JAX package's own bar, tests/test_regress.py), where the JAX package
  sums the moments in float32 and the port in float64.
- The correlation, Fisher and moments consumers of the SharedScan equal the
  standalone fits.
- The three jobs' part files through both CLIs: equal field by field,
  numbers within 2e-6.
"""

import contextlib
import copy
import io
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from avenir_tpu.__main__ import main as jax_main  # noqa: E402
from avenir_tpu.core.encoding import DatasetEncoder as JEncoder  # noqa: E402
from avenir_tpu.core.schema import FeatureSchema as JSchema  # noqa: E402
from avenir_tpu.models import correlation as jcorr  # noqa: E402
from avenir_tpu.models import fisher as jfisher  # noqa: E402
from avenir_tpu.ops import info as jinfo  # noqa: E402
from avenir_tpu.pipeline import scan as jscan  # noqa: E402
from avenir_tpu_torch.__main__ import main as torch_main  # noqa: E402
from avenir_tpu_torch.core.csv_io import write_csv  # noqa: E402
from avenir_tpu_torch.core.encoding import DatasetEncoder  # noqa: E402
from avenir_tpu_torch.core.schema import FeatureSchema  # noqa: E402
from avenir_tpu_torch.datagen.churn import (  # noqa: E402
    CHURN_SCHEMA_JSON, generate_churn)
from avenir_tpu_torch.datagen.hosp_readmit import (  # noqa: E402
    HOSP_SCHEMA_JSON, generate_hosp_readmit)
from avenir_tpu_torch.models import correlation as corr  # noqa: E402
from avenir_tpu_torch.models import fisher  # noqa: E402
from avenir_tpu_torch.models import mutual_info as mi  # noqa: E402
from avenir_tpu_torch.models import naive_bayes as nb  # noqa: E402
from avenir_tpu_torch.ops import hist, info  # noqa: E402
from avenir_tpu_torch.pipeline import scan  # noqa: E402

STAT_TOL = 1e-6          # one statistic, same counts, float32 both sides
TOL = 2e-6               # statistics printed to 6 places
FISHER_RTOL = 1e-4
ALGORITHMS = ("cramerIndex", "concentrationCoeff", "uncertaintyCoeff")
MIXED_SCHEMA_JSON = copy.deepcopy(HOSP_SCHEMA_JSON)
for _f in MIXED_SCHEMA_JSON["fields"][1:4]:          # age, weight, height
    for _k in ("bucketWidth", "min", "max"):
        _f.pop(_k)


def _grid_rows(n, seed):
    """Hospital rows whose three continuous fields lie on a 0.5 grid in
    [0, 7.5]: every float32 partial sum of x and x² is exact."""
    rows = generate_hosp_readmit(n, seed=seed)
    rng = np.random.default_rng(seed)
    rows[:, 1:4] = (rng.integers(0, 16, size=(n, 3)) / 2).astype(str)
    return rows


def _encoded(schema_json, rows):
    enc = DatasetEncoder(FeatureSchema.from_json(schema_json))
    jenc = JEncoder(JSchema.from_json(schema_json))
    return enc, enc.fit_transform(rows), jenc, jenc.fit_transform(rows)


def _chunks(ds, size):
    return [ds.slice(s, min(s + size, ds.num_rows))
            for s in range(0, ds.num_rows, size)]


DATA = {
    "churn": lambda: _encoded(CHURN_SCHEMA_JSON, generate_churn(3000, seed=7)),
    "hosp": lambda: _encoded(HOSP_SCHEMA_JSON, generate_hosp_readmit(2400, seed=5)),
    "mixed": lambda: _encoded(MIXED_SCHEMA_JSON, generate_hosp_readmit(2400, seed=8)),
    "grid": lambda: _encoded(MIXED_SCHEMA_JSON, _grid_rows(2100, seed=8)),
}


@pytest.fixture(scope="module")
def data():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = DATA[name]()
        return cache[name]

    return get


def _names(enc):
    return [f.name for f in enc.binned_fields]


# ---------------------------------------------------------------------------
# ops/info.py
# ---------------------------------------------------------------------------

STATISTICS = ("cramer_index", "concentration_coefficient",
              "uncertainty_coefficient", "joint_entropy")


@pytest.mark.parametrize("shape", [(6, 4, 3), (5, 2, 2), (3, 5, 7), (4, 1, 6)])
@pytest.mark.parametrize("name", STATISTICS)
def test_statistics_equal_the_jax_ones(name, shape):
    rng = np.random.default_rng(sum(shape) + len(name))
    counts = rng.integers(0, 50, size=shape).astype(np.int64)
    counts[0] = 0                                   # an empty table
    counts[-1, 0, :] = 0                            # an empty row
    got = getattr(info, name)(torch.from_numpy(counts)).numpy()
    want = np.asarray(getattr(jinfo, name)(counts))
    assert got.shape == want.shape == shape[:1]
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=STAT_TOL)


# ---------------------------------------------------------------------------
# models/correlation.py
# ---------------------------------------------------------------------------

SELECTIONS = {
    "pairs": dict(),
    "against class": dict(against_class=True),
    "src/dst": dict(src=[0, 2, 3], dst=[1, 3, 4]),
    "src against class": dict(src=[1, 3], against_class=True),
}


def _fit_both(data, name, algorithm, sel, chunk=700):
    enc, ds, jenc, jds = data(name)
    got = corr.CategoricalCorrelation(algorithm, device="cpu").fit(
        _chunks(ds, chunk), feature_names=_names(enc), **sel)
    want = jcorr.CategoricalCorrelation(algorithm).fit(
        iter(_chunks(jds, chunk)), feature_names=_names(jenc), **sel)
    return got, want


def _assert_same_result(got, want):
    assert got.pairs == want.pairs and got.pair_names == want.pair_names
    np.testing.assert_array_equal(got.contingency, np.asarray(want.contingency))
    assert got.contingency.dtype == np.int64
    np.testing.assert_allclose(got.stat, want.stat, rtol=0, atol=TOL)


@pytest.mark.parametrize("sel", sorted(SELECTIONS))
@pytest.mark.parametrize("algorithm", ALGORITHMS)
@pytest.mark.parametrize("name", ["churn", "hosp"])
def test_fit_equals_the_jax_fit(data, name, algorithm, sel):
    got, want = _fit_both(data, name, algorithm, SELECTIONS[sel])
    assert len(got.pairs) > 0
    _assert_same_result(got, want)
    assert [ln.split(",")[:2] for ln in got.to_lines()] == \
        [ln.split(",")[:2] for ln in want.to_lines()]
    assert all(0.0 <= v <= 1.0 + 1e-6 for v in got.stat)


@pytest.mark.parametrize("against_class", [False, True])
@pytest.mark.parametrize("name", ["churn", "hosp"])
def test_kernel_route_on_the_cpu_equals_the_jax_einsum(data, monkeypatch,
                                                      name, against_class):
    """The kernel route forced on: one gram per chunk through
    ``hist.cooc_counts`` (B1's plain version on the CPU) with ONE class for
    feature pairs and the real classes against the class."""
    enc, ds, jenc, jds = data(name)
    calls = []
    real = hist.cooc_counts

    def spy(codes, labels, b, c):
        calls.append((tuple(codes.shape), b, c, int(labels.max())))
        return real(codes, labels, b, c)

    monkeypatch.setattr(hist, "use_kernel", lambda f, b, c, d: True)
    monkeypatch.setattr(hist, "cooc_counts", spy)
    for algorithm in ALGORITHMS:
        calls.clear()
        sel = dict(against_class=against_class)
        got = corr.CategoricalCorrelation(algorithm, device="cpu").fit(
            _chunks(ds, 700), feature_names=_names(enc), **sel)
        c = ds.num_classes if against_class else 1
        assert [(b, cc) for _s, b, cc, _m in calls] == \
            [(ds.max_bins, c)] * len(_chunks(ds, 700))
        assert all(m == (1 if against_class else 0) for *_x, m in calls)
        want = jcorr.CategoricalCorrelation(algorithm).fit(
            iter(_chunks(jds, 700)), feature_names=_names(jenc), **sel)
        _assert_same_result(got, want)


def test_fit_refuses_a_stale_accumulator(data):
    """The accumulator's stale-key gate, as the JAX package words it: keys
    of another route or another pair list are refused, never summed."""
    from avenir_tpu_torch.ops import agg

    enc, ds, _jenc, _jds = data("churn")
    acc = agg.Accumulator()
    acc.add(hist.g_key(ds.num_binned, ds.max_bins, 1), np.zeros((4, 4)))
    with pytest.raises(ValueError, match="incompatible with this run's count "
                                         "path \\(einsum\\)"):
        corr.CramerCorrelation(device="cpu").fit(ds, accumulator=acc)
    acc = agg.Accumulator()
    corr.CramerCorrelation(device="cpu").fit(ds, src=[0, 1], accumulator=acc)
    with pytest.raises(ValueError, match="attribute selection"):
        corr.CramerCorrelation(device="cpu").fit(ds, src=[2, 3],
                                                 accumulator=acc)


def test_einsum_key_prefix_equals_the_jax_one():
    for pairs in ([(0, 1), (0, 2)], [(3, -1)], [(np.int64(1), np.int32(4))]):
        assert corr._einsum_key_prefix(5, 4, pairs) == \
            jcorr._einsum_key_prefix(5, 4, pairs)


# ---------------------------------------------------------------------------
# models/fisher.py
# ---------------------------------------------------------------------------

def test_model_from_moments_equals_the_jax_one():
    rng = np.random.default_rng(3)
    cnt = np.array([700.0, 300.0])
    s1 = rng.normal(size=(2, 4)) * cnt[:, None]
    s2 = (s1 ** 2) / cnt[:, None] + rng.uniform(1, 5, size=(2, 4)) * cnt[:, None]
    got = fisher.model_from_moments(["a", "b"], cnt, s1, s2)
    want = jfisher.model_from_moments(["a", "b"], cnt, s1, s2)
    for key in ("mean", "var", "count", "pooled_var", "boundary"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key))
    assert got.log_odds == want.log_odds
    assert got.to_lines(["w", "x", "y", "z"]) == want.to_lines(["w", "x", "y", "z"])
    with pytest.raises(ValueError, match="exactly two classes"):
        fisher.model_from_moments(["a"], cnt[:1], s1[:1], s2[:1])


@pytest.mark.parametrize("name,rtol", [("grid", 0.0), ("mixed", FISHER_RTOL)])
def test_fisher_fit_equals_the_jax_fit(data, name, rtol):
    enc, ds, jenc, jds = data(name)
    assert ds.num_cont == 3
    got = fisher.FisherDiscriminant(device="cpu").fit(_chunks(ds, 700))
    want = jfisher.FisherDiscriminant().fit(iter(_chunks(jds, 700)))
    names = ["age", "weight", "height"]
    if rtol == 0.0:
        assert got.to_lines(names) == want.to_lines(names)
    for key in ("mean", "var", "pooled_var", "boundary"):
        np.testing.assert_allclose(getattr(got, key), getattr(want, key),
                                   rtol=rtol, atol=0)
    pred = fisher.FisherDiscriminant.predict(got, ds.cont, attr=0)
    np.testing.assert_array_equal(
        pred, jfisher.FisherDiscriminant.predict(want, jds.cont, attr=0))


# ---------------------------------------------------------------------------
# pipeline/scan.py consumers
# ---------------------------------------------------------------------------

def _engine(cls, **kw):
    eng = cls.SharedScan(**kw)
    eng.register(cls.NaiveBayesConsumer(name="nb"))
    eng.register(cls.MutualInfoConsumer(name="mi"))
    eng.register(cls.CorrelationConsumer(name="cramer", against_class=True))
    eng.register(cls.CorrelationConsumer(name="het",
                                         algorithm="uncertaintyCoeff"))
    eng.register(cls.CorrelationConsumer(name="sel", src=[0, 1, 2],
                                         dst=[3, 4],
                                         algorithm="concentrationCoeff"))
    eng.register(cls.FisherConsumer(name="fisher"))
    eng.register(cls.MomentsConsumer(name="moments"))
    return eng


@pytest.mark.parametrize("route", ["kernel", "packed", "einsum"])
def test_consumers_equal_the_standalone_fits(data, monkeypatch, route):
    enc, ds, _jenc, _jds = data("grid")
    chunks = _chunks(ds, 700)
    if route == "kernel":
        monkeypatch.setattr(hist, "use_kernel", lambda f, b, c, d: True)
    eng = _engine(scan, device="cpu", pack_on=route != "einsum")
    out = eng.run(chunks)
    assert eng.count_path.split(":")[0] == route
    monkeypatch.undo()
    crm = corr.CramerCorrelation(device="cpu").fit(chunks, against_class=True)
    _assert_same_result(out["cramer"], crm)
    assert out["cramer"].to_lines() == crm.to_lines()
    for key, model in (
            ("het", corr.HeterogeneityReductionCorrelation(
                "uncertaintyCoeff", device="cpu").fit(chunks)),
            ("sel", corr.HeterogeneityReductionCorrelation(
                device="cpu").fit(chunks, src=[0, 1, 2], dst=[3, 4]))):
        np.testing.assert_array_equal(out[key].contingency, model.contingency)
        assert out[key].to_lines() == model.to_lines()
    fm = fisher.FisherDiscriminant(device="cpu").fit(chunks)
    assert out["fisher"].to_lines() == fm.to_lines()
    cnt, s1, s2 = out["moments"]
    np.testing.assert_array_equal(cnt, fm.count)
    np.testing.assert_array_equal(s1 / np.maximum(cnt, 1)[:, None], fm.mean)
    model = nb.NaiveBayes(device="cpu").fit(chunks)
    assert nb.model_to_lines(out["nb"], enc) == nb.model_to_lines(model, enc)
    want = mi.MutualInformation(device="cpu").fit(chunks)
    assert out["mi"].to_lines() == want.to_lines()
    np.testing.assert_array_equal(s2, model.cont_sumsq)


def test_consumers_equal_the_jax_shared_scan(data):
    _enc, ds, _jenc, jds = data("grid")
    out = _engine(scan, device="cpu").run(_chunks(ds, 700))
    jout = _engine(jscan).run(iter(_chunks(jds, 700)))
    for key in ("cramer", "het", "sel"):
        _assert_same_result(out[key], jout[key])
    assert out["fisher"].to_lines() == jout["fisher"].to_lines()
    for a, b in zip(out["moments"], jout["moments"]):
        np.testing.assert_array_equal(a, b)


def test_fisher_and_moments_consumers_need_continuous_features(data):
    _enc, ds, _jenc, _jds = data("churn")
    for cons in (scan.FisherConsumer(name="f"), scan.MomentsConsumer(name="m")):
        eng = scan.SharedScan(device="cpu")
        eng.register(cons)
        with pytest.raises(scan.ScanError, match="continuous features"):
            eng.run(ds)


# ---------------------------------------------------------------------------
# the jobs through both CLIs
# ---------------------------------------------------------------------------

def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


def _same_lines(got: bytes, want: bytes, rtol: float = 0.0) -> None:
    got, want = got.decode().splitlines(), want.decode().splitlines()
    assert len(got) == len(want) > 0
    for lg, lw in zip(got, want):
        fg, fw = lg.split(","), lw.split(",")
        assert len(fg) == len(fw), (lg, lw)
        for a, b in zip(fg, fw):
            try:
                fa, fb = float(a), float(b)
            except ValueError:
                assert a == b, (lg, lw)
                continue
            assert abs(fa - fb) <= TOL + rtol * abs(fb), (lg, lw)


JOBS = {
    "cramer against class": ("churn", "CramerCorrelation",
                             ["-Ddest.attributes=6"]),
    "cramer pairs": ("churn", "CramerCorrelation", []),
    "cramer selection": ("hosp", "CramerCorrelation",
                         ["-Dsource.attributes=1,4,5",
                          "-Ddest.attributes=6,7,10"]),
    "concentration": ("hosp", "HeterogeneityReductionCorrelation",
                      ["-Dheterogeneity.algorithm=concentration"]),
    "uncertainty against class": ("churn", "HeterogeneityReductionCorrelation",
                                  ["-Dheterogeneity.algorithm=uncertainty",
                                   "-Ddest.attributes=6"]),
    "fisher grid": ("grid", "FisherDiscriminant", []),
    "fisher mixed": ("mixed", "FisherDiscriminant", []),
}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    work = tmp_path_factory.mktemp("corr_jobs")
    schemas = {"churn": CHURN_SCHEMA_JSON, "hosp": HOSP_SCHEMA_JSON,
               "grid": MIXED_SCHEMA_JSON, "mixed": MIXED_SCHEMA_JSON}
    rows = {"churn": generate_churn(2600, seed=4),
            "hosp": generate_hosp_readmit(2600, seed=4),
            "grid": _grid_rows(2600, seed=4),
            "mixed": generate_hosp_readmit(2600, seed=4)}
    for name in schemas:
        write_csv(str(work / f"{name}.csv"), rows[name])
        (work / f"{name}.json").write_text(json.dumps(schemas[name]))
    return work


@pytest.mark.parametrize("case", sorted(JOBS))
def test_job_part_files_equal_the_jax_ones(inputs, case):
    data_name, job, extra = JOBS[case]
    work = inputs
    argv = [job, f"-Dfeature.schema.file.path={work / (data_name + '.json')}",
            *extra]
    if job != "FisherDiscriminant":
        argv.append("-Dstream.chunk.rows=700")
    slug = case.replace(" ", "_")
    parts = {}
    for pkg, main, dev in (("jax", jax_main, []),
                           ("torch", torch_main, ["--device", "cpu"])):
        out = work / f"{pkg}_{slug}"
        counters = _run(main, argv + [str(work / f"{data_name}.csv"), str(out),
                                      *dev])
        assert "Processed=2600" in counters
        parts[pkg] = pathlib.Path(out, "part-00000").read_bytes()
    if case == "fisher mixed":
        _same_lines(parts["torch"], parts["jax"], rtol=FISHER_RTOL)
    elif case == "fisher grid":
        assert parts["torch"] == parts["jax"]
    else:
        _same_lines(parts["torch"], parts["jax"])
    lines = parts["torch"].decode().splitlines()
    if case == "cramer against class":
        assert [ln.split(",")[:2] for ln in lines] == [
            [n, "class"] for n in ("minUsed", "dataUsed", "CSCalls",
                                   "payment", "acctAge")]
    if case == "cramer pairs":
        assert len(lines) == 10
    if case == "cramer selection":
        # source ordinals 1, 4, 5 × dest ordinals 6, 7, 10, i < j
        assert len(lines) == 9
