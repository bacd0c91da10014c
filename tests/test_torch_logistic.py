"""The port's logistic regression held against the JAX package on the CPU.

- ``design_matrix`` equal to the JAX package's.
- ``LogisticRegression.fit`` (float32 weights) and ``fit_chunked`` (float64
  weights, float32 chunk partials): every iteration's coefficients within
  REL = 1e-5 of that iteration's largest coefficient, with equal iteration
  counts and convergence status.  The two packages' matrix-vector products
  sum in different orders, so the history is not byte-identical; measured,
  the rows agree to ~2e-7 of their largest coefficient, but a coefficient
  near zero (its gradient a cancelling sum of 3000 terms of order one)
  differs by up to ~2e-4 of itself (pinned below; ROADMAP.md Queue 3).
  The seeds and thresholds below stop well away from the convergence
  threshold, so rounding does not move the stop by an iteration.
- ``LogisticRegressionJob`` through both CLIs, whole input and streamed:
  histories within REL, status line and counters equal; a coefficient
  file written by either package is resumed by the other and continues the
  same history; ``stream.checkpoint.dir`` raises the JAX package's error.
- ``predict_batch`` and ``convert.lr_model_from_jax``; ``atomic_write``
  and the history lock; a fit under a data mesh keeps the LR contract
  against the unsharded fit.
"""

import contextlib
import io
import json
import os
import pathlib
import stat

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from avenir_tpu.__main__ import main as jax_main  # noqa: E402
from avenir_tpu.core.encoding import DatasetEncoder as JEncoder  # noqa: E402
from avenir_tpu.core.schema import FeatureSchema as JSchema  # noqa: E402
from avenir_tpu.models import logistic as jlr  # noqa: E402
from avenir_tpu_torch import convert  # noqa: E402
from avenir_tpu_torch.__main__ import main as torch_main  # noqa: E402
from avenir_tpu_torch.core.csv_io import write_csv  # noqa: E402
from avenir_tpu_torch.core.encoding import DatasetEncoder  # noqa: E402
from avenir_tpu_torch.core.schema import FeatureSchema  # noqa: E402
from avenir_tpu_torch.datagen.hosp_readmit import (  # noqa: E402
    HOSP_SCHEMA_JSON, generate_hosp_readmit)
from avenir_tpu_torch.models import logistic as mlr  # noqa: E402
from avenir_tpu_torch.utils.locking import (  # noqa: E402
    FileLock, LockHeldError, atomic_write)

REL = 1e-5
CPU = "cpu"


def _close_histories(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= REL * np.abs(w).max(), i


@pytest.fixture(scope="module")
def hosp():
    rows = generate_hosp_readmit(3000, seed=2)
    ds = DatasetEncoder(FeatureSchema.from_json(HOSP_SCHEMA_JSON)).fit_transform(rows)
    jds = JEncoder(JSchema.from_json(HOSP_SCHEMA_JSON)).fit_transform(rows)
    return ds, jds


def test_design_matrix_equals_jax(hosp):
    ds, jds = hosp
    x = mlr.design_matrix(ds, device=CPU)
    np.testing.assert_array_equal(x.numpy(), jlr.design_matrix(jds))
    for kw in (dict(include_binned=False), dict(intercept=False)):
        np.testing.assert_array_equal(mlr.design_matrix(ds, device=CPU, **kw).numpy(),
                                      jlr.design_matrix(jds, **kw))


FIT_CASES = [
    dict(max_iterations=40, threshold_pct=0.0),                   # the limit
    dict(learning_rate=1.0, max_iterations=300, threshold_pct=0.5),
    dict(convergence="all", max_iterations=300, threshold_pct=2.0, l2=0.01),
]


@pytest.mark.parametrize("kw", FIT_CASES)
def test_fit_equals_jax(hosp, kw):
    ds, jds = hosp
    x, y = jlr.design_matrix(jds), jds.labels.astype(np.float32)
    want = jlr.LogisticRegression(**kw).fit(x, y)
    got = mlr.LogisticRegression(device=CPU, **kw).fit(x, y)
    assert (got.iterations, got.converged) == (want.iterations, want.converged)
    assert got.history[0].dtype == np.float32
    _close_histories(got.history, want.history)
    if kw["threshold_pct"] > 0:
        assert got.converged
    # resumed from the JAX history's fifth row, with the iterations left
    back = convert.lr_model_from_jax(want.history_lines()[:5])
    rest = dict(kw, max_iterations=kw["max_iterations"] - 5)
    resumed = mlr.LogisticRegression(device=CPU, **rest).fit(
        x, y, resume_from=back)
    assert (resumed.iterations, resumed.converged) == (want.iterations,
                                                       want.converged)
    _close_histories(resumed.history, want.history)


def test_pin_small_coefficients_differ_past_rel():
    """The LR rounding of ROADMAP.md Queue 3: on the second fit case the
    histories agree to 1e-6 of each iteration's largest coefficient, while
    some coefficient under 1/20 of the largest differs by more than REL of
    itself."""
    rows = generate_hosp_readmit(3000, seed=2)
    jds = JEncoder(JSchema.from_json(HOSP_SCHEMA_JSON)).fit_transform(rows)
    x, y = jlr.design_matrix(jds), jds.labels.astype(np.float32)
    kw = FIT_CASES[1]
    want = jlr.LogisticRegression(**kw).fit(x, y).history
    got = mlr.LogisticRegression(device=CPU, **kw).fit(x, y).history
    worst = 0.0
    for g, w in zip(got, want):
        g, w = g.astype(np.float64), w.astype(np.float64)
        scale = np.abs(w).max()
        assert np.abs(g - w).max() <= 1e-6 * scale
        nz = w != 0
        rel = np.abs(g - w)[nz] / np.abs(w)[nz]
        if rel.size and rel.max() > worst:
            worst = rel.max()
            assert np.abs(w[nz][rel.argmax()]) < scale / 20
    assert worst > REL


@pytest.mark.parametrize("kw", FIT_CASES[1:])
def test_fit_chunked_equals_jax(hosp, kw):
    _ds, jds = hosp
    x, y = jlr.design_matrix(jds), jds.labels.astype(np.float32)
    bounds = [(0, 700), (700, 1400), (1400, 2100), (2100, 3000)]
    chunks = [(i, x[a:b], y[a:b]) for i, (a, b) in enumerate(bounds)]
    want = jlr.LogisticRegression(**kw).fit_chunked(chunks)
    got = mlr.LogisticRegression(device=CPU, **kw).fit_chunked(
        list(reversed(chunks)))                 # folded in index order
    assert (got.iterations, got.converged, got.n_rows) == (
        want.iterations, want.converged, want.n_rows)
    assert got.history[0].dtype == np.float64
    _close_histories(got.history, want.history)


def test_predict_batch_and_convert(hosp):
    _ds, jds = hosp
    x, y = jlr.design_matrix(jds), jds.labels.astype(np.float32)
    jmodel = jlr.LogisticRegression(max_iterations=30).fit(x, y)
    model = convert.lr_model_from_jax(jmodel)
    assert model.history_lines() == jmodel.history_lines()
    probs, labels = mlr.predict_batch(model, x, device=CPU)
    jprobs, jlabels = jlr.predict_batch(jmodel, x)
    np.testing.assert_allclose(probs, jprobs, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(labels, jlabels)
    np.testing.assert_array_equal(mlr.LogisticRegression.predict(model, x),
                                  jlr.LogisticRegression.predict(jmodel, x))
    bad = jlr.LogisticRegressionModel(weights=jmodel.weights,
                                      history=[jmodel.weights[:-1]])
    with pytest.raises(ValueError, match="history rows"):
        convert.lr_model_from_jax(bad)


def test_accepts_a_mesh_and_fits_under_it(hosp):
    from avenir_tpu_torch.parallel.mesh import make_mesh

    ds, _jds = hosp
    x, y = mlr.design_matrix(ds, device=CPU), ds.labels.astype(np.float32)
    mesh = make_mesh(("data",), device=CPU)
    est = mlr.LogisticRegression(max_iterations=20, mesh=mesh, device=CPU)
    assert est.mesh is mesh and mesh.size("data") == 8
    got = est.fit(x, y)
    want = mlr.LogisticRegression(max_iterations=20, device=CPU).fit(x, y)
    assert (got.iterations, got.converged) == (want.iterations,
                                               want.converged)
    _close_histories(got.history, want.history)


def test_atomic_write_and_history_lock(tmp_path):
    target = tmp_path / "coeff.txt"
    target.write_text("old\n")
    os.chmod(target, 0o640)
    with pytest.raises(RuntimeError):
        with atomic_write(str(target)) as fh:
            fh.write("torn")
            raise RuntimeError("crash mid-write")
    assert target.read_text() == "old\n"
    with atomic_write(str(target)) as fh:
        fh.write("new\n")
    assert target.read_text() == "new\n"
    assert stat.S_IMODE(target.stat().st_mode) == 0o640
    assert sorted(p.name for p in tmp_path.iterdir()) == ["coeff.txt"]
    with FileLock(str(target)):
        with pytest.raises(LockHeldError):
            FileLock(str(target), timeout_s=0).acquire()


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


def _history(path):
    lines = pathlib.Path(path).read_text().splitlines()
    return [np.array([float(v) for v in ln.split(",")]) for ln in lines
            if ln and not ln.startswith("status")], lines[-1]


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    w = tmp_path_factory.mktemp("lr")
    write_csv(str(w / "train.csv"), generate_hosp_readmit(2500, seed=7))
    (w / "hosp.json").write_text(json.dumps(HOSP_SCHEMA_JSON))
    return w


MAINS = {"jax": (jax_main, []), "torch": (torch_main, ["--device", "cpu"])}


def _lr(work, pkg, out, *keys):
    main, extra = MAINS[pkg]
    return _run(main, ["LogisticRegressionJob",
                       f"-Dfeature.schema.file.path={work / 'hosp.json'}",
                       "-Dlearning.rate=1.0", *keys,
                       str(work / "train.csv"), str(out), *extra])


@pytest.mark.parametrize("keys", [[], ["-Dstream.chunk.rows=600"],
                                  ["-Dconvergence.criteria=all",
                                   "-Dconvergence.threshold=1.0"]])
def test_job_equals_jax(work, keys):
    tag = str(abs(hash(tuple(keys))))
    outs = {pkg: work / f"{pkg}_{tag}" for pkg in MAINS}
    counters = {pkg: _lr(work, pkg, outs[pkg], *keys) for pkg in MAINS}
    assert counters["torch"] == counters["jax"]
    got, got_status = _history(outs["torch"] / "part-00000")
    want, want_status = _history(outs["jax"] / "part-00000")
    assert got_status == want_status == "status,converged"
    _close_histories(got, want)
    assert (outs["torch"] / "coefficients.txt").read_text().splitlines() \
        == (outs["torch"] / "part-00000").read_text().splitlines()[:-1]


@pytest.mark.parametrize("first,second", [("jax", "torch"), ("torch", "jax")])
def test_job_resumes_the_other_packages_history(work, first, second):
    """Five iterations under one package, the rest under the other, from
    the coefficient file: the same history as one package's straight run."""
    coeff = work / f"coeff_{first}_{second}.txt"
    keys = ["-Dconvergence.threshold=0.5", f"-Dcoeff.file.path={coeff}"]
    _lr(work, first, work / f"a_{first}", *keys, "-Diteration.limit=5")
    assert len(coeff.read_text().splitlines()) == 5
    counters = _lr(work, second, work / f"b_{second}", *keys)
    straight = work / f"straight_{first}"
    _lr(work, first, straight)
    got, status = _history(work / f"b_{second}" / "part-00000")
    want, want_status = _history(straight / "part-00000")
    assert status == want_status == "status,converged"
    _close_histories(got, want)
    assert f"Run={len(want)}" in counters


def test_stream_checkpoint_refused_as_jax_refuses(work):
    errors = []
    for pkg in MAINS:
        with pytest.raises(Exception) as ei:
            _lr(work, pkg, work / f"refused_{pkg}", "-Dstream.chunk.rows=600",
                f"-Dstream.checkpoint.dir={work / 'ck'}")
        errors.append((type(ei.value).__name__, str(ei.value)))
    assert errors[0] == errors[1]
    assert "coefficient history file IS the checkpoint" in errors[0][1]
