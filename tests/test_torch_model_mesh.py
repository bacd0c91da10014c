"""The model steps' ``mesh=`` seams in the port against the JAX package on
the CPU, under the conftest's eight host devices.

- The five explicit steps of ``parallel/collectives.py`` (NB 1-D and
  (data × model), MI (data × model), the sharded kNN top-k, the LR step)
  against the JAX package's ``shard_map`` steps at the shapes of its
  ``tests/test_collectives.py`` and ``tests/test_shard.py``: counts
  exactly, moments within rtol 1e-5 of JAX (equal on a 1/16 grid) and
  1e-12 of the port's unsharded float64, kNN distances within 1e-6 and
  indices equal on tie-free data, the LR step within relative 1e-6.
- ``nearest_neighbors(mesh=)``: equal to the JAX package's sharded route
  and, bit for bit, to the port's unsharded routes; the gate's fallback
  where k does not fit a shard.
- ``LogisticRegression(mesh=)`` within the LR contract (each iteration
  within 1e-5 of its largest coefficient, equal iteration counts and
  status) of the JAX package's meshed fit and the port's unsharded one.
- The Markov family's meshed counts byte-equal, the partially tagged
  chunk cap at ``MAX_EXACT_CHUNK_ROWS = 16``, record-sharded Viterbi
  paths equal to single-device, ``viterbi_time_sharded`` at T = 256.
- The five jobs through both CLIs under the default conf (an eight-slot
  data mesh in both packages), against the JAX package's part files and
  the port's own with ``data.parallel.auto=false``, and the kNN and
  Viterbi servables' responses under the mesh against the batch jobs'.

No test binds a socket or joins a process.
"""

import contextlib
import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from avenir_tpu.__main__ import main as jax_main  # noqa: E402
from avenir_tpu.core.encoding import (  # noqa: E402
    DatasetEncoder as JEncoder, EncodedDataset as JEncodedDataset)
from avenir_tpu.core.schema import FeatureSchema as JSchema  # noqa: E402
from avenir_tpu.models import knn as jknn  # noqa: E402
from avenir_tpu.models import logistic as jlr  # noqa: E402
from avenir_tpu.models import markov as jmk  # noqa: E402
from avenir_tpu.ops import agg as jagg  # noqa: E402
from avenir_tpu.parallel import collectives as jcoll  # noqa: E402
from avenir_tpu.parallel import mesh as jmesh  # noqa: E402
from avenir_tpu_torch.__main__ import main as torch_main  # noqa: E402
from avenir_tpu_torch.core.config import JobConfig  # noqa: E402
from avenir_tpu_torch.core.csv_io import write_csv  # noqa: E402
from avenir_tpu_torch.core.encoding import (DatasetEncoder,  # noqa: E402
                                            EncodedDataset)
from avenir_tpu_torch.core.schema import FeatureSchema  # noqa: E402
from avenir_tpu_torch.datagen import hmm_seq  # noqa: E402
from avenir_tpu_torch.datagen.event_seq import (  # noqa: E402
    generate_xaction_sequences, sequences_to_rows)
from avenir_tpu_torch.datagen.hosp_readmit import (  # noqa: E402
    HOSP_SCHEMA_JSON, generate_hosp_readmit)
from avenir_tpu_torch.jobs.base import read_lines  # noqa: E402
from avenir_tpu_torch.models import knn as mknn  # noqa: E402
from avenir_tpu_torch.models import logistic as mlr  # noqa: E402
from avenir_tpu_torch.models import markov as mk  # noqa: E402
from avenir_tpu_torch.ops import agg  # noqa: E402
from avenir_tpu_torch.ops import knn as kops  # noqa: E402
from avenir_tpu_torch.parallel import collectives  # noqa: E402
from avenir_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from avenir_tpu_torch.parallel.mesh import Blocks  # noqa: E402
from avenir_tpu_torch.serving import ModelRegistry  # noqa: E402

CPU = "cpu"
C, B = 3, 6
JAX_RTOL = 1e-5        # the JAX package's own sharded-against-local bar
SELF_RTOL = 1e-12      # float64 sums in another order, same package
DIST_TOL = 1e-6
LR_STEP_REL = 1e-6     # one LR step against the JAX package's
LR_REL = 1e-5          # the LR history contract (ROADMAP)
SCORE_TOL = 1e-3       # Viterbi path scores (tests/test_markov.py:178-198)
OFF = "-Ddata.parallel.auto=false"


def _mesh(*axes, shape=None):
    return pmesh.make_mesh(axes or ("data",), shape=shape, device=CPU)


def _jmesh(*axes, shape=None):
    return jmesh.make_mesh(axes or ("data",), shape=shape)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_the_conftest_gives_eight_slots():
    assert _mesh().sizes == {"data": 8}
    assert _jmesh().shape["data"] == 8


# ---------------------------------------------------------------------------
# the five explicit steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grid", [True, False])
def test_nb_fit_step_equals_jax(grid):
    rng = np.random.default_rng(3)
    n, f, fc = 1024, 4, 3
    codes = rng.integers(0, B, size=(n, f)).astype(np.int32)
    labels = rng.integers(0, C, size=n).astype(np.int32)
    cont = ((rng.integers(0, 16, size=(n, fc)) / 16.0) if grid
            else rng.normal(size=(n, fc))).astype(np.float32)
    got = collectives.sharded_nb_fit_step(_mesh(), C, B, fc)(codes, labels,
                                                             cont)
    want = jcoll.sharded_nb_fit_step(_jmesh(), C, B, fc)(
        jnp.asarray(codes), jnp.asarray(labels), jnp.asarray(cont))
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(_np(g).astype(np.int64),
                                      _np(w).astype(np.int64))
    np.testing.assert_array_equal(
        _np(got[0]), agg.feature_class_counts(torch.from_numpy(codes),
                                              torch.from_numpy(labels), C,
                                              B).numpy())
    _cnt, s1, s2 = agg.class_moments(torch.from_numpy(cont),
                                     torch.from_numpy(labels), C)
    for g, w, whole in zip(got[3:], want[3:], (s1, s2)):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(_np(g), _np(w), rtol=JAX_RTOL)
        np.testing.assert_allclose(_np(g), _np(whole), rtol=SELF_RTOL)
        if grid:                 # every float32 partial is exact
            np.testing.assert_array_equal(_np(g).astype(np.float32), _np(w))


@pytest.mark.parametrize("shape", [(4, 2), (2, 4)])
def test_nb_fit_step_2d_equals_jax(shape):
    rng = np.random.default_rng(5)
    n, f = 32 * 4 + 3, 8                # rows pad to the data axis
    codes = rng.integers(0, B, size=(n, f)).astype(np.int32)
    labels = rng.integers(0, C, size=n).astype(np.int32)
    mesh = _mesh("data", "model", shape=shape)
    fbc, cc = collectives.sharded_nb_fit_step_2d(mesh, C, B)(codes, labels)
    pad = (-n) % shape[0]
    jf, jc = jcoll.sharded_nb_fit_step_2d(
        _jmesh("data", "model", shape=shape), C, B)(
        jnp.asarray(np.pad(codes, ((0, pad), (0, 0)), constant_values=-1)),
        jnp.asarray(np.pad(labels, (0, pad), constant_values=-1)))
    assert isinstance(fbc, Blocks)
    assert [tuple(p.shape) for p in fbc.parts] == \
        [(f // shape[1], B, C)] * shape[1]
    assert {s.data.shape for s in jf.addressable_shards} == \
        {(f // shape[1], B, C)}
    assert fbc.on(mesh.axis_devices("model"))
    np.testing.assert_array_equal(torch.cat(fbc.parts).numpy(),
                                  _np(jf).astype(np.int64))
    np.testing.assert_array_equal(cc.numpy(), _np(jc).astype(np.int64))
    np.testing.assert_array_equal(cc.numpy(), np.bincount(labels,
                                                          minlength=C))


def test_mi_step_equals_jax():
    rng = np.random.default_rng(21)
    n, f = 512, 4
    codes = rng.integers(0, B, size=(n, f)).astype(np.int32)
    labels = rng.integers(0, C, size=n).astype(np.int32)
    pairs = np.array([(i, j) for i in range(f) for j in range(i + 1, f)],
                     np.int32)                           # 6 pairs, divides 2
    mesh = _mesh("data", "model", shape=(4, 2))
    pabc, fbc, cc = collectives.sharded_mi_step(mesh, C, B)(
        codes, labels, pairs[:, 0], pairs[:, 1])
    jp, jf, jc = jcoll.sharded_mi_step(_jmesh("data", "model", shape=(4, 2)),
                                       C, B)(
        jnp.asarray(codes), jnp.asarray(labels), jnp.asarray(pairs[:, 0]),
        jnp.asarray(pairs[:, 1]))
    assert [tuple(p.shape) for p in pabc.parts] == [(3, B, B, C)] * 2
    assert pabc.on(mesh.axis_devices("model"))
    np.testing.assert_array_equal(torch.cat(pabc.parts).numpy(), _np(jp))
    np.testing.assert_array_equal(fbc.numpy(), _np(jf))
    np.testing.assert_array_equal(cc.numpy(), _np(jc))
    whole = np.asarray(jagg.pair_class_counts(
        codes[:, pairs[:, 0]], codes[:, pairs[:, 1]], labels, C, B))
    np.testing.assert_array_equal(torch.cat(pabc.parts).numpy(), whole)


def test_mi_step_keeps_the_per_shard_chunk_cap(monkeypatch):
    monkeypatch.setattr(agg, "MAX_EXACT_CHUNK_ROWS", 16)
    rng = np.random.default_rng(2)
    codes = rng.integers(0, B, size=(64, 4)).astype(np.int32)
    labels = rng.integers(0, C, size=64).astype(np.int32)
    step = collectives.sharded_mi_step(_mesh("data", "model", shape=(4, 2)),
                                       C, B)
    step(codes[:60], labels[:60], [0, 1], [2, 3])        # 15 rows a shard
    with pytest.raises(ValueError, match="exact-count limit"):
        step(codes, labels, [0, 1], [2, 3])              # 16 rows a shard


@pytest.mark.parametrize("what", ["features", "pairs"])
def test_two_axis_steps_refuse_an_indivisible_block(what):
    mesh = _mesh("data", "model", shape=(4, 2))
    codes = np.zeros((8, 7 if what == "features" else 4), np.int32)
    labels = np.zeros(8, np.int32)
    with pytest.raises(ValueError, match="not divisible"):
        if what == "features":
            collectives.sharded_nb_fit_step_2d(mesh, C, B)(codes, labels)
        else:
            collectives.sharded_mi_step(mesh, C, B)(codes, labels, [0, 1, 2],
                                                    [1, 2, 3])


KNN_CASES = {
    # (refs, queries, k, ref_tile): the JAX tests' shape; tiles that divide
    # a shard; a shard that is not tile-divisible (one tile)
    "jax_test": (64, 5, 3, 65536),
    "tiled": (1024, 40, 5, 32),
    "one_tile": (1000, 40, 4, 48),
}


@pytest.mark.parametrize("case", sorted(KNN_CASES))
def test_knn_topk_step_equals_jax(case):
    n_ref, n_q, k, tile = KNN_CASES[case]
    rng = np.random.default_rng(7)
    f, fc = 4, 2
    rc = rng.integers(0, B, size=(n_ref, f)).astype(np.int32)
    rx = rng.normal(size=(n_ref, fc)).astype(np.float32)
    tc = rng.integers(0, B, size=(n_q, f)).astype(np.int32)
    tx = rng.normal(size=(n_q, fc)).astype(np.float32)
    lo, hi = rx.min(axis=0), rx.max(axis=0)
    d, i = collectives.sharded_knn_topk(_mesh(), k, B, ref_tile=tile)(
        tc, tx, rc, rx, lo, hi, n_ref)
    # the JAX step needs rows divisible by the axis: the same pad rows,
    # masked by n_real in both
    prc, prx = pmesh.pad_batch(pmesh.padded_size(n_ref, 8), rc, rx)
    jd, ji = jcoll.sharded_knn_topk(_jmesh(), k=k, num_bins=B,
                                    ref_tile=tile)(
        jnp.asarray(tc), jnp.asarray(tx), jnp.asarray(prc), jnp.asarray(prx),
        jnp.asarray(lo), jnp.asarray(hi), jnp.int32(n_ref))
    assert d.shape == i.shape == (n_q, k) and i.dtype == torch.int64
    np.testing.assert_allclose(d.numpy(), _np(jd), rtol=0, atol=DIST_TOL)
    np.testing.assert_array_equal(i.numpy(), _np(ji))
    assert (i.numpy() < n_ref).all()
    # against the whole reference set as one tile on one device
    wd, wi = kops.topk_over_tiles(
        torch.from_numpy(tc), torch.from_numpy(tx),
        torch.from_numpy(rc)[None], torch.from_numpy(rx)[None], n_ref,
        torch.from_numpy(lo), torch.from_numpy(hi), k, B, "euclidean")
    np.testing.assert_array_equal(i.numpy(), wi.numpy())
    np.testing.assert_allclose(d.numpy(), wd.numpy(), rtol=0, atol=DIST_TOL)


def test_knn_topk_step_keeps_the_lower_index_of_a_tie():
    """Equal references in different shards: the merge's stable sort in
    shard order keeps the lower global index first."""
    rc = np.zeros((32, 1), np.int32)
    rc[::2] = 1
    rx = np.zeros((32, 0), np.float32)
    d, i = collectives.sharded_knn_topk(_mesh(), 3, 2)(
        np.ones((1, 1), np.int32), np.zeros((1, 0), np.float32), rc, rx,
        np.zeros(0, np.float32), np.zeros(0, np.float32), 32)
    assert i.tolist() == [[0, 2, 4]] and d.tolist() == [[0.0] * 3]


def test_knn_topk_step_refuses_k_past_a_shard():
    with pytest.raises(ValueError, match="exceeds a shard"):
        collectives.sharded_knn_topk(_mesh(), 3, 2)(
            np.zeros((1, 1), np.int32), np.zeros((1, 0), np.float32),
            np.zeros((16, 1), np.int32), np.zeros((16, 0), np.float32),
            np.zeros(0, np.float32), np.zeros(0, np.float32), 16)


@pytest.mark.parametrize("n", [512, 509])
def test_lr_step_equals_jax(n):
    rng = np.random.default_rng(11)
    d = 4
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = rng.integers(0, 2, size=n).astype(np.float32)
    w0 = rng.normal(size=d).astype(np.float32)
    lr, l2 = 0.1, 0.01
    w1 = collectives.sharded_lr_step(_mesh())(w0, x, y, n, lr, l2)
    assert w1.dtype == torch.float32
    # the JAX step needs rows divisible by the axis: 0.0 pad rows, the true n
    px, py = pmesh.pad_batch(pmesh.padded_size(n, 8), x, y)
    jw = _np(jcoll.sharded_lr_step(_jmesh())(
        jnp.asarray(w0), jnp.asarray(px), jnp.asarray(py), jnp.float32(n),
        jnp.float32(lr), jnp.float32(l2)))
    assert np.abs(w1.numpy() - jw).max() <= LR_STEP_REL * np.abs(jw).max()
    p = 1.0 / (1.0 + np.exp(-(x.astype(np.float64) @ w0)))
    exact = w0 + lr * (x.astype(np.float64).T @ (y - p) / n - l2 * w0)
    np.testing.assert_allclose(w1.numpy(), exact, rtol=2e-5, atol=1e-6)


def test_one_slot_mesh_steps_are_the_unsharded_programs():
    """A one-device mesh runs each step as one shard: the LR step is the
    unsharded ``_grad_step`` bit for bit, the NB step the whole counts."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(300, 5)).astype(np.float32)
    y = rng.integers(0, 2, size=300).astype(np.float32)
    w = rng.normal(size=5).astype(np.float32)
    one = pmesh.make_mesh(("data",), devices=[torch.device(CPU)])
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    got = collectives.sharded_lr_step(one)(w, x, y, 300, 0.5, 0.0)
    want = mlr._grad_step(torch.from_numpy(w), torch.from_numpy(x),
                          torch.from_numpy(y), f32(300), f32(0.5), f32(0.0))
    assert torch.equal(got, want)
    codes = rng.integers(0, B, size=(300, 3)).astype(np.int32)
    labels = rng.integers(0, C, size=300).astype(np.int32)
    fbc, *_ = collectives.sharded_nb_fit_step(one, C, B, 5)(codes, labels, x)
    np.testing.assert_array_equal(fbc.numpy(), agg.feature_class_counts(
        torch.from_numpy(codes), torch.from_numpy(labels), C, B).numpy())


# ---------------------------------------------------------------------------
# kNN's mesh=
# ---------------------------------------------------------------------------

def _mixed(cls, rng, n, f=6, fc=8, nb=10):
    return cls(
        codes=rng.integers(0, nb, size=(n, f)).astype(np.int32),
        cont=rng.normal(size=(n, fc)).astype(np.float32),
        labels=rng.integers(0, 2, size=n).astype(np.int32),
        ids=None, n_bins=np.full(f, nb, np.int32), class_values=["a", "b"],
        binned_ordinals=list(range(f)), cont_ordinals=list(range(f, f + fc)))


def _twin(ds):
    return JEncodedDataset(
        codes=ds.codes, cont=ds.cont, labels=ds.labels, ids=ds.ids,
        n_bins=ds.n_bins, class_values=list(ds.class_values),
        binned_ordinals=list(ds.binned_ordinals),
        cont_ordinals=list(ds.cont_ordinals))


@pytest.fixture(scope="module")
def mixed():
    rng = np.random.default_rng(51)
    return _mixed(EncodedDataset, rng, 3000), _mixed(EncodedDataset, rng, 120)


@pytest.mark.parametrize("metric", ["euclidean", "manhattan"])
def test_nearest_neighbors_mesh_equals_jax_and_the_unsharded_routes(
        mixed, metric):
    train, test = mixed
    model = mknn.fit_knn(train)
    d, i = mknn.nearest_neighbors(model, test, 7, metric, ref_tile=128,
                                  device=CPU, mesh=_mesh())
    assert ("sharded", _mesh(), 128) in model.__dict__["_dev_cache"]
    # the exact scan, unsharded
    sd, si = mknn._search("scan", model, test, 7, metric, 700, 50,
                          torch.device(CPU), None)
    np.testing.assert_array_equal(i, si)
    np.testing.assert_array_equal(d, sd)
    if metric == "euclidean":          # the kernel route's plain versions
        kd, ki = mknn.nearest_neighbors(model, test, 7, device=CPU)
        np.testing.assert_array_equal(i, ki)
        np.testing.assert_array_equal(d, kd)
    jd, ji = jknn.nearest_neighbors(jknn.fit_knn(_twin(train)), _twin(test),
                                    7, metric, ref_tile=128, mesh=_jmesh())
    np.testing.assert_array_equal(i, _np(ji))
    np.testing.assert_allclose(d, _np(jd), rtol=0, atol=DIST_TOL)


def test_nearest_neighbors_gate_falls_back_where_k_exceeds_a_shard(
        mixed, monkeypatch):
    """20 references over 8 slots: 3 a shard, k = 5 does not fit, so the
    unsharded routes serve it, as the JAX package's gate sends it to its
    single-device scan."""
    train, test = mixed
    small = mknn.fit_knn(EncodedDataset(
        codes=train.codes[:20], cont=train.cont[:20],
        labels=train.labels[:20], ids=None, n_bins=train.n_bins,
        class_values=train.class_values,
        binned_ordinals=train.binned_ordinals,
        cont_ordinals=train.cont_ordinals))
    assert mknn._shard_rows(20, 8) == 3
    monkeypatch.setattr(collectives, "sharded_knn_topk",
                        lambda *a, **k: pytest.fail("sharded route taken"))
    d, i = mknn.nearest_neighbors(small, test, 5, device=CPU, mesh=_mesh())
    wd, wi = mknn.nearest_neighbors(small, test, 5, device=CPU)
    np.testing.assert_array_equal(i, wi)
    np.testing.assert_array_equal(d, wd)
    jd, ji = jknn.nearest_neighbors(
        jknn.fit_knn(JEncodedDataset(
            codes=train.codes[:20], cont=train.cont[:20],
            labels=train.labels[:20], n_bins=train.n_bins,
            class_values=list(train.class_values))), _twin(test), 5,
        mesh=_jmesh())
    np.testing.assert_array_equal(i, _np(ji))
    np.testing.assert_allclose(d, _np(jd), rtol=0, atol=DIST_TOL)


def test_knn_predict_under_the_mesh_equals_jax(mixed):
    train, test = mixed
    est = mknn.KNN(k=9, kernel="gaussian", mesh=_mesh(), device=CPU)
    got = est.predict(est.fit(train), test, validate=True)
    jest = jknn.KNN(k=9, kernel="gaussian", mesh=_jmesh())
    want = jest.predict(jest.fit(_twin(train)), _twin(test), validate=True)
    np.testing.assert_array_equal(got.predicted, want.predicted)
    np.testing.assert_array_equal(got.neighbor_idx, want.neighbor_idx)
    np.testing.assert_allclose(got.class_scores, want.class_scores,
                               atol=1e-6)
    assert got.counters.as_dict() == want.counters.as_dict()


# ---------------------------------------------------------------------------
# LR's mesh=
# ---------------------------------------------------------------------------

def _close_histories(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert np.abs(g - w).max() <= LR_REL * np.abs(w).max(), i


@pytest.fixture(scope="module")
def hosp():
    rows = generate_hosp_readmit(2999, seed=2)       # pads to the mesh
    ds = DatasetEncoder(FeatureSchema.from_json(HOSP_SCHEMA_JSON)) \
        .fit_transform(rows)
    jds = JEncoder(JSchema.from_json(HOSP_SCHEMA_JSON)).fit_transform(rows)
    return ds, jds


@pytest.mark.parametrize("kw", [dict(max_iterations=40),
                                dict(max_iterations=25, l2=0.01,
                                     convergence="all")])
def test_lr_fit_under_the_mesh_equals_jax(hosp, kw):
    _ds, jds = hosp
    x, y = jlr.design_matrix(jds), jds.labels.astype(np.float32)
    got = mlr.LogisticRegression(learning_rate=1.0, mesh=_mesh(),
                                 device=CPU, **kw).fit(x, y)
    want = jlr.LogisticRegression(learning_rate=1.0, mesh=_jmesh(),
                                  **kw).fit(x, y)
    single = mlr.LogisticRegression(learning_rate=1.0, device=CPU,
                                    **kw).fit(x, y)
    for other in (want, single):
        assert (got.iterations, got.converged) == \
            (other.iterations, other.converged)
        _close_histories(got.history, other.history)
    resumed = mlr.LogisticRegression(
        learning_rate=1.0, mesh=_mesh(), device=CPU, **kw).fit(
        x, y, resume_from=mlr.LogisticRegressionModel(
            weights=got.history[4], history=got.history[:5]))
    # the resumed run repeats the uninterrupted one's iterations from the
    # fifth row on (and runs max_iterations more where that one stopped at
    # its limit)
    assert len(resumed.history) >= len(got.history)
    _close_histories(resumed.history[:len(got.history)], got.history)


# ---------------------------------------------------------------------------
# the Markov family's mesh=
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def chain_seqs():
    return generate_xaction_sequences(301, seed=5)[0]


@pytest.fixture(scope="module")
def tagged():
    a, b, pi = hmm_seq.planted_hmm(seed=2)
    states, obs = hmm_seq.sample_hmm(a, b, pi, 301, 5, 30, seed=4)
    s_names = [f"s{i}" for i in range(a.shape[0])]
    o_names = [f"o{i}" for i in range(b.shape[1])]
    return states, obs, s_names, o_names


def test_markov_chain_counts_under_the_mesh(chain_seqs):
    got, _ = mk.MarkovChain(mesh=_mesh(), device=CPU).fit(chain_seqs)
    single, _ = mk.MarkovChain(device=CPU).fit(chain_seqs)
    want, _ = jmk.MarkovChain(mesh=_jmesh()).fit(chain_seqs)
    np.testing.assert_array_equal(got.counts, single.counts)
    np.testing.assert_array_equal(got.counts, want.counts)
    assert got.to_lines() == want.to_lines()


def test_hmm_tagged_counts_under_the_mesh(tagged):
    states, obs, s_names, o_names = tagged
    rows = hmm_seq.tagged_rows(states, obs, s_names, o_names)
    seqs = [[tuple(t.split(":")) for t in r[1:]] for r in rows]
    got = mk.HMMBuilder(mesh=_mesh(), device=CPU).fit_tagged(seqs)
    assert got.to_lines() == mk.HMMBuilder(device=CPU).fit_tagged(
        seqs).to_lines()
    assert got.to_lines() == jmk.HMMBuilder(mesh=_jmesh()).fit_tagged(
        seqs).to_lines()


def test_hmm_partial_counts_under_the_mesh(tagged):
    states, obs, s_names, o_names = tagged
    rows = hmm_seq.partial_rows(states, obs, s_names, o_names)
    seqs = [r[1:] for r in rows]
    got = mk.HMMBuilder(mesh=_mesh(), device=CPU).fit_partially_tagged(
        seqs, s_names)
    assert got.to_lines() == mk.HMMBuilder(device=CPU).fit_partially_tagged(
        seqs, s_names).to_lines()
    assert got.to_lines() == jmk.HMMBuilder(
        mesh=_jmesh()).fit_partially_tagged(seqs, s_names).to_lines()


def test_hmm_partial_chunk_cap_under_the_mesh(monkeypatch):
    """``MAX_EXACT_CHUNK_ROWS = 16`` on eight slots: the emission step is
    8 (a multiple of the axis), so no padded chunk reaches the cap (after
    the JAX package's ``test_hmm_partially_tagged_meshed_chunk_cap``)."""
    monkeypatch.setattr(agg, "MAX_EXACT_CHUNK_ROWS", 16)
    monkeypatch.setattr(jagg, "MAX_EXACT_CHUNK_ROWS", 16)
    seen = []
    real = agg.weighted_transition_counts

    def spy(a, b, w, num_a, num_b):
        seen.append(a.shape[0])
        return real(a, b, w, num_a, num_b)

    monkeypatch.setattr(agg, "weighted_transition_counts", spy)
    rng = np.random.default_rng(9)
    token_seqs = []
    for _ in range(30):
        seq = []
        for _ in range(6):
            seq.append("S1" if rng.random() < 0.5 else "S2")
            seq.extend(rng.choice(["o1", "o2", "o3"], size=3).tolist())
        token_seqs.append(seq)
    kw = dict(states=["S1", "S2"], window_function=[1.0, 0.5, 0.25])
    meshed = mk.HMMBuilder(laplace=0.1, mesh=_mesh(), device=CPU) \
        .fit_partially_tagged(token_seqs, **kw)
    assert seen and max(seen) == 1          # 8-row chunks, a row a shard
    single = mk.HMMBuilder(laplace=0.1, device=CPU).fit_partially_tagged(
        token_seqs, **kw)
    want = jmk.HMMBuilder(laplace=0.1, mesh=_jmesh()).fit_partially_tagged(
        token_seqs, **kw)
    assert meshed.to_lines() == single.to_lines() == want.to_lines()


def _random_model(rng, s, v):
    return mk.HMMModel(
        states=[f"s{i}" for i in range(s)],
        observations=[str(i) for i in range(v)],
        transition=rng.dirichlet(np.ones(s), size=s),
        emission=rng.dirichlet(np.ones(v), size=s),
        initial=rng.dirichlet(np.ones(s)))


@pytest.mark.parametrize("method", ["scan", "assoc"])
def test_viterbi_records_under_the_mesh_equal_single(method):
    """13 records on eight slots (pad rows engage), one ragged."""
    rng = np.random.default_rng(1)
    model = _random_model(rng, 3, 4)
    obs = rng.integers(0, 4, size=(13, 9)).astype(np.int32)
    obs[3, 6:] = -1
    got = mk.ViterbiDecoder(model, method=method, mesh=_mesh(),
                            device=CPU).decode_codes(obs)
    single = mk.ViterbiDecoder(model, method=method,
                               device=CPU).decode_codes(obs)
    want = jmk.ViterbiDecoder(model, method=method,
                              mesh=_jmesh()).decode_codes(obs)
    assert got.shape == (13, 9) and got.dtype == np.int32
    np.testing.assert_array_equal(got, single)
    np.testing.assert_array_equal(got, np.asarray(want))


def _score(path, obs, la, lb, lpi):
    s = float(lpi[path[0]] + lb[path[0], obs[0]])
    return s + sum(float(la[path[i - 1], path[i]] + lb[path[i], obs[i]])
                   for i in range(1, len(obs)))


@pytest.mark.parametrize("slots", [8, 1])
def test_viterbi_time_sharded_equals_the_sequential_decoders(slots):
    rng = np.random.default_rng(0)
    s, v, t = 4, 6, 256
    a, b, pi = (rng.dirichlet(np.ones(s), size=s),
                rng.dirichlet(np.ones(v), size=s), rng.dirichlet(np.ones(s)))
    la, lb, lpi = (np.log(np.maximum(m, 1e-12)).astype(np.float32)
                   for m in (a, b, pi))
    obs = rng.integers(0, v, size=t).astype(np.int32)
    mesh = _mesh() if slots == 8 else pmesh.make_mesh(
        ("data",), devices=[torch.device(CPU)])
    tl = [torch.from_numpy(m) for m in (la, lb, lpi)]
    got = mk.viterbi_time_sharded(*tl, obs, mesh)
    assert got.shape == (t,) and got.dtype == np.int32
    seq = mk._viterbi_batch(*tl, torch.from_numpy(obs)[None].long())[0]
    jseq = np.asarray(jmk._viterbi_batch(*(jnp.asarray(m) for m in
                                           (la, lb, lpi)),
                                         jnp.asarray(obs[None])))[0]
    jsharded = jmk.viterbi_time_sharded(*(jnp.asarray(m) for m in
                                          (la, lb, lpi)), obs, _jmesh())
    for other in (seq.numpy(), jseq, np.asarray(jsharded)):
        assert _score(got, obs, la, lb, lpi) == pytest.approx(
            _score(other, obs, la, lb, lpi), abs=SCORE_TOL)
        np.testing.assert_array_equal(got, other)    # tie-free seed


def test_viterbi_time_sharded_pads_and_refuses_a_ragged_split():
    rng = np.random.default_rng(3)
    model = _random_model(rng, 3, 5)
    dec = mk.ViterbiDecoder(model, device=CPU)
    obs = rng.integers(0, 5, size=64).astype(np.int32)
    obs[50:] = -1                                  # padded tail
    got = mk.viterbi_time_sharded(dec._log_a, dec._log_b, dec._log_pi, obs,
                                  _mesh())
    np.testing.assert_array_equal(got, dec.decode_codes(obs[None])[0])
    with pytest.raises(ValueError, match="not divisible"):
        mk.viterbi_time_sharded(dec._log_a, dec._log_b, dec._log_pi,
                                obs[:60], _mesh())


# ---------------------------------------------------------------------------
# the five jobs through both CLIs, and the two servables
# ---------------------------------------------------------------------------

def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


MIXED_SCHEMA = {"fields": (
    [{"name": "id", "ordinal": 0, "id": True, "dataType": "string"}]
    + [{"name": f"c{j}", "ordinal": 1 + j, "dataType": "categorical",
        "feature": True, "cardinality": [f"v{v}" for v in range(10)]}
       for j in range(4)]
    + [{"name": f"x{j}", "ordinal": 5 + j, "dataType": "double",
        "feature": True} for j in range(5)]
    + [{"name": "label", "ordinal": 10, "dataType": "categorical",
        "cardinality": ["a", "b"]}])}


def _knn_rows(rng, n, start):
    rows = np.empty((n, 11), dtype=object)
    rows[:, 0] = [f"r{start + i}" for i in range(n)]
    codes = rng.integers(0, 10, size=(n, 4))
    for j in range(4):
        rows[:, 1 + j] = [f"v{v}" for v in codes[:, j]]
    cont = rng.normal(size=(n, 5))
    for j in range(5):
        rows[:, 5 + j] = [f"{v:.6f}" for v in cont[:, j]]
    rows[:, 10] = np.where(cont[:, 0] + rng.normal(0, 1, n) > 0, "b", "a")
    return rows


def _write_rows(path, rows):
    path.write_text("".join(",".join(r) + "\n" for r in rows))


JOB_CASES = {
    "knn": ("NearestNeighbor", "test.csv", ["-Dtop.match.count=7",
                                            "-Dkernel.function=gaussian"]),
    "lr": ("LogisticRegressionJob", "hosp.csv", ["-Dlearning.rate=1.0",
                                                 "-Diteration.limit=30"]),
    "chain": ("MarkovStateTransitionModel", "chain.csv", []),
    "hmm": ("HiddenMarkovModelBuilder", "tagged.csv", []),
    "viterbi": ("ViterbiStatePredictor", "obs.csv",
                ["-Doutput.state.only=false"]),
}


@pytest.fixture(scope="module")
def job_outputs(tmp_path_factory, chain_seqs, tagged):
    work = tmp_path_factory.mktemp("model_mesh")
    rng = np.random.default_rng(61)
    write_csv(str(work / "train.csv"), _knn_rows(rng, 1201, 0))
    write_csv(str(work / "test.csv"), _knn_rows(rng, 101, 1201))
    (work / "mixed.json").write_text(json.dumps(MIXED_SCHEMA))
    write_csv(str(work / "hosp.csv"), generate_hosp_readmit(2001, seed=7))
    (work / "hosp.json").write_text(json.dumps(HOSP_SCHEMA_JSON))
    states, obs, s_names, o_names = tagged
    _write_rows(work / "chain.csv", sequences_to_rows(chain_seqs))
    _write_rows(work / "tagged.csv", hmm_seq.tagged_rows(states, obs,
                                                         s_names, o_names))
    _write_rows(work / "obs.csv", hmm_seq.code_rows(obs, o_names))
    keys = {"knn": [f"-Dfeature.schema.file.path={work / 'mixed.json'}",
                    f"-Dtraining.data.path={work / 'train.csv'}"],
            "lr": [f"-Dfeature.schema.file.path={work / 'hosp.json'}"]}
    out = {}
    for tag, main, extra in (("jax", jax_main, []),
                             ("torch", torch_main, ["--device", CPU]),
                             ("torch_off", torch_main,
                              ["--device", CPU, OFF])):
        for case, (job, inp, args) in JOB_CASES.items():
            o = work / f"{tag}_{case}"
            more = list(keys.get(case, []))
            if case == "viterbi":
                more.append(f"-Dhmm.model.file.path={work / 'jax_hmm'}")
            _run(main, [job, *more, *args, str(work / inp), str(o), *extra])
            out[tag, case] = (o / "part-00000").read_text()
    return work, out


@pytest.mark.parametrize("case", ["knn", "chain", "hmm", "viterbi"])
def test_job_part_files_under_the_mesh(job_outputs, case):
    _work, out = job_outputs
    got = out["torch", case]
    assert got
    assert got == out["jax", case]
    assert got == out["torch_off", case]


def _history(text):
    return [np.array([float(v) for v in ln.split(",")])
            for ln in text.splitlines() if ln and not ln.startswith("status")]


def test_lr_job_history_under_the_mesh(job_outputs):
    _work, out = job_outputs
    got = out["torch", "lr"]
    assert got.splitlines()[-1] == out["jax", "lr"].splitlines()[-1]
    assert got.splitlines()[-1] == out["torch_off", "lr"].splitlines()[-1]
    for other in ("jax", "torch_off"):
        _close_histories(_history(got), _history(out[other, "lr"]))


def test_servables_under_the_mesh_equal_the_batch_jobs(job_outputs):
    work, out = job_outputs
    props = {"feature.schema.file.path": str(work / "mixed.json"),
             "training.data.path": str(work / "train.csv"),
             "top.match.count": "7", "kernel.function": "gaussian",
             "hmm.model.file.path": str(work / "jax_hmm"),
             "output.state.only": "false", "serve.models": "knn,viterbi"}
    registry = ModelRegistry.from_conf(JobConfig(props), device=CPU)
    knn, vit = registry.get("knn"), registry.get("viterbi")
    assert knn.est.mesh is not None and knn.est.mesh.sizes == {"data": 8}
    assert vit.predictor.decoder.mesh.sizes == {"data": 8}
    lines = read_lines(str(work / "test.csv"))
    assert knn.score_lines(lines, len(lines)) == \
        out["torch", "knn"].splitlines()
    assert knn.score_lines(lines[:5], 8) == \
        out["torch", "knn"].splitlines()[:5]
    obs = read_lines(str(work / "obs.csv"))
    assert vit.score_lines(obs, 512) == out["torch", "viterbi"].splitlines()
    off = ModelRegistry.from_conf(
        JobConfig({**props, "data.parallel.auto": "false"}), device=CPU)
    assert off.get("knn").est.mesh is None
    assert off.get("viterbi").score_lines(obs, 512) == \
        out["torch", "viterbi"].splitlines()


@pytest.mark.parametrize("make", ["chain", "hmm", "decoder", "predictor"])
def test_markov_constructors_keep_the_mesh(make):
    mesh = _mesh()
    model = mk.HMMModel(["x"], ["o"], np.ones((1, 1)), np.ones((1, 1)),
                        np.ones(1))
    built = {"chain": lambda: mk.MarkovChain(mesh=mesh, device=CPU),
             "hmm": lambda: mk.HMMBuilder(mesh=mesh, device=CPU),
             "decoder": lambda: mk.ViterbiDecoder(model, mesh=mesh,
                                                  device=CPU),
             "predictor": lambda: mk.ViterbiStatePredictor(
                 model, mesh=mesh, device=CPU).decoder}[make]()
    assert built.mesh is mesh


def test_knn_and_lr_carry_the_mesh_and_none_by_default():
    mesh = _mesh()
    assert mknn.KNN(mesh=mesh, device=CPU).mesh is mesh
    assert mknn.KNN(device=CPU).mesh is None
    assert mlr.LogisticRegression(mesh=mesh, device=CPU).mesh is mesh
    assert mlr.LogisticRegression(device=CPU).mesh is None
