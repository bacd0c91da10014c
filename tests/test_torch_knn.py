"""The port's kNN slice held against ``avenir_tpu`` on the CPU.

The JAX package's Pallas kernels run in Mosaic interpret mode
(``pltpu.force_tpu_interpret_mode``), as ``tests/test_pallas_knn.py`` runs
them; the port runs its kernels' plain versions, which is what a wrapper
does with CPU tensors.  Sizes stay small: three cases at ~70K references
(the tournament route needs more than 16,384), the rest at 3,000 or fewer.

Tolerances and why:
- packed operands: bit for bit (the certificate's D2_EPS assumes them);
- B6 candidates: the same set per row, d² within 1e-5 (float32 sums in
  another order than the TPU interpreter's);
- B5 keys: equal when every d² is an exact integer sum (categorical only),
  else equal or one truncation step (2048 in the int view) apart, where a
  summation order moves a d² across a step;
- distances after the exact re-rank: within 2e-5 of the JAX package's
  (its float32 re-rank sums in another order than the port's float64);
- the exact scan: within 1e-6;
- model scores within 1e-6 and predictions byte-identical.
"""

import contextlib
import functools
import io
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from avenir_tpu.__main__ import main as jax_main  # noqa: E402
from avenir_tpu.core.encoding import EncodedDataset as JEncodedDataset  # noqa: E402
from avenir_tpu.datagen import elearn as jelearn  # noqa: E402
from avenir_tpu.models import knn as jknn  # noqa: E402
from avenir_tpu.ops import pallas_knn as pk  # noqa: E402
from avenir_tpu_torch import convert  # noqa: E402
from avenir_tpu_torch.__main__ import main as torch_main  # noqa: E402
from avenir_tpu_torch.core.csv_io import write_csv  # noqa: E402
from avenir_tpu_torch.core.encoding import DatasetEncoder, EncodedDataset  # noqa: E402
from avenir_tpu_torch.core.schema import FeatureSchema  # noqa: E402
from avenir_tpu_torch.datagen import elearn  # noqa: E402
from avenir_tpu_torch.jobs.base import read_input  # noqa: E402
from avenir_tpu_torch.models import knn as mknn  # noqa: E402
from avenir_tpu_torch.ops import agg  # noqa: E402
from avenir_tpu_torch.ops import knn as tk  # noqa: E402

CPU = torch.device("cpu")
STEP = 2048                     # one truncation step of a B5 key, int view


def _u16(x):
    """bf16 bits of a JAX array or a torch tensor as uint16."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def _data(rng, n, m, f, fc, nb):
    codes_r = rng.integers(0, nb, size=(n, f)).astype(np.int32)
    cont_r = rng.random(size=(n, fc)).astype(np.float32)
    codes_q = rng.integers(0, nb, size=(m, f)).astype(np.int32)
    cont_q = rng.random(size=(m, fc)).astype(np.float32)
    return codes_r, cont_r, codes_q, cont_q


def _oracle(codes_q, cont_q, codes_r, cont_r, k):
    """Exact d² in float64, ordered by (d², index) with a stable sort."""
    mism = (codes_q[:, None, :] != codes_r[None, :, :]).sum(-1).astype(np.float64)
    d2 = mism + ((cont_q[:, None, :].astype(np.float64)
                  - cont_r[None, :, :]) ** 2).sum(-1)
    idx = np.argsort(d2, axis=1, kind="stable")[:, :k]
    f = codes_q.shape[1] + cont_q.shape[1]
    return np.sqrt(np.take_along_axis(d2, idx, axis=1) / f), idx


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _port_search(codes_r, cont_r, codes_q, cont_q, nb, k):
    r_mat, n = tk.prepare_refs(codes_r, cont_r, nb)
    d, i, c = tk.search(_t(codes_q), _t(cont_q), r_mat, _t(codes_r),
                        _t(cont_r), n, nb, k, codes_q.shape[1] + cont_q.shape[1])
    return d.numpy(), i.numpy(), c.numpy()


def _jax_search(codes_r, cont_r, codes_q, cont_q, nb, k):
    with pltpu.force_tpu_interpret_mode():
        r_mat, n = pk.prepare_refs(codes_r, cont_r, nb)
        d, i, c = pk.search_fused(codes_q, cont_q, r_mat, jnp.asarray(codes_r),
                                  jnp.asarray(cont_r), n, nb, k,
                                  codes_q.shape[1] + cont_q.shape[1])
    return np.asarray(d), np.asarray(i), np.asarray(c)


def _jax_tourney_keys(q_mat, r_mat):
    """k1, k2, k3 of the JAX tournament kernel, pad lanes pinned, as
    ``_topk_tourney_traced`` computes them before its assembly."""
    m, n = q_mat.shape[0], r_mat.shape[0]
    nseg = n // pk.SEG
    nbp = pk._round_up(nseg, 128)
    spec = pl.BlockSpec((pk.TM, nbp), lambda i, j: (i, 0),
                        memory_space=pltpu.VMEM)
    with pltpu.force_tpu_interpret_mode():
        keys = pl.pallas_call(
            functools.partial(pk._knn_tourney_kernel, nbp=nbp),
            grid=(m // pk.TM, n // pk.TB),
            in_specs=[pl.BlockSpec((pk.TM, q_mat.shape[1]), lambda i, j: (i, 0),
                                   memory_space=pltpu.VMEM),
                      pl.BlockSpec((pk.TB, r_mat.shape[1]), lambda i, j: (j, 0),
                                   memory_space=pltpu.VMEM)],
            out_specs=[spec] * 3,
            out_shape=[jax.ShapeDtypeStruct((m, nbp), jnp.int32)] * 3,
        )(q_mat, r_mat)
    pad = np.arange(nbp) >= nseg
    return [np.where(pad[None, :], pk._PAD_KEY, np.asarray(k)) for k in keys]


# ---------------------------------------------------------------------------
# packing, one_hot, data generator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("f,fc", [(6, 8), (4, 0), (0, 5)])
def test_packing_bit_equal(f, fc):
    rng = np.random.default_rng(f * 10 + fc)
    nb = 10
    codes_r, cont_r, codes_q, cont_q = _data(rng, 3000, 40, f, fc, nb)
    if f:
        codes_q[0, 0] = -1                      # out of range: zero one-hot row
    jr, jn = pk.prepare_refs(codes_r, cont_r, nb)
    tr, tn = tk.prepare_refs(codes_r, cont_r, nb)
    assert jn == tn and tr.dtype == torch.bfloat16
    np.testing.assert_array_equal(_u16(tr), _u16(jr))
    jq, jm = pk.prepare_queries(codes_q, cont_q, nb)
    tq, tm = tk.prepare_queries(codes_q, cont_q, nb)
    assert jm == tm
    np.testing.assert_array_equal(_u16(tq), _u16(jq))
    jd = pk._pack_queries_dev(jnp.asarray(codes_q), jnp.asarray(cont_q), nb,
                              512, float(f))
    td = tk._pack_queries_dev(_t(codes_q), _t(cont_q), nb, 512, float(f))
    np.testing.assert_array_equal(_u16(td), _u16(jd))


# the kNN paths' schemas and the chip's cases: elearn (9 continuous, w 60),
# knn_qps (6 × 10 + 8, w 114), categorical 5 × 10 (w 56) and 6 × 10 (w 66),
# the streamed 80 × 10 (w 806), and a mixed 4 × 6 + 3 (w 48)
CUT_SCHEMAS = [(0, 9, 10), (6, 8, 10), (5, 0, 10), (6, 0, 10), (80, 0, 10),
               (4, 3, 6)]


@pytest.mark.parametrize("f,fc,nb", CUT_SCHEMAS)
def test_packed_columns_past_the_contraction_width_are_zero(f, fc, nb):
    """The premise of the kernels' contraction cut: the JAX package's packed
    operands (references, host queries, device queries) are zero in every
    column ≥ round_up(used lanes, 64), so contracting only the columns
    before it adds exact zeros to every d²."""
    rng = np.random.default_rng(f + 7 * fc)
    codes_r, cont_r, codes_q, cont_q = _data(rng, 2500, 40, f, fc, nb)
    used = f * nb + 6 * fc + 6
    wc = -(-used // 64) * 64
    mats = [pk.prepare_refs(codes_r, cont_r, nb)[0],
            pk.prepare_queries(codes_q, cont_q, nb)[0],
            pk._pack_queries_dev(jnp.asarray(codes_q), jnp.asarray(cont_q), nb,
                                 512, float(f))]
    for mat in mats:
        arr = np.asarray(jnp.asarray(mat).astype(jnp.float32))
        assert arr.shape[1] == pk._width(f, nb, fc) >= wc
        assert not arr[:, wc:].any()
        assert arr[:, :used].any(0)[used - 6:].any()   # the norm columns are used


@pytest.mark.parametrize("f,fc,nb", CUT_SCHEMAS)
def test_contraction_width_from_the_width_terms(f, fc, nb):
    """The wrappers' contracted width: _width's terms before its padding,
    rounded up to a 64-column chunk, never past W."""
    w = tk._width(f, nb, fc)
    assert w == pk._width(f, nb, fc)
    used = tk.used_lanes(f, nb, fc)
    assert used == f * nb + 6 * fc + 6 and w == tk._round_up(used, 128)
    wc = tk.contraction_width(w, used)
    assert wc == tk._round_up(used, 64) and used <= wc <= w and wc % 64 == 0
    assert tk.contraction_width(w, None) == w
    # the elearn path contracts half of its operand
    assert tk.contraction_width(128, tk.used_lanes(0, 10, 9)) == 64


def test_cut_operands_give_the_same_keys_and_lists():
    """Categorical d² are exact integer sums: the plain versions on the
    operands cut to the contracted width give exactly the keys and lists of
    the whole width."""
    rng = np.random.default_rng(3)
    f, nb = 5, 10
    codes_r, cont_r, codes_q, cont_q = _data(rng, 20_000, 16, f, 0, nb)
    r, _ = tk.prepare_refs(codes_r, cont_r, nb)
    q, _ = tk.prepare_queries(codes_q, cont_q, nb)
    wc = tk.contraction_width(q.shape[1], tk.used_lanes(f, nb, 0))
    assert wc == 64 < q.shape[1]
    qc, rc = q[:, :wc].contiguous(), r[:, :wc].contiguous()
    for g, w in zip(tk.knn_tourney_ref(qc, rc), tk.knn_tourney_ref(q, r)):
        assert torch.equal(g, w)
    for g, w in zip(tk.knn_topk_ref(qc, rc[:4096], 18),
                    tk.knn_topk_ref(q, r[:4096], 18)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("n", [3000, 20_000])
def test_search_hands_the_kernels_the_used_lanes(n, monkeypatch):
    """search passes each kernel wrapper the schema's used lanes (B6 below
    the tournament's gate, B5 above it)."""
    rng = np.random.default_rng(n)
    f, fc, nb = 3, 4, 5
    data = _data(rng, n, 20, f, fc, nb)
    seen = []
    for name in ("knn_tourney", "knn_topk"):
        inner = getattr(tk, name)

        def spy(*args, inner=inner, name=name, **kwargs):
            seen.append((name, kwargs.get("used")))
            return inner(*args, **kwargs)
        monkeypatch.setattr(tk, name, spy)
    _port_search(*data, nb, 5)
    want = "knn_tourney" if n > tk.TB else "knn_topk"
    assert seen == [(want, tk.used_lanes(f, nb, fc))]


def test_one_hot_matches_jax():
    x = np.array([[0, 3, -1], [4, 5, 2]], np.int32)
    got = agg.one_hot(_t(x), 5).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.nn.one_hot(x, 5)))
    assert got[0, 2].sum() == 0 and got[1, 1].sum() == 0


def test_elearn_generator_matches_jax():
    np.testing.assert_array_equal(elearn.generate_elearn(500, seed=3),
                                  jelearn.generate_elearn(500, seed=3))
    assert elearn.ELEARN_SCHEMA_JSON == jelearn.ELEARN_SCHEMA_JSON


# ---------------------------------------------------------------------------
# the plain kernels against the JAX kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("f,fc,kk", [(6, 8, 13), (0, 5, 18)])
def test_topk_plain_matches_jax_kernel(f, fc, kk):
    rng = np.random.default_rng(7 + fc)
    nb = 7
    codes_r, cont_r, codes_q, cont_q = _data(rng, 3000, 40, f, fc, nb)
    with pltpu.force_tpu_interpret_mode():
        jr, _ = pk.prepare_refs(codes_r, cont_r, nb)
        jq, _ = pk.prepare_queries(codes_q, cont_q, nb)
        jd, ji = pk._topk_pallas(jq, jr, kk)
    jd, ji = np.asarray(jd), np.asarray(ji)
    tr, _ = tk.prepare_refs(codes_r, cont_r, nb)
    tq, _ = tk.prepare_queries(codes_q, cont_q, nb)
    d, i = tk.knn_topk(tq, tr, kk)                 # CPU tensors: plain version
    assert d.shape == (tq.shape[0], tk.SLOTS) and i.dtype == torch.int32
    # rows past the 40 queries are zero pads, every d² 0: compare the real
    d, i = d.numpy()[:40], i.numpy()[:40]
    jd, ji = jd[:40], ji[:40]
    assert (i[:, kk:] == -1).all() and (d[:, kk:] == tk._BIG).all()
    for r in range(jd.shape[0]):
        assert set(ji[r].tolist()) == set(i[r, :kk].tolist()), r
    np.testing.assert_allclose(d[:, :kk], np.sort(jd, axis=1), atol=1e-5)
    # ascending by (d², index)
    assert (np.diff(d[:, :kk], axis=1) >= 0).all()


def _split_lists(q, r, kk, s, per):
    """Per-range plain lists [S, M, kk] of B6's reference split: the plain
    version on each range of ``per`` 128-row tiles, indices made global."""
    parts = []
    for k in range(s):
        lo = k * per * 128
        d, i = tk.knn_topk_ref(q, r[lo:lo + per * 128], kk)
        parts.append((d[:, :kk], torch.where(i[:, :kk] >= 0, i[:, :kk] + lo,
                                             i[:, :kk])))
    return (torch.stack([d for d, _ in parts]),
            torch.stack([i for _, i in parts]))


@pytest.mark.parametrize("m,n,kk,rows,slots,splits", [
    (2048, 10_240, 18, 32, 132, None),   # the 10K path: 80 tiles, 3 ranges
    (2048, 10_240, 18, 64, 132, None),
    (4096, 16_384, 18, 64, 264, None),   # streamed W 2688: 4 ranges, 1 wave
    (4096, 16_384, 18, 32, 264, None),
    (4096, 16_384, 128, 32, 264, None),  # kk 128: ranges of 16,384 refs
    (512, 2048, 1, 32, 396, None),       # more ranges wanted than tiles
    (2048, 10_240, 18, 32, 264, 1),      # forced: one range, no merge
    (512, 4096, 18, 32, 264, 5),         # 32 tiles in ranges of 7
    (4096, 1 << 20, 18, 32, 264, None),
    (512, 8192, 18, 32, 264, 100),       # capped at 32 ranges
    (65_536, 16_384, 18, 32, 264, None),  # the query blocks fill the card
    (2048, 10_240, 18, 32, 0, None),     # occupancy unknown: one range
])
def test_topk_splits_cover_the_tiles(m, n, kk, rows, slots, splits):
    s, per = tk.topk_splits(m, n, kk, rows, slots, splits)
    tiles = n // 128
    assert 1 <= s <= min(tk.TOPK_MAX_SPLITS, tiles)
    assert (s - 1) * per < tiles <= s * per        # every range non-empty
    qblocks = m // rows
    cap = n // (tk.TOPK_REFS_PER_SLOT * kk)
    if splits is None:             # fill the card; ranges of 128·kk refs
        fill = -(-slots // qblocks) if rows == 32 else slots // qblocks
        assert s == 1 or s <= cap
        assert s == max(1, min(fill, cap, 32, tiles))
        if rows == 64:             # streamed: one wave at most
            assert s == 1 or qblocks * s <= slots
    elif splits == 1:
        assert (s, per) == (1, tiles)


@pytest.mark.parametrize("f,fc,kk,splits", [
    (6, 8, 13, 5),                 # mixed; 32 tiles in ranges of 7, 4 last
    (4, 0, 13, None),              # categorical, ties everywhere
    (4, 0, 1, 3),
    (4, 0, 128, 5),
    (0, 5, 128, None),
])
def test_topk_split_merge_matches_whole_and_jax(f, fc, kk, splits):
    """B6's reference split on the CPU: the plain version on each range of
    topk_splits, merged by knn_topk_merge_ref, equals the plain version on
    the whole set — the lower index of a tie kept — and the JAX kernel as
    the B6 parity tests compare it."""
    rng = np.random.default_rng(11 + kk + fc)
    nb = 7
    codes_r, cont_r, codes_q, cont_q = _data(rng, 3000, 40, f, fc, nb)
    r, _ = tk.prepare_refs(codes_r, cont_r, nb)      # 4096 rows: 32 tiles
    q, _ = tk.prepare_queries(codes_q, cont_q, nb)
    s, per = tk.topk_splits(q.shape[0], r.shape[0], 1, 32, 264, splits)
    assert s > 1 and (splits != 5 or s * per > r.shape[0] // 128)  # short last
    d, i = tk.knn_topk_merge_ref(*_split_lists(q, r, kk, s, per), kk)
    wd, wi = tk.knn_topk_ref(q, r, kk)
    assert d.shape == (q.shape[0], tk.SLOTS) and i.dtype == torch.int32
    assert (i[:, kk:] == -1).all() and (d[:, kk:] == tk._BIG).all()
    if fc == 0:                    # integer d²: the same bits and order
        assert torch.equal(d, wd) and torch.equal(i, wi)
    else:
        np.testing.assert_allclose(d[:, :kk].numpy(), wd[:, :kk].numpy(),
                                   atol=1e-5)
    d, i = d.numpy()[:40, :kk], i.numpy()[:40, :kk]
    if fc == 0:                    # the stable order of exact d²
        _od, oi = _oracle(codes_q, cont_q, codes_r, cont_r, kk)
        np.testing.assert_array_equal(i, oi)
    with pltpu.force_tpu_interpret_mode():
        jr, _ = pk.prepare_refs(codes_r, cont_r, nb)
        jq, _ = pk.prepare_queries(codes_q, cont_q, nb)
        jd, ji = pk._topk_pallas(jq, jr, kk)
    jd, ji = np.asarray(jd)[:40], np.asarray(ji)[:40]
    np.testing.assert_allclose(d, np.sort(jd, axis=1), atol=1e-5)
    if fc:
        for row in range(40):
            assert set(ji[row].tolist()) == set(i[row].tolist()), row
    else:                          # the JAX kernel keeps later tie members
        for row in range(40):
            w = d[row, -1]
            assert set(i[row][d[row] < w]) == set(ji[row][jd[row] < w])


def test_host_candidates_and_rerank_match_jax():
    """The host-side pair ``topk_candidates`` + ``exact_rerank``, copied
    as they are: the same candidates, distances and certificate."""
    rng = np.random.default_rng(9)
    f, fc, nb, k = 5, 4, 7, 6
    codes_r, cont_r, codes_q, cont_q = _data(rng, 2500, 30, f, fc, nb)
    with pltpu.force_tpu_interpret_mode():
        jr, _ = pk.prepare_refs(codes_r, cont_r, nb)
        jq, m = pk.prepare_queries(codes_q, cont_q, nb)
        jd2, ji = pk.topk_candidates(jq, jr, k)
    tr, _ = tk.prepare_refs(codes_r, cont_r, nb)
    tq, _ = tk.prepare_queries(codes_q, cont_q, nb)
    d2, idx = tk.topk_candidates(tq, tr, k)
    np.testing.assert_allclose(d2[:m], jd2[:m], atol=1e-5)
    got = tk.exact_rerank(idx[:m], d2[:m], codes_q, cont_q, codes_r, cont_r,
                          k, f + fc)
    want = pk.exact_rerank(ji[:m], jd2[:m], codes_q, cont_q, codes_r, cont_r,
                           k, f + fc)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[2].all()


@pytest.fixture(scope="module")
def tourney_mixed():
    """70K references, mixed data: the tournament route at the JAX
    package's test size, run once for the key, assembly and search tests."""
    rng = np.random.default_rng(11)
    f, fc, nb, k = 5, 6, 8, 5
    codes_r, cont_r, codes_q, cont_q = _data(rng, 70_000, 24, f, fc, nb)
    jr, n = pk.prepare_refs(codes_r, cont_r, nb)
    jq, _ = pk.prepare_queries(codes_q, cont_q, nb)
    keys = _jax_tourney_keys(jq, jr)
    with pltpu.force_tpu_interpret_mode():
        assembled = jax.jit(pk._topk_tourney_traced, static_argnums=2)(
            jq, jr, k + pk.MARGIN)
    jsearch = _jax_search(codes_r, cont_r, codes_q, cont_q, nb, k)
    return dict(data=(codes_r, cont_r, codes_q, cont_q), nb=nb, k=k, n=n,
                keys=keys, assembled=[np.asarray(x) for x in assembled],
                jsearch=jsearch)


def _step_apart(got, want):
    """Keys equal, or one truncation step apart with equal column bits."""
    diff = got.astype(np.int64) - want.astype(np.int64)
    return np.isin(diff, (-STEP, 0, STEP)).all() and \
        ((got & (tk.SEG - 1)) == (want & (tk.SEG - 1)))[diff != 0].all()


def test_tourney_plain_keys_match_jax_kernel_mixed(tourney_mixed):
    codes_r, cont_r, codes_q, cont_q = tourney_mixed["data"]
    tr, _ = tk.prepare_refs(codes_r, cont_r, tourney_mixed["nb"])
    tq, _ = tk.prepare_queries(codes_q, cont_q, tourney_mixed["nb"])
    got = [x.numpy() for x in tk.knn_tourney(tq, tr)]
    for g, w in zip(got, tourney_mixed["keys"]):
        assert g.shape == w.shape and g.dtype == np.int32
        assert _step_apart(g, w)
        assert (g == w).mean() > 0.99
    # the assembly: the kk best (truncated d²) and the bound, likewise
    m = len(tourney_mixed["data"][2])     # the rest are zero pad queries
    cd, ci, b3, _d3, _i3 = tk._assemble_tourney(
        *[torch.from_numpy(x[:m]) for x in got], tourney_mixed["k"] + tk.MARGIN)
    jd, ji, jb3 = [x[:m] for x in tourney_mixed["assembled"]]
    step = np.abs(cd.numpy().view(np.int32).astype(np.int64)
                  - jd.view(np.int32).astype(np.int64))
    assert np.isin(step, (0, STEP)).all()
    bstep = np.abs(b3.numpy().view(np.int32).astype(np.int64)
                   - jb3.view(np.int32).astype(np.int64))
    assert np.isin(bstep, (0, STEP)).all()
    same = (step == 0).all(axis=1)
    for r in np.flatnonzero(same):
        assert set(ci[r].tolist()) == set(ji[r].tolist())


def test_tourney_plain_keys_match_jax_kernel_categorical():
    rng = np.random.default_rng(12)
    nb = 10
    codes_r, cont_r, codes_q, cont_q = _data(rng, 20_000, 16, 6, 0, nb)
    jr, _ = pk.prepare_refs(codes_r, cont_r, nb)
    jq, _ = pk.prepare_queries(codes_q, cont_q, nb)
    want = _jax_tourney_keys(jq, jr)
    tr, _ = tk.prepare_refs(codes_r, cont_r, nb)
    tq, _ = tk.prepare_queries(codes_q, cont_q, nb)
    for g, w in zip(tk.knn_tourney(tq, tr), want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_keys_map_negative_zero_to_zero():
    d2 = torch.tensor([[-0.0, 0.0, -1e-7, 2.5]])
    keys = tk._keys(d2, 5).numpy()
    np.testing.assert_array_equal(keys[0] & (tk.SEG - 1), [5, 6, 7, 8])
    assert (keys[0, :3] == [5, 6, 7]).all()      # all three at d² = +0
    assert keys[0, 3] == (np.float32(2.5).view(np.int32) & ~2047) | 8


# ---------------------------------------------------------------------------
# search against search_fused
# ---------------------------------------------------------------------------

def _same_search(port, jaxr, tie_free=True):
    d, i, c = port
    jd, ji, jc = jaxr
    np.testing.assert_allclose(d, jd, atol=2e-5)
    if tie_free:
        np.testing.assert_array_equal(c, jc)
        np.testing.assert_array_equal(i[c], ji[c])


def test_search_merge_route_matches_jax():
    rng = np.random.default_rng(21)
    f, fc, nb, k = 6, 8, 7, 5
    data = _data(rng, 3000, 40, f, fc, nb)
    assert not tk.use_tourney(3000, tk.prepare_refs(*data[:2], nb)[0].shape[0],
                              k + tk.MARGIN)
    port = _port_search(*data, nb, k)
    _same_search(port, _jax_search(*data, nb, k))
    assert port[2].all()
    od, oi = _oracle(data[2], data[3], data[0], data[1], k)
    np.testing.assert_allclose(port[0], od, atol=2e-5)
    np.testing.assert_array_equal(port[1], oi)


def test_search_tourney_route_matches_jax(tourney_mixed):
    codes_r, cont_r, codes_q, cont_q = tourney_mixed["data"]
    nb, k = tourney_mixed["nb"], tourney_mixed["k"]
    r_mat, n = tk.prepare_refs(codes_r, cont_r, nb)
    assert tk.use_tourney(n, r_mat.shape[0], k + tk.MARGIN)
    port = _port_search(codes_r, cont_r, codes_q, cont_q, nb, k)
    _same_search(port, tourney_mixed["jsearch"])
    assert port[2].mean() > 0.9
    od, oi = _oracle(codes_q, cont_q, codes_r, cont_r, k)
    ok = port[2]
    np.testing.assert_allclose(port[0][ok], od[ok], atol=2e-5)
    np.testing.assert_array_equal(port[1][ok], oi[ok])


def test_search_wide_operand_matches_jax():
    """80 categorical features × 10 bins + 2 continuous: W = 896, wider
    than the kernels keep resident in shared memory (they stream the
    query tile instead); the search takes the kernel route all the same."""
    rng = np.random.default_rng(24)
    f, fc, nb, k = 80, 2, 10, 5
    data = _data(rng, 600, 24, f, fc, nb)
    assert tk.prepare_refs(*data[:2], nb)[0].shape[1] == 896
    port = _port_search(*data, nb, k)
    _same_search(port, _jax_search(*data, nb, k))
    assert port[2].all()
    od, oi = _oracle(data[2], data[3], data[0], data[1], k)
    np.testing.assert_allclose(port[0], od, atol=2e-5)
    np.testing.assert_array_equal(port[1], oi)


def test_search_tiny_reference_set_matches_jax():
    rng = np.random.default_rng(22)
    f, fc, nb, k = 3, 2, 5, 10
    data = _data(rng, 12, 8, f, fc, nb)
    port = _port_search(*data, nb, k)
    _same_search(port, _jax_search(*data, nb, k))
    assert port[2].all() and (port[1] < 12).all()


def test_search_short_last_block_matches_jax():
    rng = np.random.default_rng(23)
    f, fc, nb, k = 4, 3, 6, 10
    n = 8 * tk.TN + 1
    data = _data(rng, n, 16, f, fc, nb)
    r_mat, _ = tk.prepare_refs(*data[:2], nb)
    assert tk.use_tourney(n, r_mat.shape[0], k + tk.MARGIN)
    port = _port_search(*data, nb, k)
    _same_search(port, _jax_search(*data, nb, k))
    assert (~port[2]).any()                  # a pad in the pool certifies nothing
    od, _ = _oracle(data[2], data[3], data[0], data[1], k)
    np.testing.assert_allclose(port[0][port[2]], od[port[2]], atol=2e-5)


def test_search_heavy_duplicates_matches_jax():
    rng = np.random.default_rng(24)
    f, fc, nb, k = 4, 2, 5, 5
    base = rng.integers(0, nb, size=(500, f)).astype(np.int32)
    codes_r = np.tile(base, (140, 1))
    cont_r = np.tile(rng.random(size=(500, fc)).astype(np.float32), (140, 1))
    codes_q = rng.integers(0, nb, size=(16, f)).astype(np.int32)
    cont_q = rng.random(size=(16, fc)).astype(np.float32)
    data = (codes_r, cont_r, codes_q, cont_q)
    port = _port_search(*data, nb, k)
    jd, ji, jc = _jax_search(*data, nb, k)
    np.testing.assert_allclose(port[0], jd, atol=2e-5)
    assert (~port[2]).any()                  # duplicates tie the k-th
    od, oi = _oracle(codes_q, cont_q, codes_r, cont_r, k)
    c = port[2]
    np.testing.assert_allclose(port[0][c], od[c], atol=2e-5)
    # the tie rule: certified rows keep the lowest indices of a tie
    np.testing.assert_array_equal(port[1][c], oi[c])


# ---------------------------------------------------------------------------
# the tie rule, and the reference artifact it exposes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [3000, 20_000])
def test_tie_rule_on_categorical_data(n):
    """Categorical only: every d² is an integer and ties abound.  The port
    equals a stable argsort of exact d² by (d², index) on both routes, the
    rows its certificate refuses included (served by the exact scan)."""
    rng = np.random.default_rng(31)
    f, nb, k = 6, 10, 5
    codes_r = rng.integers(0, nb, size=(n, f)).astype(np.int32)
    codes_q = rng.integers(0, nb, size=(24, f)).astype(np.int32)
    cont = np.zeros((n, 0), np.float32)
    ds = lambda c, x: EncodedDataset(  # noqa: E731
        codes=c, cont=x, labels=np.zeros(len(c), np.int32),
        n_bins=np.full(f, nb, np.int32), class_values=["a"])
    model = mknn.fit_knn(ds(codes_r, cont))
    r_mat, _ = model.device_packed(CPU)
    assert tk.use_tourney(n, r_mat.shape[0], k + tk.MARGIN) == (n > tk.TB)
    before = mknn._nearest_neighbors_kernel.fallback_rows
    d, i = mknn.nearest_neighbors(model, ds(codes_q, np.zeros((24, 0),
                                                              np.float32)),
                                  k, device="cpu")
    od, oi = _oracle(codes_q, np.zeros((24, 0)), codes_r, cont, k)
    np.testing.assert_array_equal(i, oi)
    np.testing.assert_allclose(d, od, atol=1e-7)
    if n > tk.TB:      # the stricter certificate sends some rows to the scan
        assert mknn._nearest_neighbors_kernel.fallback_rows > before


def test_pin_jax_merge_kernel_keeps_later_tie_members():
    """Reference artifact (ROADMAP Queue 3): the JAX package's B6 evicts the
    lowest slot among the worst, and its slots fill in index order, so of a
    tie at the worst kept d² it keeps the LATER references; the port keeps
    the lowest, as a stable sort and the JAX package's own CPU scan do.  On
    this seed (categorical only, integer d²) both keep equally distant
    candidate sets, and in most rows different references."""
    rng = np.random.default_rng(5)
    f, nb, kk = 4, 10, 13
    codes_r, cont_r, codes_q, cont_q = _data(rng, 3000, 24, f, 0, nb)
    with pltpu.force_tpu_interpret_mode():
        jr, _ = pk.prepare_refs(codes_r, cont_r, nb)
        jq, _ = pk.prepare_queries(codes_q, cont_q, nb)
        jd, ji = pk._topk_pallas(jq, jr, kk)
    jd, ji = np.asarray(jd)[:24], np.asarray(ji)[:24]
    tr, _ = tk.prepare_refs(codes_r, cont_r, nb)
    tq, _ = tk.prepare_queries(codes_q, cont_q, nb)
    d, i = tk.knn_topk(tq, tr, kk)
    d, i = d.numpy()[:24, :kk], i.numpy()[:24, :kk]
    _od, oi = _oracle(codes_q, cont_q, codes_r, cont_r, kk)
    np.testing.assert_array_equal(i, oi)                  # stable top-kk
    np.testing.assert_array_equal(d, np.sort(jd, axis=1))  # equally distant
    differ = np.array([set(a) != set(b) for a, b in zip(i.tolist(),
                                                        ji.tolist())])
    assert differ.mean() > 0.5                            # other references
    for r in np.flatnonzero(differ):
        # the two sets differ only in the tie at the worst kept d², where
        # the JAX kernel's members come later, one for one
        w = d[r, -1]
        mine = np.sort(i[r][d[r] == w])
        theirs = np.sort(ji[r][jd[r] == w])
        assert len(mine) == len(theirs) and (theirs >= mine).all()
        assert set(i[r][d[r] < w]) == set(ji[r][jd[r] < w])
    # after the exact re-rank both searches certify every row and agree on
    # every distance
    port = _port_search(codes_r, cont_r, codes_q, cont_q, nb, 5)
    jsearch = _jax_search(codes_r, cont_r, codes_q, cont_q, nb, 5)
    assert port[2].all() and jsearch[2].all()
    np.testing.assert_array_equal(port[0], jsearch[0])


# ---------------------------------------------------------------------------
# the exact scan
# ---------------------------------------------------------------------------

def _mixed_ds(cls, rng, n, f=6, fc=8, nb=10):
    """knn_qps.make_ds's shape: categorical codes plus float continuous."""
    return cls(
        codes=rng.integers(0, nb, size=(n, f)).astype(np.int32),
        cont=rng.normal(size=(n, fc)).astype(np.float32),
        labels=rng.integers(0, 2, size=n).astype(np.int32),
        ids=None, n_bins=np.full(f, nb, np.int32), class_values=["a", "b"],
        binned_ordinals=list(range(f)), cont_ordinals=list(range(f, f + fc)))


def _twin(ds):
    """The same dataset as the other package's EncodedDataset."""
    return JEncodedDataset(
        codes=ds.codes, cont=ds.cont, labels=ds.labels, ids=ds.ids,
        n_bins=ds.n_bins, class_values=list(ds.class_values),
        binned_ordinals=list(ds.binned_ordinals),
        cont_ordinals=list(ds.cont_ordinals))


@pytest.mark.parametrize("metric", ["euclidean", "manhattan"])
def test_scan_matches_jax_scan(metric):
    train = _mixed_ds(EncodedDataset, np.random.default_rng(41), 2500)
    test = _mixed_ds(EncodedDataset, np.random.default_rng(42), 60)
    model = mknn.fit_knn(train)
    d, i = mknn._nearest_neighbors_scan(model, test, 7, metric, 700, 25, CPU)
    jd, ji = jknn._nearest_neighbors_xla(jknn.fit_knn(_twin(train)),
                                         _twin(test), 7, metric, 700, 25)
    np.testing.assert_allclose(d, np.asarray(jd), atol=1e-6)
    np.testing.assert_array_equal(i, np.asarray(ji))


def test_scan_keeps_lowest_index_of_a_tie():
    codes = np.array([[1], [0], [1], [0], [1]], np.int32)
    ds = EncodedDataset(codes=codes, cont=np.zeros((5, 0), np.float32),
                        labels=np.zeros(5, np.int32),
                        n_bins=np.array([2], np.int32), class_values=["a"])
    model = mknn.fit_knn(ds)
    q = ds.slice(0, 1)
    d, i = mknn._nearest_neighbors_scan(model, q, 4, "manhattan", 2, 8, CPU)
    np.testing.assert_array_equal(i, [[0, 2, 4, 1]])
    np.testing.assert_array_equal(d, [[0, 0, 0, 1]])


# ---------------------------------------------------------------------------
# the model against the JAX package's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mixed():
    rng = np.random.default_rng(51)
    train = _mixed_ds(EncodedDataset, rng, 3000)
    test = _mixed_ds(EncodedDataset, rng, 200)
    probs = rng.dirichlet([1.0, 1.0], size=3000).astype(np.float32)
    return train, test, probs


PREDICT_CASES = [
    dict(),
    dict(kernel="linearMultiplicative"),
    dict(kernel="linearAdditive", inverse_distance=True),
    dict(kernel="gaussian", kernel_sigma=0.2),
    dict(class_cond_weighting=True),
    dict(decision_threshold=0.3, pos_class="b"),
    dict(cost=np.array([[0.0, 1.0], [4.0, 0.0]])),
]


@pytest.mark.parametrize("kw", PREDICT_CASES)
def test_predict_matches_jax(mixed, kw):
    train, test, probs = mixed
    est = mknn.KNN(k=7, device="cpu", **kw)
    got = est.predict(est.fit(train, class_probs=probs), test, validate=True)
    jest = jknn.KNN(k=7, **kw)
    want = jest.predict(jest.fit(_twin(train), class_probs=probs), _twin(test),
                        validate=True)
    np.testing.assert_array_equal(got.predicted, want.predicted)
    np.testing.assert_allclose(got.class_scores, want.class_scores, atol=1e-6)
    np.testing.assert_array_equal(got.neighbor_idx, want.neighbor_idx)
    np.testing.assert_allclose(got.neighbor_dist, want.neighbor_dist, atol=1e-6)
    assert got.counters.as_dict() == want.counters.as_dict()


@pytest.mark.parametrize("method", ["average", "median", "linear"])
def test_regress_matches_jax(mixed, method):
    train, test, _ = mixed
    values = np.random.default_rng(52).normal(size=train.num_rows)
    kw = {}
    if method == "linear":
        kw = dict(input_var=test.cont[:, 0].astype(np.float64),
                  ref_input_var=train.cont[:, 0].astype(np.float64))
    est = mknn.KNN(k=6, kernel="gaussian", device="cpu")
    got = est.regress(est.fit(train, values=values), test, method=method, **kw)
    jest = jknn.KNN(k=6, kernel="gaussian")
    want = jest.regress(jest.fit(_twin(train), values=values), _twin(test),
                        method=method, **kw)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_convert_knn_model_from_jax(mixed):
    train, test, probs = mixed
    jmodel = jknn.fit_knn(_twin(train), class_probs=probs)
    model = convert.knn_model_from_jax(jmodel)
    est = mknn.KNN(k=5, class_cond_weighting=True, device="cpu")
    got = est.predict(model, test)
    want = est.predict(est.fit(train, class_probs=probs), test)
    np.testing.assert_array_equal(got.predicted, want.predicted)
    np.testing.assert_array_equal(got.neighbor_idx, want.neighbor_idx)
    jwant = jknn.KNN(k=5, class_cond_weighting=True).predict(jmodel, _twin(test))
    np.testing.assert_array_equal(got.predicted, jwant.predicted)
    jmodel.labels = jmodel.labels[:10]
    with pytest.raises(ValueError, match="labels"):
        convert.knn_model_from_jax(jmodel)


def test_knn_needs_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device"):
        mknn.KNN()


def test_wrappers_check_their_operands():
    a = torch.zeros((512, 128), dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        tk.knn_topk(a.float(), a.float(), 10)
    with pytest.raises(ValueError):
        tk.knn_topk(a, a[:, :64], 10)
    with pytest.raises(ValueError):
        tk.knn_topk(a, a, 129)
    with pytest.raises(ValueError):
        tk.knn_tourney(a, torch.zeros((3, 5, 2)))


def test_route_gate_is_the_same_on_every_device(mixed):
    train, _, _ = mixed
    model = mknn.fit_knn(train)
    assert mknn.kernel_route(model, 10, "euclidean")
    assert not mknn.kernel_route(model, 10, "manhattan")
    assert not mknn.kernel_route(model, tk.SLOTS, "euclidean")
    wide = mknn.fit_knn(EncodedDataset(
        codes=np.zeros((10, 80), np.int32), cont=np.zeros((10, 0), np.float32),
        labels=np.zeros(10, np.int32), n_bins=np.full(80, 10, np.int32),
        class_values=["a"]))
    assert mknn.kernel_route(wide, 3, "euclidean")         # W = 896: any width


# ---------------------------------------------------------------------------
# the three jobs through both CLIs
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
       for j in range(6)]
    + [{"name": f"x{j}", "ordinal": 7 + j, "dataType": "double",
        "feature": True} for j in range(8)]
    + [{"name": "label", "ordinal": 15, "dataType": "categorical",
        "cardinality": ["a", "b"]}])}


def _mixed_rows(rng, n, start):
    rows = np.empty((n, 16), dtype=object)
    rows[:, 0] = [f"r{start + i}" for i in range(n)]
    codes = rng.integers(0, 10, size=(n, 6))
    for j in range(6):
        rows[:, 1 + j] = [f"v{v}" for v in codes[:, j]]
    cont = rng.normal(size=(n, 8))
    for j in range(8):
        rows[:, 7 + j] = [f"{v:.6f}" for v in cont[:, j]]
    logit = cont[:, 0] - cont[:, 1] + (codes[:, 0] < 5)
    rows[:, 15] = np.where(logit + rng.normal(0, 1, n) > 0.5, "b", "a")
    return rows


JOBS = {
    "nn": ["NearestNeighbor", "-Dtop.match.count=7"],
    "nn_val": ["NearestNeighbor", "-Dtop.match.count=9",
               "-Dkernel.function=gaussian", "-Dkernel.param=0.25",
               "-Dvalidation.mode=true", "-Dpositive.class.value=b"],
    "nn_cc": ["NearestNeighbor", "-Dtop.match.count=5",
              "-Dclass.condition.weighted=true",
              "-Dinverse.distance.weighted=true"],
    "nn_cost": ["NearestNeighbor", "-Dtop.match.count=5",
                "-Duse.cost.based.classifier=true", "-Dbp.predict.class=a,b",
                "-Dbp.predict.class.cost=1,3"],
    "nn_reg": ["NearestNeighbor", "-Dtop.match.count=6",
               "-Dprediction.mode=regression",
               "-Dregression.target.ordinal=8", "-Dregression.method=linear",
               "-Dregression.input.var.ordinal=9"],
    "sts": ["SameTypeSimilarity", "-Dtop.match.count=4"],
}


@pytest.fixture(scope="module")
def job_outputs(tmp_path_factory):
    work = tmp_path_factory.mktemp("knn_jobs")
    rng = np.random.default_rng(61)
    write_csv(str(work / "train.csv"), _mixed_rows(rng, 2000, 0))
    write_csv(str(work / "test.csv"), _mixed_rows(rng, 300, 2000))
    (work / "schema.json").write_text(json.dumps(MIXED_SCHEMA))
    common = [f"-Dfeature.schema.file.path={work / 'schema.json'}",
              f"-Dtraining.data.path={work / 'train.csv'}"]
    out = {}
    for pkg, main, extra in (("jax", jax_main, []),
                             ("torch", torch_main, ["--device", "cpu"])):
        o = lambda job: str(work / f"{pkg}_{job}")  # noqa: E731
        _run(main, ["BayesianDistribution", *common, str(work / "train.csv"),
                    o("nb"), *extra])
        _run(main, ["BayesianPredictor", *common,
                    f"-Dbayesian.model.file.path={o('nb')}",
                    "-Doutput.feature.prob.only=true",
                    str(work / "train.csv"), o("probs"), *extra])
        res = {}
        for name, argv in JOBS.items():
            args = [argv[0], *common, *argv[1:]]
            if name == "nn_cc":
                args.insert(1, f"-Dbayesian.model.file.path={o('nb')}")
            res[name + "_counters"] = _run(
                main, [*args, str(work / "test.csv"), o(name), *extra])
        # both joiners read the JAX package's pair and posterior files, so
        # the comparison holds the join alone
        _run(main, ["FeatureCondProbJoiner", *common,
                    f"-Dfeature.prob.file.path={work / 'jax_probs'}",
                    str(work / "jax_sts"), o("join"), *extra])
        for name in [*JOBS, "join"]:
            res[name] = pathlib.Path(o(name), "part-00000").read_text()
        out[pkg] = res
    out["work"] = work
    return out


@pytest.mark.parametrize("job", ["nn", "nn_val", "nn_cc", "nn_cost", "nn_reg"])
def test_nearest_neighbor_part_files_byte_identical(job_outputs, job):
    got, want = job_outputs["torch"][job], job_outputs["jax"][job]
    assert got and len(got.splitlines()) == 300
    assert got == want


def test_nearest_neighbor_validation_counters_equal(job_outputs):
    got = job_outputs["torch"]["nn_val_counters"]
    assert "Validation" in got and "\taccuracy=" in got
    assert got == job_outputs["jax"]["nn_val_counters"]


def _sts_lines(text):
    return [ln.split(",") for ln in text.splitlines()]


def test_same_type_similarity_matches_jax(job_outputs):
    got = _sts_lines(job_outputs["torch"]["sts"])
    want = _sts_lines(job_outputs["jax"]["sts"])
    assert len(got) == len(want) == 300 * 4
    apart = []
    for n, (g, w) in enumerate(zip(got, want)):
        assert g[:2] == w[:2], (g, w)
        if g[2] != w[2]:
            assert abs(int(g[2]) - int(w[2])) == 1, (g, w)
            apart.append(n)
    if apart:
        # a scaled distance may round apart by one only where the two
        # packages' d differ by at most 2e-5 (d sits on a .5 step)
        work = job_outputs["work"]
        schema = FeatureSchema.from_file(str(work / "schema.json"))
        enc = DatasetEncoder(schema)
        train = enc.fit_transform(read_input(str(work / "train.csv")))
        test = enc.transform(read_input(str(work / "test.csv")),
                             with_labels=False)
        d, _ = mknn.nearest_neighbors(mknn.fit_knn(train), test, 4,
                                      device="cpu")
        jd, _ = jknn.nearest_neighbors(jknn.fit_knn(_twin(train)),
                                       _twin(test), 4)
        for n in apart:
            assert abs(d.flat[n] - np.asarray(jd).flat[n]) <= 2e-5


def test_feature_cond_prob_joiner_byte_identical(job_outputs):
    got = job_outputs["torch"]["join"]
    assert len(got.splitlines()) == 300 * 4 and got.count(",a,") == 1200
    assert got == job_outputs["jax"]["join"]
