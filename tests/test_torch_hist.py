"""The port's co-occurrence grams and count tensors (avenir_tpu_torch.ops)
held against the JAX package on the CPU.

The plain versions ``cooc_counts_cols_ref`` and
``cross_cooc_counts_cols_ref`` must equal the Pallas kernels run through
their interpreter (as tests/test_pallas_hist.py runs them) exactly; the
layout and PackGraft helpers must equal the JAX copies; the ``agg``
bincounts must equal the JAX einsum counts.  The CUDA kernels are held
against the plain versions on the card in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from avenir_tpu.ops import agg as jagg  # noqa: E402
from avenir_tpu.ops import pallas_hist as ph  # noqa: E402
from avenir_tpu_torch.ops import agg, hist  # noqa: E402

LAYOUT_SHAPES = [
    (11, 12, 2),    # hospital readmission: fmaj, jcp 32, wp 384
    (20, 3, 2),     # jmaj, wp 128
    (5, 6, 2),      # jmaj
    (4, 5, 3),      # fmaj
    (3, 30, 2),     # fmaj, jcp 64
    (200, 1, 2),    # jmaj with more features than a 64-wide tile
    (10, 20, 1),    # one class (Cramér shape)
    (20, 20, 2),    # cls
    (16, 20, 3),    # cls
    (100, 20, 2),   # clsb
    (40, 40, 9),    # past cls's class gate
    (1, 1, 1),
]


def _data(n, f, b, c, seed, invalid=True):
    """codes_t [F, N], labels [N] int32 with dropped cells (-1, B, B+5) and
    dropped rows (-1, C)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, b, size=(f, n)).astype(np.int32)
    labels = rng.integers(0, c, size=n).astype(np.int32)
    if invalid and n:
        for val in (-1, b, b + 5):
            codes[rng.integers(0, f, 8), rng.integers(0, n, 8)] = val
        for val in (-1, c):
            labels[rng.integers(0, n, 5)] = val
    return codes, labels


@pytest.mark.parametrize("f,b,c", LAYOUT_SHAPES)
def test_layout_helpers_match_jax(f, b, c):
    assert hist.plan(f, b, c) == ph.plan(f, b, c)
    assert hist.clsb_tile(f, b, c) == ph.clsb_tile(f, b, c)
    assert hist.g_key(f, b, c) == ph.g_key(f, b, c)
    assert hist.applicable(f, b, c) == ph.applicable(f, b, c)
    np.testing.assert_array_equal(hist.w_index(f, b, c), ph.w_index(f, b, c))
    mode, _, wp = ph.plan(f, b, c)
    assert hist.default_block_cols(wp, mode) == ph.default_block_cols(wp, mode)


# B1's fmaj and jmaj shapes, invalid codes and labels in each; the skewed
# ones (95% of codes in one bin) put most of a pair's rows in one cell
JAX_GRAM_CASES = [
    (4096, 11, 12, 2, 0.0),     # hospital shape, whole blocks
    (2999, 11, 12, 2, 0.0),     # ragged tail
    (1000, 4, 5, 3, 0.0),       # fmaj, C = 3
    (777, 20, 3, 2, 0.0),       # jmaj
    (300, 5, 6, 2, 0.0),        # jmaj
    (513, 3, 30, 2, 0.0),       # fmaj, jcp 64
    (0, 11, 12, 2, 0.0),        # empty chunk
    (0, 20, 3, 2, 0.0),
    (2500, 10, 13, 2, 0.95),    # the hospital MI chunk's shape, skewed
    (1999, 11, 12, 2, 0.95),
    (777, 20, 3, 2, 0.95),      # jmaj, skewed
    (1500, 30, 8, 2, 0.95),     # jmaj, the wide tree's K = 1 level
    (1500, 30, 8, 2, 0.0),
    (600, 2, 3, 40, 0.95),      # fmaj, C = 40
]


@pytest.mark.parametrize(
    "n,f,b,c,skew", JAX_GRAM_CASES,
    ids=[f"{n}-{f}-{b}-{c}" + (f"-skew{s}" if s else "")
         for n, f, b, c, s in JAX_GRAM_CASES])
def test_ref_matches_jax_kernel_interpret(n, f, b, c, skew):
    codes, labels = _data(n, f, b, c, seed=n + f)
    if skew:
        rng = np.random.default_rng(n + c)
        hot = rng.random(codes.shape) < skew
        codes[hot & (codes >= 0) & (codes < b)] = b // 2
    assert ph.plan(f, b, c)[0] in ("fmaj", "jmaj")
    want = np.asarray(ph.cooc_counts_cols(
        jnp.asarray(codes), jnp.asarray(labels), b, c, block_cols=256,
        interpret=True))
    got = hist.cooc_counts_cols_ref(torch.from_numpy(codes),
                                    torch.from_numpy(labels), b, c)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,f,b,c", [(400, 20, 20, 2), (300, 16, 20, 3),
                                     (200, 100, 20, 2)])
def test_ref_per_class_modes_match_jax(n, f, b, c, monkeypatch):
    """cls/clsb shapes: the plain version equals the JAX exact gram."""
    codes, labels = _data(n, f, b, c, seed=7)
    want = np.asarray(ph.gram_counts_cols(jnp.asarray(codes),
                                          jnp.asarray(labels), b, c))
    monkeypatch.setattr(hist, "_gram_block_rows", lambda *a: 128)
    got = hist.cooc_counts_cols_ref(torch.from_numpy(codes),
                                    torch.from_numpy(labels), b, c)
    np.testing.assert_array_equal(got.numpy(), want)


def test_ref_block_rows_do_not_change_g(monkeypatch):
    codes, labels = _data(1500, 11, 12, 2, seed=3)
    ct, lb = torch.from_numpy(codes), torch.from_numpy(labels)
    whole = hist.cooc_counts_cols_ref(ct, lb, 12, 2)
    for br in (128, 256, 1408):
        monkeypatch.setattr(hist, "_gram_block_rows", lambda *a, br=br: br)
        assert torch.equal(hist.cooc_counts_cols_ref(ct, lb, 12, 2), whole)


def test_wrapper_on_cpu_runs_plain_version_without_launch():
    codes, labels = _data(1000, 11, 12, 2, seed=5)
    before = hist.cooc_counts_cols.launches
    g = hist.cooc_counts_cols(torch.from_numpy(codes),
                              torch.from_numpy(labels), 12, 2)
    assert hist.cooc_counts_cols.launches == before
    ref = hist.cooc_counts_cols_ref(torch.from_numpy(codes),
                                    torch.from_numpy(labels), 12, 2)
    assert torch.equal(g, ref)
    # G is the full symmetric matrix, pad rows/cols exactly zero
    assert torch.equal(g, g.T)
    used = np.zeros(g.shape[0], bool)
    used[hist.w_index(11, 12, 2).ravel()] = True
    assert (g.numpy()[~used] == 0).all()
    # row-major entry = columnar entry
    rows = hist.cooc_counts(torch.from_numpy(np.ascontiguousarray(codes.T)),
                            torch.from_numpy(labels), 12, 2)
    assert torch.equal(rows, g)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    ct = torch.zeros((3, 10), dtype=torch.int32)
    lb = torch.zeros(10, dtype=torch.int32)
    with pytest.raises(TypeError):
        hist.cooc_counts_cols(ct.long(), lb, 4, 2)
    with pytest.raises(ValueError):
        hist.cooc_counts_cols(ct, lb[:9], 4, 2)
    with pytest.raises(ValueError):
        hist.cooc_counts_cols(ct[0], lb, 4, 2)
    with pytest.raises(ValueError):          # neither CPU nor CUDA
        hist.cooc_counts_cols(ct.to("meta"), lb.to("meta"), 4, 2)
    with pytest.raises(ValueError):          # the exact-count chunk cap
        hist.cooc_counts_cols(torch.empty((1, 1 << 24), dtype=torch.int32),
                              torch.empty(1 << 24, dtype=torch.int32), 4, 2)


def test_use_kernel_means_cuda_and_applicable():
    assert not hist.use_kernel(11, 12, 2, "cpu")
    assert hist.use_kernel(11, 12, 2, "cuda")
    assert hist.use_kernel(20, 20, 2, "cuda")          # cls: B2
    assert not hist.use_kernel(300, 40, 20, "cuda")    # past every gate


@pytest.mark.parametrize("n,f,b,c", [(1200, 11, 12, 2), (700, 20, 3, 2),
                                     (500, 16, 20, 3)])
def test_counts_from_cooc_equal_agg_counts(n, f, b, c):
    codes_t, labels = _data(n, f, b, c, seed=11)
    pairs = np.array([(i, j) for i in range(f) for j in range(i + 1, f)],
                     np.int64).reshape(-1, 2)
    g = hist.cooc_counts_cols_ref(torch.from_numpy(codes_t),
                                  torch.from_numpy(labels), b, c)
    fbc, pair = hist.counts_from_cooc(g, f, b, c, pairs[:, 0], pairs[:, 1])
    codes = torch.from_numpy(np.ascontiguousarray(codes_t.T))
    lab = torch.from_numpy(labels)
    np.testing.assert_array_equal(
        fbc, agg.feature_class_counts(codes, lab, c, b).numpy())
    ip, jp = torch.from_numpy(pairs[:, 0]), torch.from_numpy(pairs[:, 1])
    np.testing.assert_array_equal(
        pair, agg.pair_class_counts(codes[:, ip], codes[:, jp], lab, c, b).numpy())
    # and the JAX package's einsum step gives the same tensors
    jf, jp_ = jagg.nb_mi_pipeline_step(
        jnp.asarray(codes_t.T), jnp.asarray(labels), jnp.asarray(pairs[:, 0]),
        jnp.asarray(pairs[:, 1]), c, b)
    np.testing.assert_array_equal(fbc, np.asarray(jf))
    np.testing.assert_array_equal(pair, np.asarray(jp_))


def test_agg_counts_match_jax():
    rng = np.random.default_rng(2)
    n, f, b, c = 900, 6, 7, 3
    codes_t, labels = _data(n, f, b, c, seed=2)
    codes = np.ascontiguousarray(codes_t.T)
    ci = codes[:, [0, 1, 4]]
    cj = codes[:, [2, 5, 3]]
    t = torch.from_numpy
    np.testing.assert_array_equal(
        agg.class_counts(t(labels), c).numpy(),
        np.asarray(jagg.class_counts(jnp.asarray(labels), c)))
    np.testing.assert_array_equal(
        agg.feature_class_counts(t(codes), t(labels), c, b).numpy(),
        np.asarray(jagg.feature_class_counts(jnp.asarray(codes),
                                             jnp.asarray(labels), c, b)))
    np.testing.assert_array_equal(
        agg.pair_class_counts(t(ci), t(cj), t(labels), c, b).numpy(),
        np.asarray(jagg.pair_class_counts(jnp.asarray(ci), jnp.asarray(cj),
                                          jnp.asarray(labels), c, b)))
    # integer-valued moments are exact in float32 on both sides
    vals = rng.integers(-50, 50, size=(n, 3)).astype(np.float32)
    mine = agg.class_moments(t(vals), t(labels), c)
    theirs = jagg.class_moments(jnp.asarray(vals), jnp.asarray(labels), c)
    for a, b_ in zip(mine, theirs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b_))


def test_agg_chunk_cap_and_accumulator():
    with pytest.raises(ValueError):
        agg.class_counts(torch.empty(1 << 24, dtype=torch.int32), 2)
    acc = agg.Accumulator()
    acc.add("x", torch.tensor([1, 2], dtype=torch.int32))
    acc.add("x", np.array([3, 4], np.int32))
    acc.add("m", torch.tensor([0.5]))
    assert acc.get("x").dtype == np.int64 and acc.get("x").tolist() == [4, 6]
    assert acc.get("m").dtype == np.float64
    assert sorted(acc.names()) == ["m", "x"] and "x" in acc
    state = acc.state()
    other = agg.Accumulator()
    other.load(state)
    assert other.get("x").tolist() == [4, 6]


@pytest.mark.parametrize("n,f,b,c", [(600, 20, 20, 2), (400, 100, 20, 2)])
def test_wrapper_per_class_modes_on_cpu(n, f, b, c):
    """cls and clsb through the public wrapper on CPU tensors: the plain
    version, no launch, equal to the JAX exact gram."""
    codes, labels = _data(n, f, b, c, seed=19)
    counters = (hist.cooc_counts_cols.launches,
                hist.cooc_counts_cols.cls_launches,
                hist.cooc_counts_cols.clsb_launches)
    g = hist.cooc_counts_cols(torch.from_numpy(codes),
                              torch.from_numpy(labels), b, c)
    assert counters == (hist.cooc_counts_cols.launches,
                        hist.cooc_counts_cols.cls_launches,
                        hist.cooc_counts_cols.clsb_launches)
    mode, _, wp = hist.plan(f, b, c)
    assert mode == ("cls" if f == 20 else "clsb")
    assert g.shape == (c, wp, wp) and g.dtype == torch.int32
    want = np.asarray(ph.gram_counts_cols(jnp.asarray(codes),
                                          jnp.asarray(labels), b, c))
    np.testing.assert_array_equal(g.numpy(), want)


def _cross_data(n, f, b, s, seed):
    """codes_t [F, N], sel [N] int32 with dropped cells (-1, B, B+5) and
    dropped rows (sel -1, num_sel, num_sel+9)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, b, size=(f, n)).astype(np.int32)
    sel = rng.integers(0, s, size=n).astype(np.int32)
    if n:
        for val in (-1, b, b + 5):
            codes[rng.integers(0, f, 8), rng.integers(0, n, 8)] = val
        for val in (-1, s, s + 9):
            sel[rng.integers(0, n, 5)] = val
    return codes, sel


@pytest.mark.parametrize("n,f,b,s", [
    (1024, 10, 13, 2),     # the hospital tree's root, whole blocks
    (1999, 10, 13, 54),    # a deeper level, ragged N
    (700, 3, 40, 300),     # num_sel > 128: several selector lane tiles
    (500, 24, 32, 7),      # X side at the gate (wp 768)
    (0, 10, 13, 54),       # empty chunk
])
def test_cross_ref_matches_jax_kernel_interpret(n, f, b, s):
    codes, sel = _cross_data(n, f, b, s, seed=n + s)
    want = np.asarray(ph.cross_cooc_counts_cols(
        jnp.asarray(codes), jnp.asarray(sel), b, s, block_cols=256,
        interpret=True))
    before = hist.cross_cooc_counts_cols.launches
    got = hist.cross_cooc_counts_cols(torch.from_numpy(codes),
                                      torch.from_numpy(sel), b, s)
    assert hist.cross_cooc_counts_cols.launches == before    # CPU: no launch
    assert got.dtype == torch.int32 and got.shape == (f, b, s)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        hist.cross_cooc_counts_cols_ref(torch.from_numpy(codes),
                                        torch.from_numpy(sel), b, s).numpy(),
        want)


def test_cross_gates_and_operand_checks_match_jax():
    for f, b, s in [(10, 13, 54), (24, 32, 1024), (24, 32, 1025),
                    (25, 32, 2), (3, 100, 200), (0, 5, 2), (4, 5, 0)]:
        assert hist.cross_applicable(f, b, s) == ph.cross_applicable(f, b, s)
    for s in (1, 128, 129, 1024):
        assert hist.cross_sel_width(s) == ph.cross_sel_width(s)
    ct = torch.zeros((3, 10), dtype=torch.int32)
    sel = torch.zeros(10, dtype=torch.int32)
    with pytest.raises(TypeError):
        hist.cross_cooc_counts_cols(ct, sel.long(), 4, 2)
    with pytest.raises(ValueError):
        hist.cross_cooc_counts_cols(ct, sel[:9], 4, 2)
    with pytest.raises(ValueError):          # neither CPU nor CUDA
        hist.cross_cooc_counts_cols(ct.to("meta"), sel.to("meta"), 4, 2)


# the wide tree's 30 × 8 × 2 frontiers (jmaj, cls, cls, clsb), the
# hospital shapes, and shapes past the cls gates
PACK_SHAPES = [(k, 30, 8, 2) for k in (1, 2, 4, 8, 16)] + [
    (k, 10, 13, 2) for k in (1, 3, 27)] + [
    (3, 4, 5, 3), (2, 40, 40, 9), (6, 100, 20, 2), (0, 4, 5, 2),
    (4, 0, 5, 2), (200, 30, 8, 2)]


@pytest.mark.parametrize("m,f,b,c", PACK_SHAPES)
def test_pack_disjoint_matches_jax(m, f, b, c):
    got, want = hist.pack_disjoint(m, f, b, c), ph.pack_disjoint(m, f, b, c)
    if want is None:
        assert got is None
        return
    assert tuple(got) == tuple(want)
    assert got.signature == want.signature and got.g_key == want.g_key
    assert hist.packed_applicable(got) == ph.packed_applicable(want)
    assert hist.packed_g_key(f, m * got.stripe_bins, c) == \
        ph.packed_g_key(f, m * want.stripe_bins, c)
    np.testing.assert_array_equal(hist.packed_diag_index(got),
                                  ph.packed_diag_index(want))


def test_wide_tree_frontiers_pack_on_jmaj_cls_clsb():
    modes = [hist.pack_disjoint(k, 30, 8, 2) for k in (1, 2, 4, 8)]
    assert [(p.mode, p.wp) for p in modes] == [
        ("jmaj", 512), ("cls", 512), ("cls", 1024), ("clsb", 3840)]
    assert modes[3].band_bins == 16
    assert not hist.cross_applicable(30, 8, 2)
    assert hist.cross_applicable(10, 13, 54)


@pytest.mark.parametrize("stripe,member_bins", [(8, 8), (16, 8), (13, 13)])
def test_packed_codes_match_jax(stripe, member_bins):
    rng = np.random.default_rng(stripe)
    n, f = 500, 6
    codes = rng.integers(-2, member_bins + 3, size=(f, n)).astype(np.int32)
    member = rng.integers(-1, 5, size=n).astype(np.int32)
    got = hist.packed_codes(torch.from_numpy(codes), torch.from_numpy(member),
                            stripe, member_bins)
    want = np.asarray(ph.packed_codes(jnp.asarray(codes), jnp.asarray(member),
                                      stripe, member_bins))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # an out-of-range local code never reaches the next member's stripe
    assert ((got.numpy() == -1) | (got.numpy() % stripe < member_bins)).all()


# the pair pass of B2/B3: the wide tree's four level shapes, the MI and
# clsb chunks of chip_smoke, a pair table past shared memory, C = 16
PAIR_SHAPES = [(30, 8, 2), (30, 16, 2), (30, 32, 2), (30, 128, 2),
               (20, 20, 2), (100, 20, 2), (2, 3072, 2), (8, 50, 16),
               # B1's fmaj and jmaj shapes: the hospital MI chunk and bench
               # shape, jmaj 20 × 3 × 2, 200 features of one bin, C = 100
               (10, 13, 2), (11, 12, 2), (20, 3, 2), (200, 1, 2), (3, 2, 100)]
H100_SMEM, H100_SMS = 232_448, 132


@pytest.mark.parametrize("f,b,c", PAIR_SHAPES)
def test_pair_plan_covers_each_cell_once_within_budget(f, b, c):
    pp = hist.pair_plan(f, b, c, 1_000_000, H100_SMEM, H100_SMS)
    t = pp.tasks
    assert t.dtype == np.int32 and t.shape[1] == 6 and len(t)
    seen = np.zeros((c, f, f, b), np.int64)         # (class, f1, f2, bin of f1)
    for cls, f1, f2a, nf2, b1a, nb1 in t.tolist():
        assert 1 <= nf2 <= hist.PAIR_RUN and 1 <= nb1 and b1a + nb1 <= b
        assert f1 <= f2a and f2a + nf2 <= f
        seen[cls, f1, f2a:f2a + nf2, b1a:b1a + nb1] += 1
        assert nf2 * nb1 * (b + (8 - b) % 32) <= pp.cells
    upper = np.triu(np.ones((f, f), bool))
    assert (seen[:, upper] == 1).all() and (seen[:, ~upper] == 0).all()
    assert pp.smem == 4 * pp.copies * pp.cells
    assert pp.smem <= min(H100_SMEM, hist.PAIR_SMEM)
    assert 1 <= pp.copies <= hist.PAIR_COPIES and pp.splits >= 1
    # a B × B table past the budget is cut into bands of f1's bins
    banded = b * (b + (8 - b) % 32) * 4 > hist.PAIR_SMEM
    assert (t[:, 5] < b).any() == banded
    again = hist.pair_plan(f, b, c, 1_000_000, H100_SMEM, H100_SMS)
    assert np.array_equal(again.tasks, t) and again[1:] == pp[1:]


def _pair_gram(codes, labels, b, c, pp):
    """G as pair_kernel computes it from the plan: per task and row split a
    table [run, band, B] of the class's rows, then plain stores (one split)
    or adds into G and its mirror, at the addresses of pair_layout."""
    f, _n = codes.shape
    mode, jcp, wp = hist.plan(f, b, c)
    gmat, cs, fs, bs = hist.pair_layout(mode, f, b, c, jcp, wp)
    g = np.zeros((c, wp, wp) if gmat else (wp, wp), np.int64)
    for cls, f1, f2a, nf2, b1a, nb1 in pp.tasks.tolist():
        rows = np.flatnonzero(labels == cls)
        per = -(-len(rows) // pp.splits)
        for s in range(pp.splits):
            r = rows[s * per:(s + 1) * per]
            c1 = codes[f1, r] - b1a
            table = np.zeros((nf2, nb1, b), np.int64)
            for k in range(nf2):
                c2 = codes[f2a + k, r]
                ok = ((c1 >= 0) & (c1 < nb1) & (codes[f1, r] < b)
                      & (c2 >= 0) & (c2 < b))
                np.add.at(table[k], (c1[ok], c2[ok]), 1)
            for k, bl, b2 in zip(*np.nonzero(table)):
                f2, b1 = f2a + k, b1a + bl
                if f2 == f1 and b1 != b2:
                    continue
                w1 = cls * cs + f1 * fs + b1 * bs
                w2 = cls * cs + f2 * fs + b2 * bs
                v = table[k, bl, b2]
                gc = g[cls] if gmat else g
                for x, y in ((w1, w2), (w2, w1)) if f2 != f1 else ((w1, w2),):
                    if pp.splits == 1:
                        gc[x, y] = v
                    else:
                        gc[x, y] += v
    return g


@pytest.mark.parametrize("n,f,b,c,smem,splits", [
    (700, 20, 20, 2, H100_SMEM, None),    # run of 8 f2, copies, splits 1
    (700, 20, 20, 2, H100_SMEM, 3),       # rows split: adds
    (500, 14, 20, 3, 1024, None),         # 20 x 20 table past 1 KB: bands
    (500, 14, 20, 3, 1024, 2),
    (400, 100, 20, 2, H100_SMEM, None),   # clsb
    (300, 8, 50, 16, H100_SMEM, 4),       # C = 16
    (700, 10, 13, 2, H100_SMEM, None),    # fmaj: the hospital MI chunk (B1)
    (700, 10, 13, 2, H100_SMEM, 5),
    (600, 30, 8, 2, H100_SMEM, None),     # jmaj: the wide tree's K = 1 level
    (600, 30, 8, 2, H100_SMEM, 3),
    (500, 3, 30, 2, 1024, 2),             # fmaj, jcp 64, banded
    (400, 2, 3, 40, H100_SMEM, None),     # fmaj, C = 40
])
def test_pair_plan_gram_equals_plain_version(n, f, b, c, smem, splits):
    """The plan's tasks, counted the way pair_kernel counts them (numpy)
    and stored through pair_layout, give exactly the plain version's G in
    every plan mode, invalid codes and labels included."""
    codes, labels = _data(n, f, b, c, seed=n + f)
    pp = hist.pair_plan(f, b, c, n, smem, H100_SMS)
    if splits is not None:
        pp = pp._replace(splits=splits)
    if smem < 4 * b * b:
        assert (pp.tasks[:, 5] < b).all()
    want = hist.cooc_counts_cols_ref(torch.from_numpy(codes),
                                     torch.from_numpy(labels), b, c)
    np.testing.assert_array_equal(_pair_gram(codes, labels, b, c, pp),
                                  want.numpy())


@pytest.mark.parametrize("f,b,c", LAYOUT_SHAPES + [(30, 8, 2), (2, 3, 40)])
def test_pair_layout_is_w_index(f, b, c):
    """The pair pass's store map puts cell (f, b) of class c where
    w_index() says, in class c's matrix in the per-class modes: G keeps the
    layout counts_from_cooc reads.  Distinct cells of one matrix land on
    distinct lanes, inside wp."""
    mode, jcp, wp = hist.plan(f, b, c)
    gmat, cs, fs, bs = hist.pair_layout(mode, f, b, c, jcp, wp)
    ff, bb, cc = np.meshgrid(np.arange(f), np.arange(b), np.arange(c),
                             indexing="ij")
    lanes = cc * cs + ff * fs + bb * bs
    np.testing.assert_array_equal(lanes, hist.w_index(f, b, c))
    assert lanes.max() < wp
    assert gmat == (wp * wp if mode in ("cls", "clsb") else 0)
    per_matrix = lanes if gmat else lanes.reshape(-1)
    if gmat:                                  # per class: distinct (f, b)
        assert len(np.unique(per_matrix[:, :, 0])) == f * b
    else:
        assert len(np.unique(per_matrix)) == f * b * c


def test_build_hash_covers_included_headers(tmp_path, monkeypatch):
    """An edited kernel or header gives the kernel a new library name, so a
    stale build is never loaded."""
    from avenir_tpu_torch.ops import _build

    (tmp_path / "k.cu").write_text('#include "a.cuh"\nint k;\n')
    (tmp_path / "a.cuh").write_text("#pragma once\n")
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    first = _build.source_digest("k")
    assert _build.source_digest("k") == first
    (tmp_path / "a.cuh").write_text("#pragma once\n// edited\n")
    second = _build.source_digest("k")
    assert second != first
    (tmp_path / "k.cu").write_text('#include "a.cuh"\nint k2;\n')
    assert _build.source_digest("k") not in (first, second)
    # the port's own kernels: each hash covers the shared headers
    monkeypatch.undo()
    for name in ("cooc_pair", "cross", "knn_tourney", "knn_topk",
                 "gram_probe"):
        assert len(_build.source_digest(name)) == 12


def test_entry_argtypes_match_the_c_signatures():
    """Each ctypes declaration of a kernel's C entry point has the C
    function's arity and kinds (a pointer or the stream as c_void_p, an int
    as c_int), read from its source: ctypes cannot see a mismatch."""
    import ctypes
    import re

    from avenir_tpu_torch import probes
    from avenir_tpu_torch.ops import _build
    from avenir_tpu_torch.ops import knn as tk

    for entries in (hist._ENTRY, tk._ENTRY, probes._ENTRY):
        for name, fns in entries.items():
            with open(f"{_build.CSRC}/{name}.cu") as fh:
                src = fh.read()
            for fn, argtypes in fns.items():
                sig = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", src)
                assert sig, (name, fn)
                params = [p.strip() for p in sig.group(1).split(",") if p.strip()]
                kinds = [ctypes.c_void_p if "*" in p else ctypes.c_int
                         for p in params]
                assert kinds == argtypes, (name, fn, params)
