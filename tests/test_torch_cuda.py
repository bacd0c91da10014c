"""The port's CUDA kernels on the card against their plain PyTorch
versions: the co-occurrence grams in every layout (the pair histogram of
``csrc/cooc_pair.cu``: B1 in fmaj/jmaj, B2/B3 per class) and the cross
counts (``csrc/cross.cu``, B4) exactly; the kNN candidate kernels
(``csrc/knn_tourney.cu``, B5, and ``csrc/knn_topk.cu``, B6) exactly where
every d² is an integer sum and to the float32 summation order elsewhere;
the kNN search on ``cuda`` against the CPU; the probe functions of
``avenir_tpu_torch.probes``; the device feeder's staging (its own stream,
pinned copies, the consumer's wait); and the SharedScan on ``cuda``
against the CPU.

Every test here needs an NVIDIA GPU and skips where there is none.  The
file imports neither JAX nor the JAX package, so on a machine without JAX
it runs with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import json  # noqa: E402

from avenir_tpu_torch.core.encoding import DatasetEncoder, EncodedDataset  # noqa: E402
from avenir_tpu_torch.core.schema import FeatureSchema  # noqa: E402
from avenir_tpu_torch.datagen.hosp_readmit import (  # noqa: E402
    HOSP_SCHEMA_JSON, generate_hosp_readmit)
from avenir_tpu_torch.models import knn as mknn  # noqa: E402
from avenir_tpu_torch.models import mutual_info as mi  # noqa: E402
from avenir_tpu_torch.models import tree  # noqa: E402
from avenir_tpu_torch.ops import hist  # noqa: E402
from avenir_tpu_torch.ops import knn as tk  # noqa: E402


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _data(n, f, b, c, seed):
    """codes_t [F, N], labels [N] int32 with dropped cells (-1, B, B+5) and
    dropped rows (-1, C)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, b, size=(f, n)).astype(np.int32)
    labels = rng.integers(0, c, size=n).astype(np.int32)
    if n:
        for val in (-1, b, b + 5):
            codes[rng.integers(0, f, 8), rng.integers(0, n, 8)] = val
        for val in (-1, c):
            labels[rng.integers(0, n, 5)] = val
    return codes, labels


_COUNTERS = {"fmaj": "launches", "jmaj": "launches", "cls": "cls_launches",
             "clsb": "clsb_launches"}


@pytest.mark.cuda
@pytest.mark.parametrize("n,f,b,c", [
    (4099, 11, 12, 2),     # bench shape, ragged tail
    (2500, 10, 13, 2),     # the CSV job's shape
    (3000, 20, 3, 2),      # jmaj
    (5000, 200, 1, 2),     # jmaj, more features than a tile
    (777, 3, 30, 2),       # fmaj, jcp 64
    (1000, 4, 5, 3),       # C = 3
    (0, 11, 12, 2),        # empty chunk: zeros, no launch
    (3001, 20, 20, 2),     # cls, wp 512 (B2)
    (2000, 16, 20, 3),     # cls, C = 3
    (1000, 1, 700, 2),     # cls, one feature
    (1500, 100, 20, 2),    # clsb, wp 2000: not a multiple of 64 (B3)
    (777, 40, 40, 9),      # clsb past cls's class gate
    (2000, 30, 8, 2),      # jmaj, the wide tree's K = 1 level (wp 512)
    (2000, 30, 16, 2),     # cls, its K = 2 pack (wp 512)
    (2000, 30, 32, 2),     # cls, its K = 4 pack (wp 1024)
    (600, 30, 128, 2),     # clsb, the wide tree's K = 8 pack (wp 3840)
    (900, 8, 50, 16),      # clsb, C = 16
    (0, 20, 20, 2),        # empty chunk in a per-class mode
    (0, 100, 20, 2),
])
def test_kernel_matches_plain_version(cuda, n, f, b, c):
    codes, labels = _data(n, f, b, c, seed=13)
    ct, lb = torch.from_numpy(codes).to(cuda), torch.from_numpy(labels).to(cuda)
    counter = _COUNTERS[hist.plan(f, b, c)[0]]
    before = {k: getattr(hist.cooc_counts_cols, k) for k in set(_COUNTERS.values())}
    g = hist.cooc_counts_cols(ct, lb, b, c)
    after = {k: getattr(hist.cooc_counts_cols, k) for k in before}
    assert after == {k: v + (1 if n and k == counter else 0)
                     for k, v in before.items()}
    torch.cuda.synchronize()
    assert g.device.type == "cuda" and g.dtype == torch.int32
    assert torch.equal(g.cpu(), hist.cooc_counts_cols_ref(
        torch.from_numpy(codes), torch.from_numpy(labels), b, c))


@pytest.mark.cuda
@pytest.mark.parametrize("n,f,b,c,skew", [
    (20_000, 20, 20, 2, 0.95),     # cls: 95% of codes in one bin
    (20_000, 100, 20, 2, 0.95),    # clsb
    (6000, 30, 128, 2, 0.9),       # the wide tree's K = 8 pack
    (3000, 2, 3072, 2, 0.0),       # clsb: a 3072 x 3072 pair table, banded
    (3000, 2, 3072, 2, 0.95),
    (20_000, 10, 13, 2, 0.95),     # fmaj (B1): the hospital MI shape
    (20_000, 30, 8, 2, 0.95),      # jmaj (B1): the wide tree's K = 1 level
    (20_000, 20, 3, 2, 0.95),      # jmaj
    (5000, 2, 3, 40, 0.5),         # fmaj, C = 40
    (0, 30, 8, 2, 0.95),           # jmaj, no rows
])
def test_pair_kernel_matches_plain_version_skewed_and_banded(cuda, n, f, b, c,
                                                             skew):
    """The pair histogram (B1–B3) where most rows share one bin (its
    atomics hit one cell) and where a pair's B x B table exceeds shared
    memory (f1's bins in bands): exactly the plain version, which runs on
    the card here."""
    codes, labels = _data(n, f, b, c, seed=29)
    rng = np.random.default_rng(31)
    codes[rng.random(codes.shape) < skew] = b // 2
    ct, lb = torch.from_numpy(codes).to(cuda), torch.from_numpy(labels).to(cuda)
    mode = hist.plan(f, b, c)[0]
    before = getattr(hist.cooc_counts_cols, _COUNTERS[mode])
    g = hist.cooc_counts_cols(ct, lb, b, c)
    assert getattr(hist.cooc_counts_cols, _COUNTERS[mode]) == before + (n > 0)
    want = hist.cooc_counts_cols_ref(ct, lb, b, c)
    torch.cuda.synchronize()
    assert torch.equal(g, want)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    codes, labels = _data(100, 20, 20, 2, seed=1)
    ct, lb = torch.from_numpy(codes).to(cuda), torch.from_numpy(labels).to(cuda)
    with pytest.raises(ValueError):                   # strided codes
        hist.cooc_counts_cols(ct[:, ::2], lb[::2].contiguous(), 3, 2)
    with pytest.raises(ValueError):                   # past every gate
        hist.cooc_counts_cols(torch.zeros((300, 4), dtype=torch.int32,
                                          device=cuda),
                              torch.zeros(4, dtype=torch.int32, device=cuda),
                              40, 20)
    sel = torch.zeros(100, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):                   # num_sel past the gate
        hist.cross_cooc_counts_cols(ct, sel, 20, 1025)
    with pytest.raises(ValueError):                   # X side past the gate
        hist.cross_cooc_counts_cols(ct, sel, 40, 2)


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


@pytest.mark.cuda
@pytest.mark.parametrize("n,f,b,s", [
    (5000, 10, 13, 2),     # the hospital tree's root level
    (4099, 10, 13, 16),    # its deepest level at depth 4 (K = 8), ragged
    (4099, 10, 13, 54),    # 54 selectors, ragged
    (4097, 10, 13, 16),    # N % 4 = 1: feature rows 16-byte aligned at
    (4098, 10, 13, 16),    # ... every fourth feature (N % 4 = 2: every
    (1, 10, 13, 16),       # ... second); one row
    (3000, 6, 32, 1024),   # num_sel at the gate: 16-bit counters
    (5000, 24, 32, 1024),  # the gate on both sides: eight feature tiles
    (2000, 3, 100, 200),   # jcp 128
    (1000, 24, 32, 300),   # X side at the gate (wp 768)
    (3000, 1, 768, 1024),  # one feature's table past shared memory:
                           # selector tiles
    (0, 10, 13, 54),       # empty: zeros, no launch
])
def test_cross_kernel_matches_plain_version(cuda, n, f, b, s):
    codes, sel = _cross_data(n, f, b, s, seed=17)
    before = hist.cross_cooc_counts_cols.launches
    t = hist.cross_cooc_counts_cols(torch.from_numpy(codes).to(cuda),
                                    torch.from_numpy(sel).to(cuda), b, s)
    assert hist.cross_cooc_counts_cols.launches == before + (1 if n else 0)
    torch.cuda.synchronize()
    assert t.device.type == "cuda" and t.dtype == torch.int32
    assert t.shape == (f, b, s)
    assert torch.equal(t.cpu(), hist.cross_cooc_counts_cols_ref(
        torch.from_numpy(codes), torch.from_numpy(sel), b, s))


def _cross_check(codes, sel, b, s):
    """One B4 launch on the card, held against the plain version on the
    CPU."""
    before = hist.cross_cooc_counts_cols.launches
    t = hist.cross_cooc_counts_cols(codes, sel, b, s)
    assert hist.cross_cooc_counts_cols.launches == before + 1
    want = hist.cross_cooc_counts_cols_ref(codes.cpu(), sel.cpu(), b, s)
    assert torch.equal(t.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4096, 4097, 4098, 4099, 100_003])
def test_cross_kernel_on_views_at_a_4_byte_offset(cuda, n):
    """codes_t and sel as contiguous views one int32 into their buffers:
    no feature row and no selector starts on a 16-byte boundary where
    N % 4 = 0, and the rows' alignments differ where it is not."""
    codes, sel = _cross_data(n, 10, 13, 16, seed=n)
    cbuf = torch.zeros(10 * n + 1, dtype=torch.int32, device=cuda)
    sbuf = torch.zeros(n + 1, dtype=torch.int32, device=cuda)
    cbuf[1:] = torch.from_numpy(codes.reshape(-1)).to(cuda)
    sbuf[1:] = torch.from_numpy(sel).to(cuda)
    ct, sv = cbuf[1:].view(10, n), sbuf[1:]
    assert ct.is_contiguous() and ct.data_ptr() % 16 == 4
    _cross_check(ct, sv, 13, 16)


@pytest.mark.cuda
@pytest.mark.parametrize("n,f,b,s,share", [
    (1_000_000, 10, 13, 16, 1.0),    # int32 counters, many clusters
    (1_000_000, 24, 32, 1024, 1.0),  # 16-bit counters: ~62,500 rows a block
    (100_003, 10, 13, 16, 0.9),
    (300_001, 24, 32, 1024, 0.9),    # 16-bit, the hot cell in a high half
])
def test_cross_kernel_skewed(cuda, n, f, b, s, share):
    """That share of the rows in one bin and one odd selector, beside
    dropped cells and rows: most of a block's increments hit one counter,
    which must not wrap, and a warp's lanes mostly share a cell."""
    codes, sel = _cross_data(n, f, b, s, seed=n)
    hot = np.random.default_rng(n + 1).random(n) < share
    hc, hs = codes[:, hot], sel[hot]
    codes[:, hot] = np.where((hc >= 0) & (hc < b), b // 2, hc)
    sel[hot] = np.where((hs >= 0) & (hs < s), s // 2 + 1, hs)
    _cross_check(torch.from_numpy(codes).to(cuda),
                 torch.from_numpy(sel).to(cuda), b, s)


@pytest.mark.cuda
def test_cross_kernel_back_to_back_and_on_another_stream(cuda):
    """Ten calls queued without a wait, then calls on a non-default stream
    between calls on the default one: each table is exact (the zeroing and
    the merge of one launch never meet another's)."""
    # one shape, so all ten share one cached plan
    inputs = [_cross_data(50_003, 10, 13, 16, seed=i) for i in range(10)]
    dev = [(torch.from_numpy(c).to(cuda), torch.from_numpy(v).to(cuda))
           for c, v in inputs]
    before = hist.cross_cooc_counts_cols.launches
    outs = [hist.cross_cooc_counts_cols(c, v, 13, 16) for c, v in dev]
    assert hist.cross_cooc_counts_cols.launches == before + 10
    for (c, v), t in zip(inputs, outs):
        want = hist.cross_cooc_counts_cols_ref(torch.from_numpy(c),
                                               torch.from_numpy(v), 13, 16)
        assert torch.equal(t.cpu(), want)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    for k in range(3):
        c, v = dev[k]
        with torch.cuda.stream(side):
            t_side = hist.cross_cooc_counts_cols(c, v, 13, 16)
        t_main = hist.cross_cooc_counts_cols(*dev[k + 3], 13, 16)
        side.synchronize()
        torch.cuda.synchronize()
        for t, (cn, vn) in ((t_side, inputs[k]), (t_main, inputs[k + 3])):
            want = hist.cross_cooc_counts_cols_ref(torch.from_numpy(cn),
                                                   torch.from_numpy(vn), 13, 16)
            assert torch.equal(t.cpu(), want)


@pytest.mark.cuda
def test_mi_fit_on_the_card_equals_cpu(cuda):
    enc = DatasetEncoder(FeatureSchema.from_json(HOSP_SCHEMA_JSON))
    ds = enc.fit_transform(generate_hosp_readmit(3000, seed=5))
    chunks = [ds.slice(s, s + 1000) for s in range(0, ds.num_rows, 1000)]
    before = hist.cooc_counts_cols.launches
    got = mi.MutualInformation().fit(chunks)          # default device: cuda
    assert hist.cooc_counts_cols.launches == before + len(chunks)
    want = mi.MutualInformation(device="cpu").fit(chunks)
    for name in ("class_counts", "feature_class_counts", "pair_class_counts"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    np.testing.assert_array_equal(got.feature_class_mi, want.feature_class_mi)


@pytest.mark.cuda
def test_feeder_chunks_equal_their_host_arrays_overwritten_after_staging(cuda):
    """One host buffer, overwritten for the next chunk as soon as the
    feeder staged the last one (the worker runs ahead by its depth): each
    staged chunk still holds its own values."""
    from avenir_tpu_torch.runtime.feeder import DeviceFeeder

    def source():
        buf = np.empty(1 << 20, np.int32)
        for i in range(8):
            buf[:] = i
            yield (buf,)

    got = []
    for (t,) in DeviceFeeder(source(), depth=3, device=cuda):
        assert t.is_cuda
        got.append((int(t.min()), int(t.max())))
    assert got == [(i, i) for i in range(8)]


@pytest.mark.cuda
def test_feeder_copy_lives_on_its_stream_until_the_consumer_waits(cuda):
    """A copy queued behind a long sleep on the feeder's stream is not done
    when the stage returns (the copy is asynchronous, from pinned memory,
    on the feeder's own stream), and the consumer still reads the right
    values: its stream waits on the copy's event."""
    from avenir_tpu_torch.runtime.feeder import CudaStage, DeviceFeeder

    class Slow(CudaStage):
        def __call__(self, item):
            with torch.cuda.stream(self.stream):
                torch.cuda._sleep(200_000_000)
            return super().__call__(item)

    stage = Slow(cuda)
    assert stage.stream != torch.cuda.current_stream(cuda)
    host = np.arange(1 << 20, dtype=np.int32)
    staged = stage(host.copy())
    assert not staged.event.query()
    torch.cuda.synchronize()
    feeder = DeviceFeeder([host + k for k in range(3)], depth=2, stage=Slow(cuda),
                          device=cuda)
    for k, t in enumerate(feeder):
        # read on the consumer's stream right away: the wait orders it
        # after the copy
        assert torch.equal(t.clone().cpu(), torch.from_numpy(host + k))


def _scan_equal_on_both_devices(ds, chunk, counter):
    from avenir_tpu_torch.models import naive_bayes as nb
    from avenir_tpu_torch.pipeline import scan

    chunks = [ds.slice(s, s + chunk) for s in range(0, ds.num_rows, chunk)]
    out = {}
    for dev in ("cuda", "cpu"):
        eng = scan.SharedScan(device=dev)
        eng.register(scan.NaiveBayesConsumer(name="nb"))
        eng.register(scan.MutualInfoConsumer(name="mi"))
        before = getattr(hist.cooc_counts_cols, counter)
        out[dev] = eng.run(chunks)
        launched = getattr(hist.cooc_counts_cols, counter) - before
        assert launched == (len(chunks) if dev == "cuda" else 0)
        assert eng.count_path == ("kernel" if dev == "cuda"
                                  else eng.count_path)
    got, want = out["cuda"], out["cpu"]
    for name in ("bin_counts", "class_counts", "cont_count", "cont_sum",
                 "cont_sumsq"):
        a, b = getattr(got["nb"], name), getattr(want["nb"], name)
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, b)
    for name in ("class_counts", "feature_class_counts", "pair_class_counts",
                 "feature_class_mi", "feature_pair_class_cond_mi"):
        np.testing.assert_array_equal(getattr(got["mi"], name),
                                      getattr(want["mi"], name))
    assert got["mi"].to_lines() == want["mi"].to_lines()
    return got, want


@pytest.mark.cuda
def test_shared_scan_on_the_card_equals_cpu_b1(cuda):
    """Hospital 10 × 13 × 2 (fmaj, B1) with three float32-exact continuous
    columns: the scan folds G and the class moments per chunk
    (``hist.gram_moments``)."""
    enc = DatasetEncoder(FeatureSchema.from_json(HOSP_SCHEMA_JSON))
    ds = enc.fit_transform(generate_hosp_readmit(5000, seed=9))
    rng = np.random.default_rng(9)
    ds.cont = (rng.integers(0, 16, size=(ds.num_rows, 3)) / 2).astype(
        np.float32)
    ds.cont_ordinals = [12, 13, 14]
    assert hist.plan(10, 13, 2)[0] == "fmaj"
    _scan_equal_on_both_devices(ds, 1500, "launches")


@pytest.mark.cuda
def test_shared_scan_on_the_card_equals_cpu_b2(cuda):
    """20 × 20 × 2 plans to cls: the scan's G comes from B2 per chunk."""
    assert hist.plan(20, 20, 2)[0] == "cls"
    _scan_equal_on_both_devices(_wide(6000, 20, 20, seed=4), 2000,
                                "cls_launches")


def _wide(n, f, b, seed):
    """A seeded [n, f] dataset of b-bin codes whose binary label depends on
    the first six features, so every frontier node has a split to take."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, b, size=(n, f)).astype(np.int32)
    logit = (codes[:, :6] - (b - 1) / 2) @ np.array([1.0, -0.8, 0.6, -0.5,
                                                      0.4, 0.3])
    labels = (logit + rng.normal(0, 2.0, n) > 0).astype(np.int32)
    return EncodedDataset(
        codes=codes, cont=np.zeros((n, 0), np.float32), labels=labels,
        n_bins=np.full(f, b, np.int32), class_values=["0", "1"],
        binned_ordinals=list(range(f)))


@pytest.mark.cuda
def test_mi_fit_per_class_shape_on_the_card_equals_cpu(cuda):
    """20 × 20 × 2 plans to cls: the MI counts come from B2 per chunk."""
    ds = _wide(6000, 20, 20, seed=3)
    chunks = [ds.slice(s, s + 2000) for s in range(0, ds.num_rows, 2000)]
    before = hist.cooc_counts_cols.cls_launches
    got = mi.MutualInformation().fit(chunks)
    assert hist.cooc_counts_cols.cls_launches == before + len(chunks)
    want = mi.MutualInformation(device="cpu").fit(chunks)
    for name in ("class_counts", "feature_class_counts", "pair_class_counts"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))


def _same_tree(a: str, b: str) -> None:
    ja, jb = json.loads(a), json.loads(b)
    na, nb = ja.pop("nodes"), jb.pop("nodes")
    assert ja == jb and len(na) == len(nb)
    for x, y in zip(na, nb):
        sx, sy = x.pop("score"), y.pop("score")
        assert x == y and abs(sx - sy) <= 1e-6, (x, sx, sy)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(), dict(split_search="binary",
                                             hist_mode="subtract")])
def test_hospital_tree_on_the_card_equals_cpu(cuda, kw):
    enc = DatasetEncoder(FeatureSchema.from_json(HOSP_SCHEMA_JSON))
    ds = enc.fit_transform(generate_hosp_readmit(20000, seed=5))
    is_cat = [f.is_categorical for f in enc.binned_fields]
    before = hist.cross_cooc_counts_cols.launches
    trainer = tree.DecisionTree(max_depth=4, collect_phase_stats=True, **kw)
    got = trainer.fit(ds, is_cat)
    assert [s["path"] for s in trainer.level_stats] == \
        ["cross"] * len(trainer.level_stats)
    assert hist.cross_cooc_counts_cols.launches == \
        before + len(trainer.level_stats)
    want = tree.DecisionTree(max_depth=4, device="cpu", **kw).fit(ds, is_cat)
    _same_tree(got.to_string(), want.to_string())
    pred, _d, _cm, _c = trainer.predict(got, ds)
    cpu_pred, _d, _cm, _c = tree.DecisionTree(device="cpu").predict(want, ds)
    np.testing.assert_array_equal(pred, cpu_pred)


@pytest.mark.cuda
def test_wide_tree_packs_on_the_card_and_equals_cpu(cuda):
    """30 × 8 × 2: the frontiers K = 1, 2, 4, 8 pack onto jmaj (B1), cls
    (B2, twice) and clsb (B3)."""
    ds = _wide(20000, 30, 8, seed=4)
    names = ("launches", "cls_launches", "clsb_launches")
    before = [getattr(hist.cooc_counts_cols, k) for k in names]
    trainer = tree.DecisionTree(max_depth=4, split_search="binary",
                                collect_phase_stats=True)
    got = trainer.fit(ds)
    modes = [hist.pack_disjoint(s["contracted_slots"], 30, 8, 2).mode
             for s in trainer.level_stats]
    assert [s["path"] for s in trainer.level_stats] == ["packed"] * 4
    assert modes == ["jmaj", "cls", "cls", "clsb"]
    assert [getattr(hist.cooc_counts_cols, k) - v
            for k, v in zip(names, before)] == [1, 2, 1]
    want = tree.DecisionTree(max_depth=4, split_search="binary",
                             device="cpu").fit(ds)
    _same_tree(got.to_string(), want.to_string())


def _knn_operands(n, m, f, fc, nb, seed):
    """Packed query and reference operands (CPU) of seeded mixed data."""
    rng = np.random.default_rng(seed)
    codes_r = rng.integers(0, nb, size=(n, f)).astype(np.int32)
    cont_r = rng.random(size=(n, fc)).astype(np.float32)
    codes_q = rng.integers(0, nb, size=(m, f)).astype(np.int32)
    cont_q = rng.random(size=(m, fc)).astype(np.float32)
    r_mat, _ = tk.prepare_refs(codes_r, cont_r, nb)
    q_mat, _ = tk.prepare_queries(codes_q, cont_q, nb)
    return q_mat, r_mat


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,f,fc", [
    (40_000, 600, 6, 0),           # categorical only: exact integer d²
    (40_000, 600, 6, 8),           # the repo's kNN schema, mixed
    (8 * 2048 + 1, 512, 4, 3),     # a short last block
    (70_000, 1024, 0, 9),          # continuous only (the elearn shape)
    (40_000, 512, 80, 0),          # W 896: the query tile is streamed
])
def test_tourney_kernel_matches_plain_version(cuda, n, m, f, fc):
    q, r = _knn_operands(n, m, f, fc, 10, seed=n + f)
    before = tk.knn_tourney.launches
    got = tk.knn_tourney(q.to(cuda), r.to(cuda))
    assert tk.knn_tourney.launches == before + 1
    torch.cuda.synchronize()
    want = tk.knn_tourney_ref(q, r)
    seg_base = torch.arange(got[0].shape[1]) * tk.SEG
    for g, w in zip(got, want):
        g = g.cpu()
        assert g.dtype == torch.int32 and g.shape == w.shape
        if fc == 0:
            assert torch.equal(g, w)
            continue
        # both sum the same exact products in float32 in another order: a
        # d² moves by ~1e-6, which near zero spans several truncation steps
        # and may swap near-tied columns; a swapped column must name a
        # reference whose recomputed d² is its key's
        dg = (g & ~2047).view(torch.float32)
        dw = (w & ~2047).view(torch.float32)
        real = dw < 1e29
        tol = 1e-5 + torch.maximum(dg, dw) * 2.0 ** -12
        assert not bool((((dg - dw).abs() > tol) & real).any())
        assert float((g == w).float().mean()) > 0.95
        moved = ((g & 2047) != (w & 2047)) & real
        rows, segs = moved.nonzero(as_tuple=True)
        refs = seg_base[segs] + (g[rows, segs] & 2047)
        d2 = (q[rows].float() * r[refs].float()).sum(1)
        assert not bool(((d2 - dg[rows, segs]).abs() > tol[rows, segs]).any())


@pytest.mark.cuda
@pytest.mark.parametrize("n,f,fc", [
    (40_000, 5, 0),                # 56 used lanes: 64 of W 128 contracted
    (40_000, 0, 9),                # the elearn schema, continuous
    (40_000, 68, 0),               # W 768, B5's queries streamed: 704 contracted
])
def test_kernels_contract_only_the_used_lanes(cuda, n, f, fc):
    """B5 and B6 handed the schema's used lanes contract round_up(used, 64)
    columns of W: the skipped columns are zero in both operands, so the
    keys and lists are bit-equal to the whole width's (and, on categorical
    data, to the plain version over all W)."""
    q, r = _knn_operands(n, 512, f, fc, 10, seed=n + fc)
    used = tk.used_lanes(f, 10, fc)
    assert tk.contraction_width(q.shape[1], used) < q.shape[1]
    qc, rc = q.to(cuda), r.to(cuda)
    cut = tk.knn_tourney(qc, rc, used=used)
    whole = tk.knn_tourney(qc, rc)
    lists = tk.knn_topk(qc, rc[:16_384], 18, used=used)
    lists_whole = tk.knn_topk(qc, rc[:16_384], 18)
    torch.cuda.synchronize()
    for g, w in zip(cut, whole):
        assert torch.equal(g, w)
    for g, w in zip(lists, lists_whole):
        assert torch.equal(g, w)
    if fc == 0:
        for g, w in zip(cut, tk.knn_tourney_ref(q, r)):
            assert torch.equal(g.cpu(), w)
        for g, w in zip(lists, tk.knn_topk_ref(q, r[:16_384], 18)):
            assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_probes_run_and_return_finite_times(cuda):
    """Each probe function runs its variants on the card and returns a
    finite, positive time for each; the variants that compute the real
    function equal its plain version."""
    import math

    from avenir_tpu_torch import probes

    q, r = _knn_operands(20_000, 512, 4, 3, 10, seed=3)
    q, r = q.to(cuda), r.to(cuda)
    used = tk.used_lanes(4, 10, 3)
    ms = probes.knn_tourney_probe(q, r, used, iters=2)
    assert set(ms) == set(probes.TOURNEY_VARIANTS)
    for variant in ("full", "full_insert"):
        for g, w in zip(probes.knn_tourney_variant(q, r, variant, used),
                        tk.knn_tourney(q, r, used=used)):
            assert torch.equal(g, w)
    codes, labels = _data(5000, 30, 8, 2, seed=4)
    ct, lb = torch.from_numpy(codes).to(cuda), torch.from_numpy(labels).to(cuda)
    gms = probes.onehot_gram_probe(ct, lb, 8, 2, iters=2)
    assert set(gms) == {"full", "dotonly", "pair"}
    assert torch.equal(probes.onehot_gram(ct, lb, 8, 2),
                       hist.cooc_counts_cols_ref(ct, lb, 8, 2))
    x_rows, x_cols = probes.orient_operands(4096, 128, seed=5)
    oms = probes.orient_gram_probe(x_rows, x_cols, iters=2)
    want = torch._int_mm(x_cols, x_rows)
    assert torch.equal(probes.orient_gram(x_rows, True), want)
    assert torch.equal(probes.orient_gram(x_cols, False), want)
    for t in (*ms.values(), *gms.values(), *oms.values()):
        assert math.isfinite(t) and t > 0


@pytest.mark.cuda
def test_knn_wrappers_launch_nothing_on_empty_operands(cuda):
    q, r = _knn_operands(3000, 10, 4, 2, 10, seed=2)
    q, r = q.to(cuda), r.to(cuda)
    before = (tk.knn_tourney.launches, tk.knn_topk.launches)
    for got, want in ((tk.knn_topk(q[:0], r, 18), tk.knn_topk_ref(q[:0].cpu(), r.cpu(), 18)),
                      (tk.knn_topk(q, r[:0], 18), tk.knn_topk_ref(q.cpu(), r[:0].cpu(), 18)),
                      (tk.knn_tourney(q, r[:0]), tk.knn_tourney_ref(q.cpu(), r[:0].cpu()))):
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
    assert (tk.knn_tourney.launches, tk.knn_topk.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("n,f,fc,kk", [
    (16_384, 6, 0, 18), (16_384, 6, 8, 18), (16_384, 6, 8, 128),
    (12, 3, 2, 18),                # pads land in the slots
    (3000, 0, 9, 11),
    (16_384, 80, 0, 18),           # W 896, query tile resident
    (16_384, 268, 0, 18),          # W 2688: the query tile is streamed
])
def test_topk_kernel_matches_plain_version(cuda, n, f, fc, kk):
    q, r = _knn_operands(n, 1024, f, fc, 10, seed=n + kk)
    before = tk.knn_topk.launches
    d, i = tk.knn_topk(q.to(cuda), r.to(cuda), kk)
    assert tk.knn_topk.launches == before + 1
    torch.cuda.synchronize()
    d, i = d.cpu(), i.cpu()
    wd, wi = tk.knn_topk_ref(q, r, kk)
    assert torch.equal(i[:, kk:], wi[:, kk:]) and torch.equal(d[:, kk:], wd[:, kk:])
    if fc == 0:
        assert torch.equal(d, wd) and torch.equal(i, wi)
        return
    # order statistics move by at most the largest d² perturbation; the
    # kept sets may swap only members at the boundary
    assert float((d[:, :kk] - wd[:, :kk]).abs().max()) <= 1e-5
    for row in range(d.shape[0]):
        mine, theirs = i[row, :kk], wi[row, :kk]
        edge = float(wd[row, kk - 1])
        only_k = d[row, :kk][~torch.isin(mine, theirs)]
        only_p = wd[row, :kk][~torch.isin(theirs, mine)]
        for x in (only_k, only_p):
            assert x.numel() == 0 or float((x - edge).abs().max()) <= 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("f,fc,kk,splits", [
    (0, 9, 18, 1), (0, 9, 18, None),      # the 10K path's shape (elearn)
    (6, 0, 1, 1), (6, 0, 1, None),        # categorical: ties everywhere
    (6, 0, 128, 1), (6, 0, 128, None),
    (6, 8, 128, None), (268, 0, 18, None),   # mixed; W 2688, streamed
    (6, 0, 40, None), (6, 8, 70, 1),      # two and three list registers
    (268, 0, 128, 3),                     # streamed, four list registers
])
def test_topk_kernel_reference_split(cuda, f, fc, kk, splits):
    """B6 at m = 2,048 x n = 10,240 with one reference range (no merge) and
    with the wrapper's ranges (merged on the card): exactly the plain
    version on categorical data, to the float32 summation order
    elsewhere."""
    q, r = _knn_operands(10_240, 2048, f, fc, 10, seed=kk + f)
    assert q.shape[0] == 2048 and r.shape[0] == 10_240
    before = tk.knn_topk.launches
    d, i = tk.knn_topk(q.to(cuda), r.to(cuda), kk, splits=splits)
    assert tk.knn_topk.launches == before + 1
    torch.cuda.synchronize()
    d, i = d.cpu(), i.cpu()
    wd, wi = tk.knn_topk_ref(q, r, kk)
    assert torch.equal(i[:, kk:], wi[:, kk:]) and torch.equal(d[:, kk:], wd[:, kk:])
    if fc == 0:
        assert torch.equal(d, wd) and torch.equal(i, wi)
        return
    assert float((d[:, :kk] - wd[:, :kk]).abs().max()) <= 1e-5
    edge = wd[:, kk - 1:kk]
    only_k = ~(i[:, :kk, None] == wi[:, None, :kk]).any(2)
    only_p = ~(wi[:, :kk, None] == i[:, None, :kk]).any(2)
    assert float(((d[:, :kk] - edge).abs() * only_k).max()) <= 2e-5
    assert float(((wd[:, :kk] - edge).abs() * only_p).max()) <= 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("n,f,fc", [(3000, 6, 8), (70_000, 6, 8),
                                    (70_000, 6, 0), (3000, 4, 0)])
def test_search_on_the_card_equals_cpu(cuda, n, f, fc):
    """``search`` through B5 (n > 16,384) or B6 on cuda and through the
    plain versions on the CPU: rows certified on both devices agree to the
    bit, since the re-rank is exact and the tie rule fixes the order."""
    (d, i, c), (wd, wi, wc) = _search_on_both(cuda, n, f, fc)
    both = c & wc
    # categorical data through B5 certifies few rows: its ties hide in the
    # segments' thirds, and the exact scan serves those rows
    assert both.mean() > (0.05 if fc == 0 and n > tk.TB else 0.9)
    np.testing.assert_array_equal(d[both], wd[both])
    np.testing.assert_array_equal(i[both], wi[both])


@pytest.mark.cuda
@pytest.mark.parametrize("n,f,fc,certified", [
    (20_000, 80, 2, 0.3),          # B5 at W 896 (streamed); dense d² near
                                   # the k-th certify ~40% of rows
    (3000, 268, 2, 0.9),           # B6 at W 2816 (streamed)
])
def test_search_wide_operand_on_the_card_equals_cpu(cuda, n, f, fc, certified):
    """``search`` at widths whose query tile the kernels stream: certified
    rows agree to the bit between cuda and the CPU."""
    (d, i, c), (wd, wi, wc) = _search_on_both(cuda, n, f, fc)
    both = c & wc
    assert both.mean() > certified
    np.testing.assert_array_equal(d[both], wd[both])
    np.testing.assert_array_equal(i[both], wi[both])


def _search_on_both(cuda, n, f, fc):
    """``search`` of 700 seeded queries on cuda and on the CPU, checking
    the launches: ((d, i, cert) on cuda, the same on the CPU) as numpy."""
    rng = np.random.default_rng(n + fc)
    nb, k = 10, 10
    codes_r = rng.integers(0, nb, size=(n, f)).astype(np.int32)
    cont_r = rng.random(size=(n, fc)).astype(np.float32)
    codes_q = rng.integers(0, nb, size=(700, f)).astype(np.int32)
    cont_q = rng.random(size=(700, fc)).astype(np.float32)
    r_mat, n_real = tk.prepare_refs(codes_r, cont_r, nb)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        before = (tk.knn_tourney.launches, tk.knn_topk.launches)
        d, i, c = tk.search(torch.from_numpy(codes_q).to(dev),
                            torch.from_numpy(cont_q).to(dev), r_mat.to(dev),
                            torch.from_numpy(codes_r).to(dev),
                            torch.from_numpy(cont_r).to(dev), n_real, nb, k,
                            f + fc)
        after = (tk.knn_tourney.launches, tk.knn_topk.launches)
        if dev.type == "cuda":
            tourney = n > tk.TB
            assert after == (before[0] + tourney, before[1] + (not tourney))
        else:
            assert after == before
        out[dev.type] = (d.cpu().numpy(), i.cpu().numpy(), c.cpu().numpy())
    return out["cuda"], out["cpu"]


@pytest.mark.cuda
def test_knn_predict_on_the_card_equals_cpu(cuda):
    """KNN.predict on elearn (9 integer features, 20,000 references: B5)
    on cuda and on the CPU; rows served by the exact scan on either device
    may differ only where their distances agree within 1e-6."""
    from avenir_tpu_torch.datagen.elearn import ELEARN_SCHEMA_JSON, generate_elearn

    enc = DatasetEncoder(FeatureSchema.from_json(ELEARN_SCHEMA_JSON))
    ds = enc.fit_transform(generate_elearn(20_500, seed=9))
    train, test = ds.slice(0, 20_000), ds.slice(20_000, 20_500)
    res, fell = {}, {}
    for dev in ("cuda", "cpu"):
        est = mknn.KNN(k=10, kernel="gaussian", device=dev)
        before = tk.knn_tourney.launches
        res[dev] = est.predict(est.fit(train), test, validate=True)
        assert tk.knn_tourney.launches == before + (dev == "cuda")
        fell[dev] = set(mknn._nearest_neighbors_kernel.last_fallback.tolist())
    a, b = res["cuda"], res["cpu"]
    differ = np.flatnonzero((a.predicted != b.predicted)
                            | (a.neighbor_idx != b.neighbor_idx).any(axis=1))
    assert set(differ.tolist()) <= fell["cuda"] | fell["cpu"]
    np.testing.assert_allclose(a.neighbor_dist, b.neighbor_dist, atol=1e-6)
