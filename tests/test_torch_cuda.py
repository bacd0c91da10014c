"""The port's CUDA kernels on the card against their plain PyTorch
versions, exactly: the co-occurrence gram (``csrc/cooc.cu``, B1), the
per-class grams (``csrc/cooc_cls.cu``, B2/B3) and the cross counts
(``csrc/cross.cu``, B4).

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
from avenir_tpu_torch.models import mutual_info as mi  # noqa: E402
from avenir_tpu_torch.models import tree  # noqa: E402
from avenir_tpu_torch.ops import hist  # noqa: E402


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
    (3000, 6, 32, 1024),   # num_sel at the gate: several selector tiles
    (2000, 3, 100, 200),   # jcp 128
    (1000, 24, 32, 300),   # X side at the gate (wp 768)
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
