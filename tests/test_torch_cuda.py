"""The port's CUDA kernels on the card against their plain PyTorch
versions: the co-occurrence grams in every layout (the pair histogram of
``csrc/cooc_pair.cu``: B1 in fmaj/jmaj, B2/B3 per class) and the cross
counts (``csrc/cross.cu``, B4) exactly; the kNN candidate kernels
(``csrc/knn_tourney.cu``, B5, and ``csrc/knn_topk.cu``, B6) exactly where
every d² is an integer sum and to the float32 summation order elsewhere;
the certificate fallback's exact kernel (``csrc/knn_exact.cu``) to the
bit, and a forced fallback on ``cuda`` against the CPU; the CSV encode
kernel (``csrc/csv_encode.cu``) to the bit against its plain version and
the native encoder, and the CSV pipeline's chunks all on its route;
the kNN search on ``cuda`` against the CPU; B1 at one class and the
correlation job on ``cuda``, and a ``cuda`` snapshot resumed on the CPU;
the probe functions of
``avenir_tpu_torch.probes``; the device feeder's staging (its own stream,
pinned copies, the consumer's wait); the SharedScan on ``cuda``
against the CPU; RandomForest's B4 calls against the plain version and
its trees against the CPU forest; Viterbi (scan and assoc) and logistic
regression on ``cuda`` against the CPU; a one-device mesh's sharded
SharedScan on ``cuda`` against the CPU's fold; ``data.parallel.auto`` on
the cards (no mesh on one card; per-shard launches of MI, Cramér and the
tree on two or more); the five explicit model steps and the
time-sharded Viterbi on a one-device ``cuda`` mesh against a one-slot
CPU mesh, and the kNN, LR and Markov ``mesh=`` seams over two or more
cards against the CPU; the bandit selections,
``WordCount`` and NumericalAttrStats on ``cuda`` against the CPU (no
kernel of their own: plain torch ops on the card); a planned pipeline on
the kernel route against the staged run, and a ``KNNServable`` on
``cuda`` against the CPU and against its own rows scored alone; and two
processes on the one card, joined over a ``FileStore`` on gloo, summing
their B1 partials with ``all_process_sum_state`` to the CPU's gram.

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
@pytest.mark.parametrize("n,f,b,invalid,mode", [
    (20_000, 5, 6, False, "jmaj"),        # churn's feature pairs (wp 128)
    (20_000, 10, 13, False, "fmaj"),      # hospital's feature pairs (wp 384)
    (20_000, 30, 8, False, "jmaj"),       # jmaj, wp 256
    (100_003, 10, 13, True, "fmaj"),      # ragged, invalid codes and labels
    (100_003, 5, 6, True, "jmaj"),
])
def test_b1_at_one_class_matches_plain_version(cuda, n, f, b, invalid, mode):
    """B1 over the gram of ONE class, as the correlation jobs run it for
    feature pairs: every label 0, so each pair's lanes collapse onto the
    bin·1 + 0 column (invalid labels -1 and 1 drop their rows)."""
    codes, labels = _data(n, f, b, 1, seed=41)
    if not invalid:
        codes = np.clip(codes, 0, b - 1)
        labels[:] = 0
    assert hist.plan(f, b, 1)[0] == mode
    before = hist.cooc_counts_cols.launches
    g = hist.cooc_counts_cols(torch.from_numpy(codes).to(cuda),
                              torch.from_numpy(labels).to(cuda), b, 1)
    assert hist.cooc_counts_cols.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(g.cpu(), hist.cooc_counts_cols_ref(
        torch.from_numpy(codes), torch.from_numpy(labels), b, 1))


@pytest.mark.cuda
def test_correlation_on_the_card_equals_cpu_and_a_cuda_snapshot_resumes_on_the_cpu(
        cuda, tmp_path):
    """CramerCorrelation (B1 at C = 1) and MutualInformation on cuda give
    the CPU's part files; a MutualInformation run crashed on cuda (a G
    snapshot) resumes on the CPU (G converted to the agg route's tensors)
    to the same bytes."""
    from avenir_tpu_torch.core.config import JobConfig
    from avenir_tpu_torch.core.csv_io import write_csv
    from avenir_tpu_torch.datagen.churn import CHURN_SCHEMA_JSON, generate_churn
    from avenir_tpu_torch.jobs import get_job

    write_csv(str(tmp_path / "churn.csv"), generate_churn(3000, seed=2))
    (tmp_path / "churn.json").write_text(json.dumps(CHURN_SCHEMA_JSON))

    def run(job, out, dev, **extra):
        props = {"feature.schema.file.path": str(tmp_path / "churn.json"),
                 "stream.chunk.rows": "250", **extra}
        get_job(job).run(JobConfig(props), str(tmp_path / "churn.csv"),
                         str(tmp_path / out), device=dev)
        return (tmp_path / out / "part-00000").read_bytes()

    for job in ("CramerCorrelation", "MutualInformation"):
        before = hist.cooc_counts_cols.launches
        got = run(job, f"{job}_cuda", "cuda")
        assert hist.cooc_counts_cols.launches == before + 12
        assert got == run(job, f"{job}_cpu", "cpu")
    keys = {"stream.checkpoint.dir": str(tmp_path / "D"),
            "stream.checkpoint.interval.chunks": "1"}
    with pytest.raises(RuntimeError, match="injected crash after chunk 5"):
        run("MutualInformation", "crashed", "cuda",
            **{**keys, "stream.fault.crash.after.chunks": "5"})
    assert run("MutualInformation", "resumed", "cpu",
               **{**keys, "stream.resume": "true"}) == \
        (tmp_path / "MutualInformation_cpu" / "part-00000").read_bytes()
    assert not (tmp_path / "D").exists()


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


@pytest.mark.cuda
def test_one_device_mesh_fold_on_the_card_equals_its_plain_version(cuda):
    """``shard.devices=all`` on the card: a mesh of the cards this process
    sees (one on one H100); each 1,500-row chunk is padded to its 2,048-row
    target, staged on its device and folded by B1 there, one launch a
    chunk per shard, into the tables of the CPU's unsharded fold (B1's
    plain version), under the ``:mesh:data<n>`` key; more devices than
    the cards are refused."""
    from avenir_tpu_torch.core.config import ConfigError, JobConfig
    from avenir_tpu_torch.ops import agg
    from avenir_tpu_torch.parallel.shard import ShardSpec
    from avenir_tpu_torch.pipeline import scan

    enc = DatasetEncoder(FeatureSchema.from_json(HOSP_SCHEMA_JSON))
    ds = enc.fit_transform(generate_hosp_readmit(5000, seed=9))
    n_cards = torch.cuda.device_count()
    spec = ShardSpec.from_conf(JobConfig({"shard.devices": "all"}), "cuda")
    assert spec.num_devices == n_cards
    assert spec.g_suffix == f":mesh:data{n_cards}"
    staged = spec.stage(ds.slice(0, 1500))
    assert staged.valid_rows == 1500 and staged.num_rows == 2048

    def run(device, shard):
        eng = scan.SharedScan(device=device, shard=shard)
        eng.register(scan.NaiveBayesConsumer(name="nb"))
        eng.register(scan.MutualInfoConsumer(name="mi"))
        return eng.run(iter([ds.slice(i, min(i + 1500, ds.num_rows))
                             for i in range(0, ds.num_rows, 1500)]))

    hist.cooc_counts_cols.launches = 0
    got = run("cuda", spec)
    assert hist.cooc_counts_cols.launches == 4 * n_cards
    want = run("cpu", None)
    for name in ("bin_counts", "class_counts"):
        np.testing.assert_array_equal(getattr(got["nb"], name),
                                      getattr(want["nb"], name))
    np.testing.assert_array_equal(got["mi"].pair_class_counts,
                                  want["mi"].pair_class_counts)
    assert got["mi"].to_lines() == want["mi"].to_lines()
    folder = scan.ChunkFolder([scan.NaiveBayesConsumer()], ds, "cuda",
                              shard=spec)
    acc = agg.Accumulator()
    folder.fold(ds.slice(0, 100), acc)
    assert folder.gk == hist.g_key(10, 13, 2) + spec.g_suffix
    assert folder.gk in acc
    with pytest.raises(ConfigError, match=r"device\(s\) attached \(cuda\)"):
        ShardSpec.from_conf(JobConfig({"shard.devices": str(n_cards + 1)}),
                            "cuda")


@pytest.mark.cuda
def test_auto_mesh_on_the_cards(cuda):
    """``data.parallel.auto`` on the card: a mesh of every card when there
    are two or more, none on one card (one H100 runs the jobs unsharded)
    and none with the key off."""
    from avenir_tpu_torch.core.config import JobConfig
    from avenir_tpu_torch.jobs.base import auto_mesh

    n_cards = torch.cuda.device_count()
    mesh = auto_mesh(JobConfig({}), "cuda")
    if n_cards < 2:
        assert mesh is None
    else:
        assert mesh.sizes == {"data": n_cards}
        assert all(d.type == "cuda" for d in mesh.devices)
    assert auto_mesh(JobConfig({"data.parallel.auto": "false"}),
                     "cuda") is None


@pytest.mark.cuda
def test_auto_mesh_routes_launch_per_shard(cuda):
    """Over a mesh of two or more cards MI (the ``sharded`` route), the
    correlation jobs (the einsum keys, each shard's tables from its B1
    gram) and the tree (B4 a shard a level) launch their kernels once per
    shard and equal their plain versions on the CPU."""
    from avenir_tpu_torch.core.config import JobConfig
    from avenir_tpu_torch.jobs.base import auto_mesh
    from avenir_tpu_torch.models import correlation as corr
    from avenir_tpu_torch.ops import agg

    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        pytest.skip("needs two or more cards for a data mesh")
    mesh = auto_mesh(JobConfig({}), "cuda")
    enc = DatasetEncoder(FeatureSchema.from_json(HOSP_SCHEMA_JSON))
    ds = enc.fit_transform(generate_hosp_readmit(5000, seed=9))
    chunks = lambda: [ds.slice(i, min(i + 1500, ds.num_rows))  # noqa: E731
                      for i in range(0, ds.num_rows, 1500)]
    hist.cooc_counts_cols.launches = 0
    acc = agg.Accumulator()
    got = mi.MutualInformation(mesh=mesh, device="cuda").fit(
        chunks(), accumulator=acc)
    assert hist.cooc_counts_cols.launches == 4 * n_cards
    assert sorted(acc.names()) == ["class", hist.g_key(10, 13, 2)]
    want = mi.MutualInformation(device="cpu").fit(chunks())
    np.testing.assert_array_equal(got.pair_class_counts,
                                  want.pair_class_counts)
    for against in (False, True):
        hist.cooc_counts_cols.launches = 0
        got = corr.CramerCorrelation(mesh=mesh, device="cuda").fit(
            chunks(), against_class=against)
        assert hist.cooc_counts_cols.launches == 4 * n_cards
        want = corr.CramerCorrelation(device="cpu").fit(
            chunks(), against_class=against)
        np.testing.assert_array_equal(got.contingency, want.contingency)
    hist.cross_cooc_counts_cols.launches = 0
    sharded = tree.DecisionTree(max_depth=3, mesh=mesh, device="cuda",
                                collect_phase_stats=True)
    got = sharded.fit(ds)
    levels = len(sharded.level_stats)
    assert {st["path"] for st in sharded.level_stats} == {"cross"}
    assert hist.cross_cooc_counts_cols.launches == levels * n_cards
    assert got.to_string() == tree.DecisionTree(
        max_depth=3, device="cpu").fit(ds).to_string()


def _one_slot(device):
    from avenir_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(("data",), devices=[torch.device(device)])


def _step_inputs(seed):
    rng = np.random.default_rng(seed)
    n, f, fc, c, b = 4099, 6, 3, 3, 7
    return (rng.integers(-1, b, size=(n, f)).astype(np.int32),
            rng.integers(-1, c, size=n).astype(np.int32),
            rng.normal(size=(n, fc)).astype(np.float32), c, b)


@pytest.mark.cuda
@pytest.mark.parametrize("step", ["nb", "nb_2d", "mi", "knn", "lr",
                                  "viterbi_time"])
def test_model_steps_on_a_one_device_card_mesh_equal_cpu(cuda, step):
    """Each explicit step of ``parallel/collectives.py`` and
    ``viterbi_time_sharded`` on a one-device ``cuda`` mesh against the same
    step on a one-slot CPU mesh: counts exactly, the float64 moments
    within 1e-12, the LR step within relative 1e-6, kNN distances within
    1e-6 and indices equal (tie-free data), Viterbi paths equal (float32
    adds and maxima only) and their score within 1e-3 of the sequential
    decoder's."""
    from avenir_tpu_torch.models import markov as mk
    from avenir_tpu_torch.parallel import collectives as coll
    from avenir_tpu_torch.parallel.mesh import make_mesh

    codes, labels, cont, c, b = _step_inputs(3)
    out = {}
    for dev in ("cuda", "cpu"):
        one = _one_slot(dev)
        grid = make_mesh(("data", "model"), shape=(1, 1),
                         devices=[torch.device(dev)])
        if step == "nb":
            got = coll.sharded_nb_fit_step(one, c, b, 3)(codes, labels, cont)
        elif step == "nb_2d":
            fbc, cc = coll.sharded_nb_fit_step_2d(grid, c, b)(codes, labels)
            assert [p.device.type for p in fbc.parts] == [dev]
            got = (*fbc.parts, cc)
        elif step == "mi":
            pabc, fbc, cc = coll.sharded_mi_step(grid, c, b)(
                codes, labels, [0, 1, 2], [3, 4, 5])
            got = (*pabc.parts, fbc, cc)
        elif step == "knn":
            got = coll.sharded_knn_topk(one, 10, b, ref_tile=1024)(
                codes[:64], cont[:64], codes[64:], cont[64:],
                cont.min(0), cont.max(0), len(codes) - 64)
        elif step == "lr":
            w = np.linspace(-0.5, 0.5, 3, dtype=np.float32)
            got = (coll.sharded_lr_step(one)(
                w, cont, (labels > 0).astype(np.float32), len(cont), 0.5,
                0.01),)
        else:
            rng = np.random.default_rng(1)
            la, lb, lpi = (torch.from_numpy(np.log(m).astype(np.float32))
                           for m in (rng.dirichlet(np.ones(5), size=5),
                                     rng.dirichlet(np.ones(b), size=5),
                                     rng.dirichlet(np.ones(5))))
            obs = np.maximum(codes[:2048, 0], 0)
            got = (torch.from_numpy(mk.viterbi_time_sharded(
                la, lb, lpi, obs, one)),)
            seq = mk._viterbi_batch(la, lb, lpi,
                                    torch.from_numpy(obs)[None].long())[0]

            def score(path):
                path = path.long()
                return float(lpi[path[0]] + lb[path[0], obs[0]]
                             + (la[path[:-1], path[1:]]
                                + lb[path[1:], obs[1:]]).double().sum())

            # this flat random HMM has tied best paths: the regrouped
            # max-plus may pick another one of equal score
            assert abs(score(got[0]) - score(seq)) <= 1e-3
        assert all(t.device.type == dev for t in got
                   if isinstance(t, torch.Tensor) and step != "viterbi_time")
        out[dev] = [t.cpu() for t in got]
    for g, w in zip(out["cuda"], out["cpu"]):
        if g.dtype == torch.float64:
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-12)
        elif step == "lr":
            assert (g - w).abs().max() <= 1e-6 * w.abs().max()
        elif g.dtype == torch.float32:
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-6)
        else:
            assert torch.equal(g, w)


@pytest.mark.cuda
def test_model_mesh_seams_over_two_cards_equal_cpu(cuda, tmp_path):
    """Over a mesh of two or more cards: the kNN sharded route (a scan a
    card), the LR fit, the Markov counts and the record-sharded Viterbi
    against the unsharded CPU runs."""
    from avenir_tpu_torch.core.config import JobConfig
    from avenir_tpu_torch.jobs.base import auto_mesh
    from avenir_tpu_torch.models import logistic as mlr
    from avenir_tpu_torch.models import markov as mk

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more cards for a data mesh")
    mesh = auto_mesh(JobConfig({}), "cuda")
    rng = np.random.default_rng(8)
    ds = lambda n: EncodedDataset(  # noqa: E731
        codes=rng.integers(0, 8, size=(n, 4)).astype(np.int32),
        cont=rng.normal(size=(n, 5)).astype(np.float32),
        labels=rng.integers(0, 2, size=n).astype(np.int32),
        n_bins=np.full(4, 8, np.int32), class_values=["a", "b"])
    train, test = ds(20_000), ds(300)
    model = mknn.fit_knn(train)
    tk.knn_tourney.launches = tk.knn_topk.launches = 0
    d, i = mknn.nearest_neighbors(model, test, 10, device="cuda", mesh=mesh)
    assert tk.knn_tourney.launches == tk.knn_topk.launches == 0
    wd, wi = mknn.nearest_neighbors(model, test, 10, device="cpu")
    np.testing.assert_array_equal(i, wi)
    np.testing.assert_allclose(d, wd, atol=1e-6)
    x, y = train.cont, train.labels.astype(np.float32)
    got = mlr.LogisticRegression(max_iterations=15, mesh=mesh,
                                 device="cuda").fit(x, y)
    want = mlr.LogisticRegression(max_iterations=15, device="cpu").fit(x, y)
    assert got.iterations == want.iterations
    for g, w in zip(got.history, want.history):
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max()
    seqs = [[f"s{v}" for v in rng.integers(0, 4, size=12)]
            for _ in range(501)]
    chain, _ = mk.MarkovChain(mesh=mesh, device="cuda").fit(seqs)
    assert chain.to_lines() == mk.MarkovChain(device="cpu").fit(
        seqs)[0].to_lines()
    hmm = mk.HMMModel(["x", "y", "z"], [str(v) for v in range(4)],
                      rng.dirichlet(np.ones(3), size=3),
                      rng.dirichlet(np.ones(4), size=3),
                      rng.dirichlet(np.ones(3)))
    obs = rng.integers(-1, 4, size=(37, 20)).astype(np.int32)
    np.testing.assert_array_equal(
        mk.ViterbiDecoder(hmm, mesh=mesh, device="cuda").decode_codes(obs),
        mk.ViterbiDecoder(hmm, device="cpu").decode_codes(obs))


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
    # segments' thirds, and the exact kernel serves those rows
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
    on cuda and on the CPU; rows served by the exact kernel on either device
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


@pytest.mark.cuda
@pytest.mark.parametrize("n,r,f,fc,k", [
    (1_000_000, 3, 0, 9, 10),      # the elearn fallback: ranges merged
    (40_000, 37, 6, 8, 127),       # mixed, four list registers
    (40_000, 64, 6, 0, 1),         # categorical: ties everywhere
    (3000, 4096, 0, 9, 10),        # many rows: one range, no merge
    (300, 5, 2, 3, 40),            # one short range, two list registers
])
def test_exact_kernel_matches_plain_version(cuda, n, r, f, fc, k):
    """``knn_exact`` on the card bit-equal to its plain version, the query
    rows handed as the fallback hands them (strided views of one int32
    upload), the references tiled four times so that d² ties."""
    rng = np.random.default_rng(n + r + k)
    base = -(-n // 4)
    codes_r = np.tile(rng.integers(0, 5, size=(base, f)).astype(np.int32),
                      (4, 1))[:n]
    cont_r = np.tile(rng.random(size=(base, fc)).astype(np.float32), (4, 1))[:n]
    codes_q = rng.integers(0, 5, size=(r, f)).astype(np.int32)
    cont_q = rng.random(size=(r, fc)).astype(np.float32)
    rows = torch.from_numpy(np.concatenate([codes_q, cont_q.view(np.int32)],
                                           axis=1)).to(cuda)
    cr, xr = torch.from_numpy(codes_r).to(cuda), torch.from_numpy(cont_r).to(cuda)
    before = tk.knn_exact.launches
    d2, idx = tk.knn_exact(rows[:, :f], rows[:, f:].view(torch.float32), cr,
                           xr, k)
    assert tk.knn_exact.launches == before + 1
    torch.cuda.synchronize()
    wd, wi = tk.knn_exact_ref(torch.from_numpy(codes_q),
                              torch.from_numpy(cont_q),
                              torch.from_numpy(codes_r),
                              torch.from_numpy(cont_r), k)
    assert torch.equal(idx.cpu(), wi)
    assert torch.equal(d2.cpu().view(torch.int32), wd.view(torch.int32))


@pytest.mark.cuda
def test_forced_fallback_on_the_card_equals_cpu(cuda, monkeypatch):
    """Every other row's certificate forced to fail: the exact kernel on
    cuda and its plain version on the CPU serve those rows, and the
    predictions equal to the bit on both devices."""
    from avenir_tpu_torch.datagen.elearn import ELEARN_SCHEMA_JSON, generate_elearn

    enc = DatasetEncoder(FeatureSchema.from_json(ELEARN_SCHEMA_JSON))
    ds = enc.fit_transform(generate_elearn(20_500, seed=10))
    train, test = ds.slice(0, 20_000), ds.slice(20_000, 20_500)
    search = tk.search

    def failing(*args, **kwargs):
        d, idx, cert = search(*args, **kwargs)
        cert = cert.clone()
        cert[::2] = False
        return d, idx, cert

    monkeypatch.setattr(tk, "search", failing)
    res = {}
    for dev in ("cuda", "cpu"):
        est = mknn.KNN(k=10, device=dev)
        before = tk.knn_exact.launches
        res[dev] = est.predict(est.fit(train), test, validate=True)
        assert tk.knn_exact.launches == before + (dev == "cuda")
        assert len(mknn._nearest_neighbors_kernel.last_fallback) >= 250
    a, b = res["cuda"], res["cpu"]
    np.testing.assert_array_equal(a.neighbor_idx, b.neighbor_idx)
    np.testing.assert_array_equal(a.neighbor_dist, b.neighbor_dist)
    np.testing.assert_array_equal(a.predicted, b.predicted)


@pytest.mark.cuda
def test_random_forest_b4_inputs_match_plain_version_and_cpu(cuda):
    """RandomForest on 20,000 hospital rows: every level table of every
    bagged tree goes through B4, each call held exactly against the plain
    version on its own inputs; the trees equal the CPU forest's (the tree
    contract) and the votes agree within 1e-6."""
    enc = DatasetEncoder(FeatureSchema.from_json(HOSP_SCHEMA_JSON))
    ds = enc.fit_transform(generate_hosp_readmit(20000, seed=5))
    is_cat = [f.is_categorical for f in enc.binned_fields]
    calls = []
    real = hist.cross_cooc_counts_cols

    def spy(*args):
        calls.append(args)
        return real(*args)

    spy.launches = real.launches
    hist.cross_cooc_counts_cols = spy
    try:
        forest = tree.RandomForest(num_trees=3, seed=1, max_depth=4)
        got = forest.fit(ds, is_cat)
    finally:
        hist.cross_cooc_counts_cols = real
    assert calls
    for codes, sel, b, s in calls:
        assert torch.equal(real(codes, sel, b, s).cpu(),
                           hist.cross_cooc_counts_cols_ref(codes.cpu(),
                                                           sel.cpu(), b, s))
    cpu = tree.RandomForest(num_trees=3, seed=1, max_depth=4, device="cpu")
    want = cpu.fit(ds, is_cat)
    for g, w in zip(got, want):
        _same_tree(g.to_string(), w.to_string())
    np.testing.assert_allclose(forest.predict(got, ds)[1],
                               cpu.predict(want, ds)[1], rtol=0, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["scan", "assoc"])
def test_viterbi_on_the_card_equals_cpu(cuda, method):
    from avenir_tpu_torch.datagen import hmm_seq
    from avenir_tpu_torch.models import markov as mk

    a, b, pi = hmm_seq.planted_hmm(6, 12, seed=2)
    states, obs = hmm_seq.sample_hmm(a, b, pi, 3000, 20, 210, seed=5)
    model = mk.HMMModel([f"s{i}" for i in range(6)],
                        [f"o{i}" for i in range(12)], a, b, pi)
    rows = 3000 if method == "scan" else 300
    got = mk.ViterbiDecoder(model, method=method).decode_codes(obs[:rows])
    want = mk.ViterbiDecoder(model, device="cpu").decode_codes(obs[:rows])
    np.testing.assert_array_equal(got, want)
    assert (got == states[:rows]).mean() > 0.6


@pytest.mark.cuda
def test_logistic_regression_on_the_card_equals_cpu(cuda):
    """float32 fit and float64 chunked fit on cuda against the CPU: each
    iteration within 1e-5 of its largest coefficient, equal iterations and
    status (TF32 is held off while a step runs)."""
    from avenir_tpu_torch.models import logistic as mlr

    enc = DatasetEncoder(FeatureSchema.from_json(HOSP_SCHEMA_JSON))
    ds = enc.fit_transform(generate_hosp_readmit(50000, seed=3))
    x = mlr.design_matrix(ds, device="cpu").numpy()
    y = ds.labels.astype(np.float32)
    chunks = [(i, x[s:s + 12000], y[s:s + 12000])
              for i, s in enumerate(range(0, len(y), 12000))]
    for how in ("fit", "fit_chunked"):
        res = {}
        for dev in ("cuda", "cpu"):
            est = mlr.LogisticRegression(learning_rate=1.0, device=dev)
            res[dev] = (est.fit(x, y) if how == "fit"
                        else est.fit_chunked(chunks))
        g, w = res["cuda"], res["cpu"]
        assert (g.iterations, g.converged) == (w.iterations, w.converged)
        for gr, wr in zip(g.history, w.history):
            assert np.abs(gr - wr).max() <= 1e-5 * np.abs(wr).max()


@pytest.mark.cuda
@pytest.mark.parametrize("name,kwargs", [
    ("greedyRandomLinear", {"epsilon": 0.5}), ("auerGreedy", {}),
    ("auerDeterministic", {}), ("softMax", {"tau": 0.1}),
    ("randomFirstGreedy", {})])
def test_bandit_selection_on_the_card_equals_cpu(cuda, name, kwargs):
    """Ragged groups and untried arms at 200K groups × 12 arms: the same
    host draws and correctly rounded device arithmetic select the same
    arms on cuda and the CPU."""
    from avenir_tpu_torch.models import bandits
    from avenir_tpu_torch.utils import prng

    rng = np.random.default_rng(4)
    g, k = 200_000, 12
    counts = rng.integers(1, 50, (g, k)).astype(np.float64)
    counts[rng.random((g, k)) < 0.05] = 0
    valid = np.arange(k)[None, :] < rng.integers(2, k + 1, g)[:, None]
    counts[~valid] = 0
    rewards = np.where(counts > 0, rng.random((g, k)) * 100.0, 0.0)
    for rnd in (1, 30):
        got, want = (bandits.ALGORITHM_REGISTRY[name](device=dev, **kwargs)
                     .select(prng.prng_key(rnd), counts, rewards, valid, rnd)
                     for dev in ("cuda", "cpu"))
        np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_wordcount_on_the_card_equals_cpu(cuda):
    from avenir_tpu_torch.text import WordCount

    rng = np.random.default_rng(2)
    vocab = [f"w{i}ing" for i in range(5000)]
    lines = [" ".join(vocab[r] for r in np.minimum(rng.zipf(1.2, 12), 5000) - 1)
             for _ in range(20000)]
    counters = [WordCount(stem=True, device=dev) for dev in ("cuda", "cpu")]
    for wc in counters:
        for lo in range(0, 20000, 6000):
            wc.add_lines(lines[lo:lo + 6000])
    assert counters[0].vocab == counters[1].vocab
    np.testing.assert_array_equal(counters[0].counts, counters[1].counts)
    assert counters[0].counts.sum() == 240000


@pytest.mark.cuda
def test_numerical_attr_stats_on_the_card_equals_cpu(cuda, tmp_path):
    """Whole and streamed, conditioned: count, min and max equal, the
    float64 moments within rtol 1e-12 of the CPU's."""
    from avenir_tpu_torch.core.config import JobConfig
    from avenir_tpu_torch.jobs import get_job

    rng = np.random.default_rng(6)
    rows = [f"{rng.normal(1e4, 3.0):.4f},{'xyz'[rng.integers(0, 3)]},"
            f"{rng.normal(-2.0, 0.5):.6f}" for _ in range(30000)]
    (tmp_path / "d.txt").write_text("\n".join(rows) + "\n")
    for extra in ({}, {"stream.chunk.rows": "7000"}):
        files = {}
        for dev in ("cuda", "cpu"):
            conf = JobConfig({"attr.list": "0,2", "cond.attr.ord": "1", **extra})
            out = tmp_path / f"{dev}{len(extra)}"
            get_job("NumericalAttrStats").run(conf, str(tmp_path / "d.txt"),
                                              str(out), device=dev)
            files[dev] = (out / "part-00000").read_text().splitlines()
        assert len(files["cuda"]) == len(files["cpu"]) == 6
        for a, b in zip(files["cuda"], files["cpu"]):
            fa, fb = a.split(","), b.split(",")
            assert fa[:3] == fb[:3] and fa[-2:] == fb[-2:]
            np.testing.assert_allclose([float(v) for v in fa[3:-2]],
                                       [float(v) for v in fb[3:-2]], rtol=1e-12)


@pytest.mark.cuda
def test_planned_pipeline_on_the_card_equals_staged(cuda, tmp_path):
    """``plan.on`` on cuda: NB | a non-fusable stage | MI | Cramér (whose
    ``uses`` edge names the NB model) becomes one scan unit on the kernel
    route (B1 once a chunk, no pack question), and its part files equal
    the staged run's on cuda and the planned run's on the CPU."""
    from avenir_tpu_torch.core.config import JobConfig
    from avenir_tpu_torch.core.csv_io import write_csv
    from avenir_tpu_torch.pipeline import plan as plan_mod
    from avenir_tpu_torch.pipeline.driver import Pipeline, Stage
    from avenir_tpu_torch.utils.metrics import Counters

    write_csv(str(tmp_path / "train.csv"), generate_hosp_readmit(60_000,
                                                                 seed=4))
    (tmp_path / "hosp.json").write_text(json.dumps(HOSP_SCHEMA_JSON))

    def marker(conf, in_path, out_path):
        import pathlib

        pathlib.Path(out_path).mkdir(parents=True, exist_ok=True)
        pathlib.Path(out_path, "part-00000").write_text("marker\n")
        return Counters()

    def build(ws, dev, plan_on):
        p = Pipeline(str(tmp_path / ws), JobConfig({
            "feature.schema.file.path": str(tmp_path / "hosp.json"),
            "stream.chunk.rows": "20000", "plan.on": plan_on}), device=dev)
        p.add(Stage("nb", "BayesianDistribution", "data", "nb_model"))
        p.add(Stage("marker", marker, "data", "marker_out"))
        p.add(Stage("mi", "MutualInformation", "data", "mi_out"))
        p.add(Stage("cramer", "CramerCorrelation", "data", "cramer_out",
                    props={"dest.attributes": "11"}, uses=("nb_model",)))
        p.bind("data", str(tmp_path / "train.csv"))
        return p

    launches, parts = {}, {}
    for ws, dev, plan_on in (("staged", "cuda", "false"),
                             ("planned", "cuda", "true"),
                             ("planned_cpu", "cpu", "true")):
        p = build(ws, dev, plan_on)
        if ws == "planned":
            unit = plan_mod.plan_pipeline(p).scan_units[0]
            assert unit.program == "kernel" and unit.pack_source == "aot"
            assert unit.rewrites == ["fuse", "share-gram"]
            assert unit.pack_on is None
        hist.cooc_counts_cols.launches = 0
        p.run()
        launches[ws] = hist.cooc_counts_cols.launches
        parts[ws] = {a: (tmp_path / ws / a / "part-00000").read_bytes()
                     for a in ("nb_model", "mi_out", "cramer_out")}
    assert launches == {"staged": 3, "planned": 3, "planned_cpu": 0}
    assert parts["planned"] == parts["staged"] == parts["planned_cpu"]


@pytest.mark.cuda
def test_knn_servable_on_the_card_equals_cpu_and_its_bucket(cuda, tmp_path):
    """``KNNServable`` on cuda over 20,000 elearn references (B5, one
    launch per dispatch): a row scored alone and in a full bucket of 64
    gives the same bytes, and the responses equal the CPU servable's but
    for rows the exact kernel served on either device."""
    from avenir_tpu_torch.core.config import JobConfig
    from avenir_tpu_torch.core.csv_io import write_csv
    from avenir_tpu_torch.datagen.elearn import ELEARN_SCHEMA_JSON, generate_elearn
    from avenir_tpu_torch.serving.registry import KNNServable

    rows = generate_elearn(20_064, seed=9)
    write_csv(str(tmp_path / "train.csv"), rows[:20_000])
    (tmp_path / "elearn.json").write_text(json.dumps(ELEARN_SCHEMA_JSON))
    lines = [",".join(str(v) for v in r) for r in rows[20_000:]]
    conf = JobConfig({"feature.schema.file.path": str(tmp_path / "elearn.json"),
                      "training.data.path": str(tmp_path / "train.csv"),
                      "top.match.count": "10", "kernel.function": "gaussian"})
    out, fell = {}, {}
    for dev in ("cuda", "cpu"):
        entry = KNNServable.from_conf(conf, device=dev)
        tk.knn_tourney.launches = 0
        full = entry.score_lines(lines, 64)
        fell[dev] = set(mknn._nearest_neighbors_kernel.last_fallback.tolist())
        assert tk.knn_tourney.launches == (dev == "cuda")
        if dev == "cuda":
            alone = [entry.score_lines([ln], 1)[0] for ln in lines[:16]]
            assert alone == full[:16]
            assert tk.knn_tourney.launches == 17
        out[dev] = full
    differ = {i for i, (a, b) in enumerate(zip(out["cuda"], out["cpu"]))
              if a != b}
    assert differ <= fell["cuda"] | fell["cpu"]


@pytest.mark.cuda
def test_fleet_sum_of_card_partials_equals_cpu(cuda, tmp_path):
    """Two processes on the one card, joined through a FileStore on gloo:
    each counts its half of the rows with B1 on ``cuda``, and
    ``all_process_sum_state`` sums the int64 partials on the host; every
    rank's total equals the CPU's gram over all rows, exactly."""
    import os
    import subprocess
    import sys

    from avenir_tpu_torch.ops import hist as thist

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from torch_fleet_worker import gram_rows

    (tmp_path / "specs.json").write_text(json.dumps([{"gram": "cuda"}]))
    env = dict(os.environ, PYTHONPATH=os.path.dirname(here))
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(here, "torch_fleet_worker.py"),
         str(tmp_path / "store"), str(r), "2", str(tmp_path), "specs.json"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], "".join(outs)[-3000:]
    codes, labels = gram_rows()
    want = thist.cooc_counts(torch.from_numpy(codes),
                             torch.from_numpy(labels), 13, 2).numpy()
    for r in range(2):
        got = np.load(tmp_path / f"gram_p{r}.npz")["g"]
        np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.cuda
def test_chip_peaks_name_the_cards_row(cuda):
    """The attached card's peaks come from its own table row."""
    from avenir_tpu_torch.utils import roofline

    name = torch.cuda.get_device_name(0)
    key = roofline._lookup_row(name)
    assert key is not None, f"no peaks row for {name!r}"
    assert roofline.chip_peaks() == {"device_kind": name,
                                     **roofline._PEAKS[key],
                                     "source": f"table:{key}"}


@pytest.mark.cuda
def test_canaries_on_the_card_within_the_bf16_peak(cuda):
    """The matmul canary reads a positive time that implies at most 105%
    of the card's bf16 peak; its step on the card (cuBLAS, float32 out)
    equals the CPU step within float32 summation order; the kNN dot
    canary takes references already on the card."""
    from avenir_tpu_torch.utils import roofline, rig_canary

    peak = roofline.chip_peaks()["bf16_flops"]
    ms = rig_canary.matmul_canary_ms()
    assert ms > 0
    assert 2.0 * rig_canary.MATMUL_DIM ** 3 / (ms / 1e3) <= 1.05 * peak
    a = torch.randn(512, 512, generator=torch.Generator().manual_seed(3)
                    ).to(torch.bfloat16)
    got = rig_canary.dot_f32(a.to(cuda), a.to(cuda))
    assert got.dtype == torch.float32
    want = rig_canary.dot_f32(a, a)
    assert float((got.cpu() - want).abs().max()) <= 1e-5 * float(
        want.abs().max())
    refs = torch.randn(2 * rig_canary.KNN_TILE + 5, 128,
                       device=cuda).to(torch.bfloat16)
    ms = rig_canary.knn_dot_canary_ms(refs=refs, reps=2)
    assert ms > 0
    flops = 2.0 * 16384 * 2 * rig_canary.KNN_TILE * 128
    assert flops / (ms / 1e3) <= 1.05 * peak


def _csv_part(path, rows, tail=()):
    """Generated rows, a blank line and ``tail`` lines, as CSV."""
    text = "\n".join(",".join(map(str, r)) for r in rows) + "\n\n"
    path.write_bytes((text + "".join(t + "\n" for t in tail)).encode())
    return str(path)


HOSP_ROW = "P1,31,164,67,retired,with partner,poor,low,high,non smoker,low,N"
ELEARN_ROW = "1038273,334,12,66,3,90,71,154,15,16,P"
# per case: schema, generator, rows generated, fields a row, labels read,
# and the odd parts (lines a fast path takes, under "taken", or refuses)
CSV_CASES = {
    "hospital": ("hosp", generate_hosp_readmit, 1_000_000, 12, True, {
        "taken": [HOSP_ROW.replace(",31,", ",-31.5,"),
                  HOSP_ROW.replace(",164,", ",+999999999999999,"),
                  HOSP_ROW.replace("retired", "student"),
                  HOSP_ROW.replace(",67,", ",-.25,") + "\r"],
        "exponent": [HOSP_ROW.replace(",31,", ",3e1,")],
        "digits": [HOSP_ROW.replace(",31,", ",0000000000000031,")],
        "ragged": [HOSP_ROW + ",x"],
        "label": [HOSP_ROW[:-1] + "maybe"],
        "space": [HOSP_ROW.replace(",31,", ", 31,")]}),
    "hospital_unlabelled": ("hosp", generate_hosp_readmit, 200_000, 12,
                            False, {
        "taken": [HOSP_ROW[:-1] + "maybe", HOSP_ROW.replace(",31,", ",-0,")],
        "ragged": [HOSP_ROW + ",x"]}),
    "elearn": ("elearn", None, 1_000_000, 11, True, {
        "taken": [ELEARN_ROW.replace(",334,", ",-0.1,"),
                  ELEARN_ROW.replace(",12,", ",16777217,"),
                  ELEARN_ROW.replace(",66,", ",123456789012345,"),
                  ELEARN_ROW.replace(",3,", ",-0,"),
                  ELEARN_ROW.replace(",90,", ",.3333333,") + "\r"],
        "exponent": [ELEARN_ROW.replace(",334,", ",1e3,")],
        "empty": [ELEARN_ROW.replace(",334,", ",,")]}),
    "mixed": ("mixed", generate_hosp_readmit, 200_000, 12, True, {
        "taken": [HOSP_ROW.replace(",31,", ",-31.25,"),
                  HOSP_ROW.replace(",164,", ",0.1,")],
        "digits": [HOSP_ROW.replace(",67,", ",1234567890123456,")]}),
}


def _csv_schema(name):
    import copy

    from avenir_tpu_torch.datagen.elearn import ELEARN_SCHEMA_JSON

    if name == "elearn":
        return ELEARN_SCHEMA_JSON
    schema = copy.deepcopy(HOSP_SCHEMA_JSON)
    if name == "mixed":             # three continuous fields among binned
        for f in schema["fields"][1:4]:
            for k in ("bucketWidth", "min", "max"):
                f.pop(k)
    return schema


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CSV_CASES))
def test_csv_encode_kernel_equals_plain_and_native(cuda, tmp_path, case):
    """``csrc/csv_encode.cu`` on a generated part and on parts with fields
    the fast path takes or refuses, for binned, categorical, continuous and
    label fields and a read of no labels: its codes, labels and continuous
    values bit-equal to its plain version on the card and to the native
    encoder, a refusal wherever the plain version refuses, one launch a
    call."""
    from avenir_tpu_torch.datagen.elearn import generate_elearn
    from avenir_tpu_torch.jobs.base import BlockReader
    from avenir_tpu_torch.ops import csv as tcsv
    from avenir_tpu_torch.runtime import native

    schema, gen, n, ncols, with_labels, odd = CSV_CASES[case]
    gen = gen or generate_elearn
    rows = gen(n, seed=9)
    enc = DatasetEncoder(FeatureSchema.from_json(_csv_schema(schema)))
    if not enc.schema_complete(True):
        enc.fit(rows[:5000])
    spec = tcsv.CsvSpec(enc, with_labels=with_labels)
    assert spec.has_labels == with_labels
    assert spec.n_cont == {"elearn": 9, "mixed": 3}.get(schema, 0)
    parts = {"generated": _csv_part(tmp_path / "gen.csv", rows)}
    for name, tail in odd.items():
        parts[name] = _csv_part(tmp_path / f"{name}.csv", rows[:5000], tail)
    stream = torch.cuda.Stream(cuda)

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    for name, path in parts.items():
        block, nrows, _ = BlockReader(pinned=True).read(path, 0, 1 << 30,
                                                        True)
        before = tcsv.encode_csv.launches
        got = tcsv.encode_csv(block.tensor, nrows, block.data_off,
                              block.nbytes, spec, ncols, ",", cuda, stream)
        assert tcsv.encode_csv.launches == before + 1
        plain = tcsv.csv_encode_ref(
            block.tensor[block.data_off:block.data_off + block.nbytes].to(cuda),
            torch.from_numpy(block.starts.copy()).to(cuda), spec, ncols, ",")
        assert (got is None) == (plain is None) == (
            name not in ("generated", "taken")), name
        if got is None:
            continue
        want = native.encode_bytes(block.data, enc, ncols, ",",
                                   with_labels=with_labels, with_ids=False)
        for a, b in zip(got, plain):
            assert (a is None) == (b is None), name
            assert a is None or torch.equal(bits(a), bits(b)), name
        assert np.array_equal(got[0].cpu().numpy(), want.codes), name
        assert np.array_equal(got[2].cpu().numpy().view(np.int32),
                              want.cont.view(np.int32)), name
        if with_labels:
            assert np.array_equal(got[1].cpu().numpy(), want.labels), name
        else:
            assert got[1] is None and want.labels is None, name


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [120, 128])
def test_csv_encode_kernel_at_the_shared_memory_limit(cuda, tmp_path, rows):
    """150 binned columns of 7 digits in one tile: 120 rows take all but
    ~5 KB of a block's shared memory and are encoded, bit-equal to the
    native encoder; 128 rows need more, and the chunk is refused before
    any launch."""
    from avenir_tpu_torch.jobs.base import BlockReader
    from avenir_tpu_torch.ops import csv as tcsv
    from avenir_tpu_torch.runtime import native

    schema = {"fields": [
        {"name": f"x{i}", "ordinal": i, "dataType": "int", "feature": True,
         "bucketWidth": 100000, "min": 0, "max": 9999999} for i in range(150)
    ] + [{"name": "y", "ordinal": 150, "dataType": "categorical",
          "cardinality": ["N", "Y"]}]}
    vals = np.random.default_rng(3).integers(1_000_000, 9_999_999,
                                             size=(rows, 150))
    path = tmp_path / "wide.csv"
    path.write_bytes("".join(",".join(map(str, r)) + f",{'NY'[i % 2]}\n"
                             for i, r in enumerate(vals)).encode())
    enc = DatasetEncoder(FeatureSchema.from_json(schema))
    spec = tcsv.CsvSpec(enc)
    block, n, _ = BlockReader(pinned=True).read(str(path), 0, 1 << 30,
                                                True)
    smem = tcsv.smem_bytes(spec, 151, tcsv.tile_span(block.starts, n))
    assert (smem <= tcsv.SMEM_MAX) == (rows == 120)
    before = tcsv.encode_csv.launches
    got = tcsv.encode_csv(block.tensor, n, block.data_off, block.nbytes,
                          spec, 151, ",", cuda, torch.cuda.Stream(cuda))
    if rows == 128:
        assert got is None and tcsv.encode_csv.launches == before
        return
    assert tcsv.encode_csv.launches == before + 1
    want = native.encode_bytes(block.data, enc, 151, ",", with_ids=False)
    assert np.array_equal(got[0].cpu().numpy(), want.codes)
    assert np.array_equal(got[1].cpu().numpy(), want.labels)


@pytest.mark.cuda
def test_csv_pipeline_takes_the_device_route(cuda, tmp_path, monkeypatch):
    """The NB + MI pipeline over CSV parts on cuda encodes every row on the
    card (``encode_chunk.rows_device``, one ``encode_csv`` launch a chunk,
    nothing refused or encoded on the host) and writes the host route's
    part files on cuda byte for byte, and the CPU run's NB file."""
    from avenir_tpu_torch.core.config import JobConfig
    from avenir_tpu_torch.jobs import base
    from avenir_tpu_torch.ops import csv as tcsv
    from avenir_tpu_torch.pipeline.driver import Pipeline

    data = tmp_path / "data"
    data.mkdir()
    for p in range(2):
        _csv_part(data / f"part-{p:05d}",
                  generate_hosp_readmit(250_000, seed=20 + p))
    (tmp_path / "hosp.json").write_text(json.dumps(HOSP_SCHEMA_JSON))
    props = {"pipeline.stages": "bayes,mi",
             "pipeline.stage.bayes.job": "BayesianDistribution",
             "pipeline.stage.bayes.input": "data",
             "pipeline.stage.bayes.output": "bayes",
             "pipeline.stage.mi.job": "MutualInformation",
             "pipeline.stage.mi.input": "data",
             "pipeline.stage.mi.output": "mi",
             "stream.chunk.rows": "100000",
             "feature.schema.file.path": str(tmp_path / "hosp.json"),
             "pipeline.bind.data": str(data)}
    files = {}
    for dev in ("cuda", "host", "cpu"):
        if dev == "host":           # the native route, copied to the card
            monkeypatch.setattr(base.Job, "_decode_device",
                                staticmethod(lambda device, staged: None))
        conf = JobConfig(dict(props, **{
            "pipeline.workspace": str(tmp_path / dev)}))
        counts = (base.encode_chunk.rows_device, base.encode_chunk.rows_native,
                  base.encode_chunk.rows_python,
                  base.encode_chunk.chunks_refused, tcsv.encode_csv.launches)
        Pipeline.from_conf(conf, device="cpu" if dev == "cpu" else "cuda"
                           ).run()
        after = (base.encode_chunk.rows_device, base.encode_chunk.rows_native,
                 base.encode_chunk.rows_python,
                 base.encode_chunk.chunks_refused, tcsv.encode_csv.launches)
        delta = [b - a for a, b in zip(counts, after)]
        assert delta == ([500_000, 0, 0, 0, 6] if dev == "cuda"
                         else [0, 500_000, 0, 0, 0]), (dev, delta)
        files[dev] = {s: (tmp_path / dev / s / "part-00000").read_bytes()
                      for s in ("bayes", "mi")}
    assert files["cuda"] == files["host"]
    assert files["cuda"]["bayes"] == files["cpu"]["bayes"]
