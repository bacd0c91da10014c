#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (avenir_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. print the card's name and power limit (nvidia-smi) and build the CUDA
   kernels ``avenir_tpu_torch/csrc/{cooc,cooc_cls,cross}.cu`` (one nvcc
   each, all started together), printing each build time and ptxas report;
2. hold each kernel against its plain PyTorch version on the card — exact
   int equality — and time the kernel, the plain version and a library
   yardstick the port never calls, with CUDA events:
   - B1 (cooc.cu): the hospital-readmission shape 11 × 12 × 2 at 16M rows
     and the main path's 10 × 13 × 2 chunk, a jmaj shape (20 × 3 × 2) at 1M
     rows, a ragged row count with invalid codes and labels, and zero rows
     (yardstick: ``torch._int_mm`` on a materialized int8 one-hot);
   - B2 (cooc_cls.cu, cls): 20 × 20 × 2 at 4M rows and at the main path's
     250K-row chunk, ragged/invalid, zero rows; B3 (cooc_cls.cu, clsb):
     100 × 20 × 2 at 1M rows, ragged/invalid, zero rows (yardstick: one
     ``torch._int_mm`` per class on its materialized int8 one-hot);
   - B4 (cross.cu): 10 × 13 at 1M rows with 2, 18 and 54 selectors,
     1024 selectors (the gate), ragged with invalid codes and selectors,
     zero rows (yardstick: one ``torch.bincount`` over the composite index
     built beforehand);
3. generate a 1M-row hospital CSV and run BayesianDistribution,
   BayesianPredictor and MutualInformation through the port's CLI entry on
   ``cuda`` with ``stream.chunk.rows=250000``, then with ``--device cpu``;
   the NB model and predictions must be byte-identical, the MI part file
   equal field by field with numbers within 2e-6, and B1 launched once per
   MI chunk.  Then MutualInformation on a seeded 20 × 20 × 2 dataset of 1M
   rows in 250K-row chunks on both devices: counts byte-identical, MI
   within 2e-6, B2 launched once per chunk;
4. the tree jobs on the same CSV through the CLI on ``cuda`` and ``cpu``:
   DecisionTreeBuilder with its defaults, and with ``split.search=binary``
   and ``tree.hist.mode=subtract``; its predict mode on the test CSV; and
   ClassPartitionGenerator.  Model files agree (the tree contract: equal
   but for scores within 1e-6), predictions byte-identical, split lines
   equal with numbers within 2e-6, and B4 launched once per level table;
5. ``DecisionTree.fit`` on a seeded 30 × 8 × 2 dataset of 1M rows (binary
   search, depth 4): on ``cuda`` its levels must pack onto jmaj, cls, cls
   and clsb (B1, B2, B3), on ``cpu`` take the plain route, and the trees
   agree;
6. each kernel again at the main paths' own inputs: every call that
   phases 3–5 made on ``cuda`` to the count wrappers was recorded (the MI
   jobs' chunks, the hospital trees' levels with 2, 4, 8 and 16
   selectors, the wide tree's packed levels K = 1, 2, 4, 8), and each is
   held exactly against its plain version; the first call of each path
   and shape is timed with its plain version, yardstick and bound;
7. print the kernels' JSON line, its numbers from the main-path cases of
   phase 6 (B1: a hospital MI chunk; B2: a 20 × 20 × 2 MI chunk; B3: the
   wide tree's K = 8 level; B4: the hospital tree's deepest level), then
   the last line ``{"ok": true, "device": {...}}``.

Each phase that drives a path sets every launch count to 0 just before it
and reads the counts just after.  It imports nothing of JAX and nothing of
the JAX package, and exits non-zero without printing a result when no CUDA
device is available.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

# H100 SXM published dense peaks (NVIDIA data sheet)
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12

MI_TOL = 2e-6            # MI numbers: float32 statistics printed to 6 places
SCORE_TOL = 1e-6         # tree split scores (the tree contract)
ROWS_E2E = 1_000_000
CHUNK_ROWS = 250_000
KERNEL_SOURCES = ("cooc", "cooc_cls", "cross")
COUNTS = {"B1": ("cooc_counts_cols", "launches"),
          "B2": ("cooc_counts_cols", "cls_launches"),
          "B3": ("cooc_counts_cols", "clsb_launches"),
          "B4": ("cross_cooc_counts_cols", "launches")}
# the main path of each kernel in the kernels line: (path, which call)
MAIN_PATH = {"B1": ("mi", "first"), "B2": ("mi_wide", "first"),
             "B3": ("wide_tree", "first"), "B4": ("tree", "last")}


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Median per-call ms over ``iters`` calls, each bracketed by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def make_case(n, f, b, c, invalid, seed):
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    codes = torch.randint(0, b, (f, n), dtype=torch.int32, device="cuda",
                          generator=gen)
    labels = torch.randint(0, c, (n,), dtype=torch.int32, device="cuda",
                           generator=gen)
    if invalid and n:
        k = max(n // 50, 1)
        for val in (-1, b, b + 7):                 # dropped cells
            rows = torch.randint(0, n, (k,), device="cuda", generator=gen)
            feats = torch.randint(0, f, (k,), device="cuda", generator=gen)
            codes[feats, rows] = val
        for val in (-1, c):                        # dropped rows
            labels[torch.randint(0, n, (k,), device="cuda", generator=gen)] = val
    return codes, labels


def library_gram(codes, labels, b, c):
    """(call, buffers) for the yardstick: ``call()`` is one torch._int_mm
    XᵀX on the int8 one-hot X materialized in device memory, laid out per
    plan(); ``buffers`` keeps X alive while it is timed."""
    import torch

    from avenir_tpu_torch.ops import hist

    f, n = codes.shape
    mode, jcp, wp = hist.plan(f, b, c)
    wf = torch.as_tensor(hist.w_index(f, b, c), device="cuda")   # [F, B, C]
    ok = ((labels >= 0) & (labels < c))[None, :] & (codes >= 0) & (codes < b)
    w = wf[torch.arange(f, device="cuda")[:, None],
           codes.clamp(0, b - 1).long(), labels.clamp(0, c - 1).long()[None, :]]
    npad = -(-n // 8) * 8                  # _int_mm needs K % 8 == 0
    x = torch.zeros((npad, wp), dtype=torch.int8, device="cuda")
    rows = torch.arange(n, device="cuda")[None, :].expand(f, n)
    x[rows[ok], w[ok]] = 1
    del w, ok, rows
    xt = x.t().contiguous()
    return (lambda: torch._int_mm(xt, x)), (x, xt)


def kernel_cases(hist):
    """Phase 2: B1 against its plain version on the card."""
    import torch

    cases = [
        ("hospital 16M rows (fmaj, wp 384)", 16_000_000, 11, 12, 2, False),
        # the CSV job's own shape (10 binned features × 13 bins × 2 classes,
        # also fmaj, wp 384) at the chunk the main path hands the kernel
        ("10x13x2 at 250K rows (fmaj, wp 384)", CHUNK_ROWS, 10, 13, 2,
         False),
        ("jmaj 20x3x2, 1M rows (wp 128)", 1 << 20, 20, 3, 2, False),
        ("ragged 100003 rows, invalid codes and labels", 100_003, 11, 12, 2, True),
        ("zero rows", 0, 11, 12, 2, False),
    ]
    results = []
    for i, (label, n, f, b, c, invalid) in enumerate(cases):
        codes, labels = make_case(n, f, b, c, invalid, seed=i)
        mode, jcp, wp = hist.plan(f, b, c)
        g = hist.cooc_counts_cols(codes, labels, b, c)
        ref = hist.cooc_counts_cols_ref(codes, labels, b, c)
        torch.cuda.synchronize()
        err = int((g.long() - ref.long()).abs().max()) if g.numel() else 0
        if not torch.equal(g, ref):
            raise AssertionError(f"B1 disagrees with its plain version on "
                                 f"{label}: max |diff| {err}")
        big = n >= 1_000_000
        ms = time_ms(lambda: hist.cooc_counts_cols(codes, labels, b, c),
                     iters=10 if big else 20)
        plain_ms = time_ms(
            lambda: hist.cooc_counts_cols_ref(codes, labels, b, c),
            iters=3 if big else 5, warmup=1)
        library_ms = None
        if n:
            call, keep = library_gram(codes, labels, b, c)
            lib_g = call()
            torch.cuda.synchronize()
            if not torch.equal(lib_g, g):
                raise AssertionError(f"library yardstick disagrees on {label}")
            library_ms = time_ms(call, iters=5 if big else 20)
            del keep, lib_g
        # The work the function needs: each input read once, G written once,
        # and an int8 multiply-add per row for each cell of the upper
        # triangle of the used w lanes (G is symmetric; pad lanes hold 0).
        used = f * b * c
        nbytes = 4 * f * n + 4 * n + 4 * wp * wp
        ops = used * (used + 1) * n
        bytes_ms = nbytes / PEAK_BYTES * 1e3
        ops_ms = ops / PEAK_INT8_OPS * 1e3
        row = {"kernel": "B1", "case": label, "n": n, "f": f, "b": b, "c": c,
               "mode": mode,
               "wp": wp, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}
        log("B1 case:", json.dumps(row))
        results.append(row)
        del codes, labels, g, ref
        torch.cuda.empty_cache()
    return results


def reset_counts(hist) -> None:
    for fn, attr in COUNTS.values():
        setattr(getattr(hist, fn), attr, 0)


def read_counts(hist) -> dict:
    return {k: getattr(getattr(hist, fn), attr)
            for k, (fn, attr) in COUNTS.items()}


class Recorder:
    """Keeps the arguments of every call a driven path makes to the two
    count wrappers, which run and count as before, so that phase 6 can
    hold each kernel against its plain version on the path's own inputs.

    A wrapper counts its launches on its module-level name, which is the
    shim while the shim is on: the shim starts with the wrapper's counts
    (``functools.wraps`` copies them) and hands them back when it comes
    off."""

    WRAPPERS = ("cooc_counts_cols", "cross_cooc_counts_cols")

    def __init__(self, hist):
        self.hist = hist
        self.calls = []                    # (wrapper name, path, args)

    @contextlib.contextmanager
    def on(self, path: str):
        import functools

        saved = {name: getattr(self.hist, name) for name in self.WRAPPERS}

        def shim(name, fn):
            @functools.wraps(fn)
            def call(*args):
                self.calls.append((name, path, args))
                return fn(*args)
            return call

        for name, fn in saved.items():
            setattr(self.hist, name, shim(name, fn))
        try:
            yield
        finally:
            for name, fn in saved.items():
                shim = getattr(self.hist, name)
                for attr in vars(fn):
                    setattr(fn, attr, getattr(shim, attr))
                setattr(self.hist, name, fn)


def bound(nbytes: float, ops: float):
    """(bound ms, what bounds it) at the published H100 peaks."""
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    ops_ms = ops / PEAK_INT8_OPS * 1e3
    return max(bytes_ms, ops_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def per_class_library(codes, labels, b, c):
    """(call, buffers) for the B2/B3 yardstick: ``call()`` is one
    torch._int_mm X_cᵀX_c per class on the int8 one-hot X_c of class c's
    rows, materialized in device memory beforehand, laid out per plan()."""
    import torch

    from avenir_tpu_torch.ops import hist

    f, n = codes.shape
    _mode, _jcp, wp = hist.plan(f, b, c)
    w2 = torch.as_tensor(hist.w_index(f, b, c)[:, :, 0], device="cuda")
    feats = torch.arange(f, device="cuda")[:, None]
    mats = []
    for k in range(c):
        rows = (labels == k).nonzero()[:, 0]
        ck = codes[:, rows]
        nk = rows.numel()
        ok = (ck >= 0) & (ck < b)
        w = w2[feats, ck.clamp(0, b - 1).long()]
        x = torch.zeros((max(-(-nk // 8) * 8, 8), wp), dtype=torch.int8,
                        device="cuda")
        r = torch.arange(nk, device="cuda")[None, :].expand(f, nk)
        x[r[ok], w[ok]] = 1
        del ck, ok, w, r
        mats.append((x.t().contiguous(), x))
    return (lambda: torch.stack([torch._int_mm(xt, x) for xt, x in mats])), mats


def per_class_cases(hist):
    """Phase 2: B2 and B3 against the plain version on the card."""
    import torch

    cases = [
        ("B2", "20x20x2 at 4M rows (cls, wp 512)", 4_000_000, 20, 20, 2, False),
        ("B2", "20x20x2 at 250K rows (cls, wp 512)", CHUNK_ROWS, 20, 20, 2,
         False),
        ("B2", "ragged 100003 rows, invalid codes and labels (cls)", 100_003,
         20, 20, 2, True),
        ("B2", "zero rows (cls)", 0, 20, 20, 2, False),
        ("B3", "100x20x2 at 1M rows (clsb, wp 2000, TR 400)", 1_000_000,
         100, 20, 2, False),
        ("B3", "ragged 100003 rows, invalid codes and labels (clsb)", 100_003,
         100, 20, 2, True),
        ("B3", "zero rows (clsb)", 0, 100, 20, 2, False),
    ]
    results = []
    for i, (kid, label, n, f, b, c, invalid) in enumerate(cases):
        codes, labels = make_case(n, f, b, c, invalid, seed=100 + i)
        mode, _jcp, wp = hist.plan(f, b, c)
        assert mode == ("cls" if kid == "B2" else "clsb"), (label, mode)
        reset_counts(hist)
        g = hist.cooc_counts_cols(codes, labels, b, c)
        if read_counts(hist)[kid] != (1 if n else 0):
            raise AssertionError(f"{kid} did not launch once on {label}")
        ref = hist.cooc_counts_cols_ref(codes, labels, b, c)
        torch.cuda.synchronize()
        err = int((g.long() - ref.long()).abs().max()) if n else 0
        if not torch.equal(g, ref):
            raise AssertionError(f"{kid} disagrees with its plain version on "
                                 f"{label}: max |diff| {err}")
        big = n >= 1_000_000
        ms = time_ms(lambda: hist.cooc_counts_cols(codes, labels, b, c),
                     iters=10 if big else 20)
        plain_ms = time_ms(
            lambda: hist.cooc_counts_cols_ref(codes, labels, b, c),
            iters=3 if big else 5, warmup=1)
        library_ms = None
        if n:
            call, keep = per_class_library(codes, labels, b, c)
            if not torch.equal(call(), g):
                raise AssertionError(f"library yardstick disagrees on {label}")
            library_ms = time_ms(call, iters=5 if big else 20)
            del keep
        # each row adds one int8 multiply-add to each upper-triangle cell of
        # its own class's F·B used lanes; inputs read once, G written once
        used = f * b
        bound_ms, bound_by = bound(4 * f * n + 4 * n + 4 * c * wp * wp,
                                   used * (used + 1) * n)
        row = {"kernel": kid, "case": label, "n": n, "f": f, "b": b, "c": c,
               "mode": mode, "wp": wp, "max_abs_err": err, "ms": ms,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": bound_ms, "bound_by": bound_by}
        log(f"{kid} case:", json.dumps(row))
        results.append(row)
        del codes, labels, g, ref
        torch.cuda.empty_cache()
    return results


def make_cross_case(n, f, b, s, invalid, seed):
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    codes = torch.randint(0, b, (f, n), dtype=torch.int32, device="cuda",
                          generator=gen)
    sel = torch.randint(0, s, (n,), dtype=torch.int32, device="cuda",
                        generator=gen)
    if invalid and n:
        k = max(n // 50, 1)
        for val in (-1, b, b + 7):                 # dropped cells
            rows = torch.randint(0, n, (k,), device="cuda", generator=gen)
            feats = torch.randint(0, f, (k,), device="cuda", generator=gen)
            codes[feats, rows] = val
        for val in (-1, s, s + 9):                 # dropped rows
            sel[torch.randint(0, n, (k,), device="cuda", generator=gen)] = val
    return codes, sel


def cross_library(codes, sel, b, s):
    """(call, buffers) for the B4 yardstick: ``call()`` is one
    torch.bincount over the composite (f·B + bin)·S + sel index of the
    valid cells, built beforehand."""
    import torch

    f = codes.shape[0]
    ok = ((sel >= 0) & (sel < s))[None, :] & (codes >= 0) & (codes < b)
    idx = ((torch.arange(f, device=codes.device)[:, None] * b
            + codes.long()) * s + sel.long()[None, :])[ok]
    return (lambda: torch.bincount(idx, minlength=f * b * s)), idx


def cross_cases(hist):
    """Phase 2: B4 against its plain version on the card."""
    import torch

    cases = [
        ("10x13, 2 selectors at 1M rows (hospital root)", 1_000_000, 10, 13, 2,
         False),
        ("10x13, 18 selectors at 1M rows", 1_000_000, 10, 13, 18, False),
        ("10x13, 54 selectors at 1M rows", 1_000_000, 10, 13, 54, False),
        ("10x13, 1024 selectors at 1M rows (the gate)", 1_000_000, 10, 13,
         1024, False),
        ("ragged 100003 rows, invalid codes and selectors", 100_003, 10, 13,
         54, True),
        ("zero rows (cross)", 0, 10, 13, 54, False),
    ]
    results = []
    for i, (label, n, f, b, s, invalid) in enumerate(cases):
        codes, sel = make_cross_case(n, f, b, s, invalid, seed=200 + i)
        reset_counts(hist)
        t = hist.cross_cooc_counts_cols(codes, sel, b, s)
        if read_counts(hist)["B4"] != (1 if n else 0):
            raise AssertionError(f"B4 did not launch once on {label}")
        ref = hist.cross_cooc_counts_cols_ref(codes, sel, b, s)
        torch.cuda.synchronize()
        err = int((t.long() - ref.long()).abs().max()) if n else 0
        if not torch.equal(t, ref):
            raise AssertionError(f"B4 disagrees with its plain version on "
                                 f"{label}: max |diff| {err}")
        ms = time_ms(lambda: hist.cross_cooc_counts_cols(codes, sel, b, s),
                     iters=20)
        plain_ms = time_ms(
            lambda: hist.cross_cooc_counts_cols_ref(codes, sel, b, s),
            iters=5, warmup=1)
        library_ms = None
        if n:
            call, keep = cross_library(codes, sel, b, s)
            if not torch.equal(call().to(torch.int32).reshape(f, b, s), t):
                raise AssertionError(f"library yardstick disagrees on {label}")
            library_ms = time_ms(call, iters=20)
            del keep
        # the dense XᵀY form: 2·F·B·S multiply-adds per row; inputs read
        # once, the [F, B, S] table written once
        bound_ms, bound_by = bound(4 * f * n + 4 * n + 4 * f * b * s,
                                   2 * f * b * s * n)
        row = {"kernel": "B4", "case": label, "n": n, "f": f, "b": b,
               "num_sel": s, "max_abs_err": err, "ms": ms,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": bound_ms, "bound_by": bound_by}
        log("B4 case:", json.dumps(row))
        results.append(row)
        del codes, sel, t, ref
        torch.cuda.empty_cache()
    return results


def run_cli(argv):
    """The port's CLI entry in this process; returns its stdout."""
    from avenir_tpu_torch.__main__ import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    if rc != 0:
        raise AssertionError(f"CLI {argv[0]} exited {rc}")
    return buf.getvalue()


def counter(out: str, name: str) -> int:
    for line in out.splitlines():
        if line.strip().startswith(name + "="):
            return int(line.strip().split("=", 1)[1])
    raise AssertionError(f"counter {name} missing from job output:\n{out}")


def compare_mi(a_path: str, b_path: str) -> float:
    """Field-by-field MI part-file comparison; returns the max numeric diff."""
    with open(a_path) as fa, open(b_path) as fb:
        a, b = fa.read().splitlines(), fb.read().splitlines()
    if len(a) != len(b):
        raise AssertionError(f"MI part files differ in length: {len(a)} vs {len(b)}")
    worst = 0.0
    for la, lb in zip(a, b):
        fa_, fb_ = la.split(","), lb.split(",")
        if len(fa_) != len(fb_):
            raise AssertionError(f"MI lines differ: {la!r} vs {lb!r}")
        for x, y in zip(fa_, fb_):
            try:
                dx = abs(float(x) - float(y))
            except ValueError:
                if x != y:
                    raise AssertionError(f"MI lines differ: {la!r} vs {lb!r}")
                continue
            if dx > MI_TOL:
                raise AssertionError(f"MI numbers differ by {dx}: {la!r} vs {lb!r}")
            worst = max(worst, dx)
    return worst


def same_bytes(a: str, b: str, what: str) -> None:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        if fa.read() != fb.read():
            raise AssertionError(f"{what} part files differ between cuda and cpu")


def jobs_phase(hist, rec: Recorder, work: str):
    """Phase 3: the three CLI jobs on cuda, then on the CPU; returns B1's
    launches in the cuda run."""
    from avenir_tpu_torch.core.csv_io import write_csv
    from avenir_tpu_torch.datagen.hosp_readmit import (HOSP_SCHEMA_JSON,
                                                      generate_hosp_readmit)

    t0 = time.perf_counter()
    rows = generate_hosp_readmit(ROWS_E2E + 100_000, seed=11)
    train, test = os.path.join(work, "train.csv"), os.path.join(work, "test.csv")
    write_csv(train, rows[:ROWS_E2E])
    write_csv(test, rows[ROWS_E2E:])
    schema = os.path.join(work, "hosp.json")
    with open(schema, "w") as fh:
        json.dump(HOSP_SCHEMA_JSON, fh)
    log(f"jobs: generated {ROWS_E2E} training rows in "
        f"{time.perf_counter() - t0:.1f} s")
    common = [f"-Dfeature.schema.file.path={schema}",
              f"-Dstream.chunk.rows={CHUNK_ROWS}"]
    out = {}
    launches = None
    for dev in ("cuda", "cpu"):
        o = lambda name: os.path.join(work, f"{dev}_{name}")
        if dev == "cuda":
            reset_counts(hist)                     # the main path's run only
        t0 = time.perf_counter()
        run_cli(["BayesianDistribution", *common, train, o("nb"), "--device", dev])
        t_nb = time.perf_counter() - t0
        t0 = time.perf_counter()
        pred_out = run_cli(["BayesianPredictor", *common,
                            f"-Dbayesian.model.file.path={o('nb')}",
                            "-Dprediction.mode=validation",
                            test, o("pred"), "--device", dev])
        t_pred = time.perf_counter() - t0
        t0 = time.perf_counter()
        with rec.on("mi") if dev == "cuda" else contextlib.nullcontext():
            mi_out = run_cli(
                ["MutualInformation", *common,
                 "-Dmutual.info.score.algorithms=mim,mifs,jmi,disr,mrmr",
                 train, o("mi"), "--device", dev])
        t_mi = time.perf_counter() - t0
        chunks = counter(mi_out, "Chunks")
        if dev == "cuda":
            counts = read_counts(hist)
            launches = counts["B1"]
            if counts != {"B1": chunks, "B2": 0, "B3": 0, "B4": 0}:
                raise AssertionError(f"NB + MI jobs launched {counts}")
            if launches != chunks or chunks != -(-ROWS_E2E // CHUNK_ROWS):
                raise AssertionError(f"B1 launched {launches} times for "
                                     f"{chunks} MI chunks")
        if counter(mi_out, "Processed") != ROWS_E2E:
            raise AssertionError("MI job did not process every row")
        log(f"jobs on {dev}: BayesianDistribution {t_nb:.2f} s, "
            f"BayesianPredictor {t_pred:.2f} s (accuracy "
            f"{counter(pred_out, 'accuracy')}), MutualInformation "
            f"{t_mi:.2f} s over {chunks} chunks")
        out[dev] = {k: os.path.join(o(k), "part-00000") for k in ("nb", "pred", "mi")}
    same_bytes(out["cuda"]["nb"], out["cpu"]["nb"], "NB model")
    same_bytes(out["cuda"]["pred"], out["cpu"]["pred"], "NB prediction")
    worst = compare_mi(out["cuda"]["mi"], out["cpu"]["mi"])
    with open(out["cuda"]["mi"]) as fh:
        mi_lines = fh.read().splitlines()
    # per feature one featureClassMI line, per pair three, per scorer a
    # header and one line per feature
    f = sum(line.startswith("featureClassMI,") for line in mi_lines)
    if f != 10 or len(mi_lines) != f + 3 * (f * (f - 1) // 2) + 5 * (f + 1):
        raise AssertionError(f"MI part file has {len(mi_lines)} lines for "
                             f"{f} features")
    log(f"jobs: NB model and predictions byte-identical cuda vs cpu; MI "
        f"fields equal, max numeric diff {worst}")
    return launches, train, test, schema


def wide_dataset(n: int, f: int, b: int, seed: int):
    """A seeded [n, f] dataset of b-bin codes whose binary label depends on
    the first six features, so every frontier node has a split to take."""
    import numpy as np

    from avenir_tpu_torch.core.encoding import EncodedDataset

    rng = np.random.default_rng(seed)
    codes = rng.integers(0, b, size=(n, f)).astype(np.int32)
    logit = (codes[:, :6] - (b - 1) / 2) @ np.array([1.0, -0.8, 0.6, -0.5,
                                                      0.4, 0.3])
    labels = (logit + rng.normal(0, 2.0, n) > 0).astype(np.int32)
    return EncodedDataset(
        codes=codes, cont=np.zeros((n, 0), np.float32), labels=labels,
        n_bins=np.full(f, b, np.int32), class_values=["0", "1"],
        binned_ordinals=list(range(f)))


def mi_wide_phase(hist, rec: Recorder) -> int:
    """Phase 3b: MutualInformation on a 20 × 20 × 2 schema (plan: cls) on
    cuda and cpu; returns B2's launches on cuda."""
    import numpy as np

    from avenir_tpu_torch.models import mutual_info as mi

    ds = wide_dataset(ROWS_E2E, 20, 20, seed=12)
    chunks = [ds.slice(s, s + CHUNK_ROWS) for s in range(0, ROWS_E2E, CHUNK_ROWS)]
    reset_counts(hist)
    t0 = time.perf_counter()
    with rec.on("mi_wide"):
        got = mi.MutualInformation(device="cuda").fit(chunks)
    t_cuda = time.perf_counter() - t0
    counts = read_counts(hist)
    if counts != {"B1": 0, "B2": len(chunks), "B3": 0, "B4": 0}:
        raise AssertionError(f"MI 20x20x2 launched {counts} for "
                             f"{len(chunks)} chunks")
    t0 = time.perf_counter()
    want = mi.MutualInformation(device="cpu").fit(chunks)
    t_cpu = time.perf_counter() - t0
    for name in ("class_counts", "feature_class_counts", "pair_class_counts"):
        if not np.array_equal(getattr(got, name), getattr(want, name)):
            raise AssertionError(f"MI 20x20x2 {name} differ cuda vs cpu")
    worst = 0.0
    for name in ("feature_class_mi", "feature_pair_mi", "pair_class_mi",
                 "feature_pair_class_cond_mi"):
        worst = max(worst, float(np.abs(getattr(got, name)
                                        - getattr(want, name)).max()))
    if worst > MI_TOL:
        raise AssertionError(f"MI 20x20x2 statistics differ by {worst}")
    log(f"MI 20x20x2 over {len(chunks)} chunks of {CHUNK_ROWS} rows: cuda "
        f"{t_cuda:.2f} s, cpu {t_cpu:.2f} s; counts byte-identical, max MI "
        f"diff {worst}; B2 launched {counts['B2']} times")
    return counts["B2"]


def same_tree(a: str, b: str, what: str) -> float:
    """The tree contract: equal JSON but for node scores within SCORE_TOL;
    returns the largest score difference."""
    ja, jb = json.loads(a), json.loads(b)
    na, nb = ja.pop("nodes"), jb.pop("nodes")
    if ja != jb or len(na) != len(nb):
        raise AssertionError(f"{what}: trees differ ({len(na)} vs {len(nb)} "
                             f"nodes)")
    worst = 0.0
    for x, y in zip(na, nb):
        d = abs(x.pop("score") - y.pop("score"))
        if x != y or d > SCORE_TOL:
            raise AssertionError(f"{what}: node {x['id']} differs: {x} vs {y}")
        worst = max(worst, d)
    return worst


def tree_phase_table(out: str) -> dict:
    """TreePhase counters of a DecisionTreeBuilder run → {level: (table,
    select, partition) µs}."""
    levels: dict = {}
    for line in out.splitlines():
        line = line.strip()
        if line.startswith("level.") and ".us=" in line:
            key, val = line.split("=")
            _, lv, phase, _ = key.split(".")
            levels.setdefault(int(lv), {})[phase] = int(val)
    return {lv: (v["table"], v["select"], v["partition"])
            for lv, v in sorted(levels.items())}


def tree_jobs_phase(hist, rec: Recorder, work: str, train: str, test: str,
                    schema: str) -> dict:
    """Phase 4: the tree jobs through the CLI on cuda and cpu; returns
    B4's launches on cuda by job (each job's counts are reset just before
    it)."""
    common = [f"-Dfeature.schema.file.path={schema}"]
    jobs = [
        ("tree", ["DecisionTreeBuilder", *common, "-Dtree.hist.phase.stats=true",
                  train]),
        ("tree_bin", ["DecisionTreeBuilder", *common, "-Dsplit.search=binary",
                      "-Dtree.hist.mode=subtract",
                      "-Dtree.hist.phase.stats=true", train]),
        ("pred", ["DecisionTreeBuilder", *common,
                  "-Dprediction.mode=validation", test]),
        ("cpg", ["ClassPartitionGenerator", *common,
                 "-Doutput.split.prob=true", train]),
    ]
    b4 = {}
    out = {}
    for dev in ("cuda", "cpu"):
        o = lambda name: os.path.join(work, f"{dev}_{name}")  # noqa: E731
        walls = []
        for name, argv in jobs:
            argv = list(argv)
            if name == "pred":
                argv.insert(1, f"-Dtree.model.file.path={o('tree')}")
            reset_counts(hist)
            t0 = time.perf_counter()
            with rec.on(name) if dev == "cuda" else contextlib.nullcontext():
                text = run_cli([*argv, o(name), "--device", dev])
            walls.append(f"{name} {time.perf_counter() - t0:.2f} s")
            counts = read_counts(hist)
            levels = tree_phase_table(text)
            if dev == "cuda":
                # one level table per level of each fit, one for the
                # split-scoring job; the predictor builds none
                want = len(levels) if name.startswith("tree") else (
                    1 if name == "cpg" else 0)
                if counts != {"B1": 0, "B2": 0, "B3": 0, "B4": want}:
                    raise AssertionError(f"{name} on cuda launched {counts}, "
                                         f"expected B4 {want}")
                b4[name] = counts["B4"]
                for lv, (tab, sel, part) in levels.items():
                    log(f"TreePhase cuda {name} level {lv}: table {tab} us, "
                        f"select {sel} us, partition {part} us")
            if name == "pred":
                log(f"tree predict on {dev}: accuracy "
                    f"{counter(text, 'accuracy')}")
        log(f"tree jobs on {dev}: " + ", ".join(walls))
        out[dev] = {name: os.path.join(o(name), "part-00000")
                    for name, _ in jobs}
    for name in ("tree", "tree_bin"):
        with open(out["cuda"][name]) as fa, open(out["cpu"][name]) as fb:
            a, b = fa.read().splitlines(), fb.read().splitlines()
        if len(a) != 2 or len(b) != 2 or a[1] != b[1]:
            raise AssertionError(f"{name} model files differ in shape or "
                                 f"encoder state")
        d = same_tree(a[0], b[0], name)
        log(f"{name}: cuda and cpu trees agree ({len(json.loads(a[0])['nodes'])}"
            f" nodes, max score diff {d})")
    same_bytes(out["cuda"]["pred"], out["cpu"]["pred"], "tree prediction")
    worst = 0.0
    with open(out["cuda"]["cpg"]) as fa, open(out["cpu"]["cpg"]) as fb:
        a, b = fa.read().splitlines(), fb.read().splitlines()
    if len(a) != len(b) or not a:
        raise AssertionError("split files differ in length")
    for la, lb in zip(a, b):
        fa_, fb_ = la.split(";"), lb.split(";")
        if len(fa_) != len(fb_) or fa_[:2] != fb_[:2] or fa_[3:] != fb_[3:]:
            raise AssertionError(f"split lines differ: {la!r} vs {lb!r}")
        d = abs(float(fa_[2]) - float(fb_[2]))
        if d > MI_TOL:
            raise AssertionError(f"split scores differ by {d}: {la!r} vs {lb!r}")
        worst = max(worst, d)
    log(f"tree jobs: predictions byte-identical cuda vs cpu; {len(a)} split "
        f"lines equal, max score diff {worst}; B4 launched {b4}")
    return b4


def wide_tree_phase(hist, rec: Recorder) -> dict:
    """Phase 5: DecisionTree.fit on a 30 × 8 × 2 dataset at 1M rows on cuda
    (packed levels: B1, B2, B3) and cpu (plain); returns the cuda counts."""
    from avenir_tpu_torch.models import tree

    ds = wide_dataset(ROWS_E2E, 30, 8, seed=13)
    models, counts = {}, None
    for dev in ("cuda", "cpu"):
        trainer = tree.DecisionTree(max_depth=4, split_search="binary",
                                    level_packed="auto",
                                    collect_phase_stats=True, device=dev)
        reset_counts(hist)
        t0 = time.perf_counter()
        with rec.on("wide_tree") if dev == "cuda" else contextlib.nullcontext():
            models[dev] = trainer.fit(ds).to_string()
        wall = time.perf_counter() - t0
        routes = [s["path"] + (":" + hist.pack_disjoint(
            s["contracted_slots"], 30, 8, 2).mode if s["path"] == "packed"
            else "") for s in trainer.level_stats]
        log(f"wide tree 30x8x2 on {dev}: {wall:.2f} s, routes {routes}")
        for s in trainer.level_stats:
            log(f"  level {s['level']}: frontier {s['frontier']}, table "
                f"{s['table_ms']} ms, select {s['select_ms']} ms, partition "
                f"{s['partition_ms']} ms")
        if dev == "cuda":
            counts = read_counts(hist)
            if routes != ["packed:jmaj", "packed:cls", "packed:cls",
                          "packed:clsb"]:
                raise AssertionError(f"wide tree routes {routes}")
            if counts != {"B1": 1, "B2": 2, "B3": 1, "B4": 0}:
                raise AssertionError(f"wide tree launched {counts}")
        elif routes != ["plain"] * 4:
            raise AssertionError(f"wide tree routes on cpu {routes}")
    d = same_tree(models["cuda"], models["cpu"], "wide tree")
    log(f"wide tree: cuda and cpu trees agree (max score diff {d}); "
        f"launches {counts}")
    return counts


def path_cases(hist, rec: Recorder) -> list:
    """Phase 6: each kernel against its plain version, exactly, on every
    input the driven paths gave it on cuda; the first call of each path and
    shape is timed with its plain version, yardstick and bound.  The bound
    counts this data's work: the rows that carry a valid label (selector)
    and at least one valid code, which leaves out a tree's settled rows."""
    import torch

    results, timed, seen = [], set(), {}
    for name, path, (codes, vec, b, k) in rec.calls:
        i = seen[path] = seen.get(path, -1) + 1
        f, n = codes.shape
        cross = name == "cross_cooc_counts_cols"
        if cross:
            kid, shape, wp = "B4", f"{f}x{b}, {k} selectors", None
            fn, ref = hist.cross_cooc_counts_cols, hist.cross_cooc_counts_cols_ref
        else:
            mode, _jcp, wp = hist.plan(f, b, k)
            kid = {"cls": "B2", "clsb": "B3"}.get(mode, "B1")
            shape = f"{f}x{b}x{k} ({mode}, wp {wp})"
            fn, ref = hist.cooc_counts_cols, hist.cooc_counts_cols_ref
        got, want = fn(codes, vec, b, k), ref(codes, vec, b, k)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
        label = f"{path} call {i}: {shape} at {n} rows"
        if not torch.equal(got, want):
            raise AssertionError(f"{kid} disagrees with its plain version on "
                                 f"{label}: max |diff| {err}")
        row = {"kernel": kid, "path": path, "call": i, "case": label, "n": n,
               "max_abs_err": err}
        if (path, shape, n) not in timed:
            timed.add((path, shape, n))
            big = n >= 1_000_000
            row["ms"] = time_ms(lambda: fn(codes, vec, b, k),
                                iters=10 if big else 20)
            row["plain_ms"] = time_ms(lambda: ref(codes, vec, b, k),
                                      iters=3 if big else 5, warmup=1)
            if cross:
                call, keep = cross_library(codes, vec, b, k)
                lib = call().to(torch.int32).reshape(f, b, k)
            else:
                call, keep = (library_gram if kid == "B1"
                              else per_class_library)(codes, vec, b, k)
                lib = call()
            if not torch.equal(lib, got):
                raise AssertionError(f"library yardstick disagrees on {label}")
            row["library_ms"] = time_ms(call, iters=5 if big else 20)
            del keep, lib
            n_eff = int((((vec >= 0) & (vec < k))
                         & ((codes >= 0) & (codes < b)).any(0)).sum())
            if cross:      # the dense XᵀY form: 2·F·B·S multiply-adds per row
                nbytes, ops = 4 * f * b * k, 2 * f * b * k * n_eff
            else:          # upper triangle of the used lanes (per class: F·B)
                used = f * b * (k if kid == "B1" else 1)
                nbytes = 4 * wp * wp * (1 if kid == "B1" else k)
                ops = used * (used + 1) * n_eff
            row["bound_ms"], row["bound_by"] = bound(
                4 * f * n + 4 * n + nbytes, ops)
            row["n_eff"] = n_eff
            log(f"{kid} path case:", json.dumps(row))
        results.append(row)
        del got, want
    rec.calls.clear()
    torch.cuda.empty_cache()
    log(f"path cases: {len(results)} recorded calls equal to their plain "
        f"versions")
    return results


def kernel_entry(kid, name, source, replaces, launches_by_path, cases):
    """The kernels-line entry: numbers from the main path's own case."""
    path, which = MAIN_PATH[kid]
    mine = [c for c in cases if c["kernel"] == kid]
    main = [c for c in mine if c.get("path") == path and "ms" in c]
    main = main[0] if which == "first" else main[-1]
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches_by_path[path],
        "launches_by_path": launches_by_path,
        "case": main["case"],
        "max_abs_err": max(c["max_abs_err"] for c in mine),
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from concurrent.futures import ThreadPoolExecutor

    from avenir_tpu_torch.ops import _build, hist

    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    def build(name):
        t0 = time.perf_counter()
        return name, _build.build(name), time.perf_counter() - t0

    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        for name, lib, secs in pool.map(build, KERNEL_SOURCES):
            log(f"build: {name} in {secs:.2f} s")
            with open(lib[:-3] + ".log") as fh:
                log(fh.read())

    cases = kernel_cases(hist)
    cls_cases = per_class_cases(hist)
    x_cases = cross_cases(hist)
    rec = Recorder(hist)
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        b1_mi, train, test, schema = jobs_phase(hist, rec, work)
        b2_mi = mi_wide_phase(hist, rec)
        b4_tree = tree_jobs_phase(hist, rec, work, train, test, schema)
        wide = wide_tree_phase(hist, rec)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    all_cases = cases + cls_cases + x_cases + path_cases(hist, rec)

    src = "avenir_tpu_torch/csrc/"
    at = "avenir_tpu/ops/pallas_hist.py:"
    kernels = [
        kernel_entry("B1", "cooc_gram (B1)", src + "cooc.cu", at + "283",
                     {"mi": b1_mi, "wide_tree": wide["B1"]}, all_cases),
        kernel_entry("B2", "cooc_cls_gram, cls (B2)", src + "cooc_cls.cu",
                     at + "333", {"mi_wide": b2_mi, "wide_tree": wide["B2"]},
                     all_cases),
        kernel_entry("B3", "cooc_cls_gram, clsb (B3)", src + "cooc_cls.cu",
                     at + "365", {"wide_tree": wide["B3"]}, all_cases),
        kernel_entry("B4", "cross_counts (B4)", src + "cross.cu", at + "484",
                     b4_tree, all_cases),
    ]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
