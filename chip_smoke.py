#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (avenir_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. print the card's name and power limit (nvidia-smi) and build the CUDA
   kernel ``avenir_tpu_torch/csrc/cooc.cu``, printing the build time and
   ptxas report;
2. hold each kernel against its plain PyTorch version on the card — exact
   int equality — at the hospital-readmission shape (11 features × 12 bins ×
   2 classes) at 16M rows and at the main path's chunk, a jmaj shape
   (20 × 3 × 2) at 1M rows, a ragged row count with invalid codes and
   labels, and zero rows; time the kernel, the plain version and the
   library yardstick (``torch._int_mm`` on a materialized int8 one-hot,
   never called by the port) with CUDA events;
3. generate a 1M-row hospital CSV and run BayesianDistribution,
   BayesianPredictor and MutualInformation through the port's CLI entry on
   ``cuda`` with ``stream.chunk.rows=250000`` (kernel launch counts reset
   just before the three jobs and read just after), then with
   ``--device cpu``; the NB model and predictions must be byte-identical,
   the MI part file equal field by field with numbers within 2e-6, and the
   gram kernel launched once per MI chunk;
4. print the kernels' JSON line, then the last line
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX and nothing of the JAX package, and exits
non-zero without printing a result when no CUDA device is available.
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
ROWS_E2E = 1_000_000
CHUNK_ROWS = 250_000
MAIN_CASE = "main-path chunk, 10x13x2 at 250K rows (fmaj, wp 384)"


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
        (MAIN_CASE, CHUNK_ROWS, 10, 13, 2, False),
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
        row = {"case": label, "n": n, "f": f, "b": b, "c": c, "mode": mode,
               "wp": wp, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}
        log("B1 case:", json.dumps(row))
        results.append(row)
        del codes, labels, g, ref
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


def jobs_phase(hist, work: str):
    """Phase 3: the three CLI jobs on cuda, then on the CPU."""
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
            hist.cooc_counts_cols.launches = 0     # the main path's run only
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
        mi_out = run_cli(["MutualInformation", *common,
                          "-Dmutual.info.score.algorithms=mim,mifs,jmi,disr,mrmr",
                          train, o("mi"), "--device", dev])
        t_mi = time.perf_counter() - t0
        chunks = counter(mi_out, "Chunks")
        if dev == "cuda":
            launches = hist.cooc_counts_cols.launches
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
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from avenir_tpu_torch.ops import _build, hist

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    lib = _build.build("cooc")
    log(f"build: cooc in {time.perf_counter() - t0:.2f} s")
    with open(lib[:-3] + ".log") as fh:
        log(fh.read())

    cases = kernel_cases(hist)
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        launches = jobs_phase(hist, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    main_case = next(c for c in cases if c["case"] == MAIN_CASE)
    kernels = [{
        "name": "cooc_gram (B1)",
        "route": "cuda",
        "source": "avenir_tpu_torch/csrc/cooc.cu",
        "replaces": "avenir_tpu/ops/pallas_hist.py:283",
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
    }]
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
