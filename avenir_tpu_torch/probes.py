"""Timing breakdowns of the port's kernels: the Hopper counterparts of the
JAX package's three TPU probes.

- :func:`knn_tourney_probe` (``benchmarks/knn_decomp_probe.py:113``): B5,
  ``csrc/knn_tourney.cu``, in its template variants — ``dotonly`` (loads
  and MMAs, a trivial output), ``dotkey`` (adds the key formation and a
  running minimum), ``full`` (the kernel) and ``full_insert`` (the kernel
  with one insert per key, the fold it had before its pair merge);
- :func:`onehot_gram_probe` (``benchmarks/cooc_expand_sweep.py:187,214``):
  the one-hot MMA gram of ``csrc/gram_probe.cu``, B1's kernel until the
  pair histogram replaced it — ``full`` (scatter expand + MMA, equal to the
  plain version) and ``dotonly`` (slices left zero, MMAs only) — beside
  the pair histogram that B1 now is (``pair``, :func:`ops.hist.cooc_counts_cols`);
- :func:`orient_gram_probe` (``benchmarks/dot_orient_probe.py:60,72``):
  the same kernel's ``mma.sync`` s8 stage on a given int8 matrix, staged
  from [N, W] (``rows``, transposed in registers on the way in) and from
  [W, N] (``cols``), no expand.

Each returns per variant the median ms of CUDA events around one call,
after warm-up.  The probes need an NVIDIA GPU and raise on CPU tensors;
nothing on a path of the system calls them, so they count no launches.

    python -m avenir_tpu_torch.probes      # all three at the main paths' shapes

prints one JSON object per probe and the card's name.
"""

from __future__ import annotations

import ctypes
import functools
import json
import statistics
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from avenir_tpu_torch.ops import hist
from avenir_tpu_torch.ops import knn as tk

TOURNEY_VARIANTS = {"dotonly": 0, "dotkey": 1, "full": 2, "full_insert": 3}
ONEHOT_VARIANTS = {"full": 0, "dotonly": 1}

_ENTRY = {
    "gram_probe": {
        "gram_probe_onehot": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9
        + [ctypes.c_void_p],
        "gram_probe_orient": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
        + [ctypes.c_void_p]},
}


@functools.lru_cache(maxsize=None)
def _kernel(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, its entry points typed."""
    from avenir_tpu_torch.ops import _build

    lib = _build.load(name)
    for entry, argtypes in _ENTRY[name].items():
        fn = getattr(lib, entry)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return lib


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Median per-call ms over ``iters`` calls, each bracketed by CUDA
    events, after ``warmup`` calls."""
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


def _on_cuda(*tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device.type != "cuda" or not t.is_contiguous():
            raise ValueError("the probes take contiguous CUDA tensors, got "
                             f"{t.device}")


def _splits(device: torch.device, ntiles: int, n: int) -> int:
    """Row ranges of a tile-per-block gram: about eight blocks per SM."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    pairs = ntiles * (ntiles + 1) // 2
    return max(1, min(-(-8 * sms // pairs), -(-n // 128)))


def knn_tourney_variant(a: torch.Tensor, b: torch.Tensor, variant: str,
                        used: Optional[int] = None):
    """One launch of ``csrc/knn_tourney.cu`` in ``variant`` on the operands
    of :func:`ops.knn.knn_tourney` → (k1, k2, k3); only ``full`` and
    ``full_insert`` give the keys."""
    tk._check_pair(a, b, "knn_tourney_variant")
    tk._check_cuda(a, b, "knn_tourney_variant", tk.TM, tk.SEG)
    m, n = a.shape[0], b.shape[0]
    nbp = tk._round_up(max(n // tk.SEG, 1), 128)
    out = torch.full((3, m, nbp), tk._PAD_KEY, dtype=torch.int32,
                     device=a.device)
    with torch.cuda.device(a.device):
        err = tk._kernel("knn_tourney").knn_tourney(
            a.data_ptr(), b.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
            out[2].data_ptr(), m, n, a.shape[1],
            tk.contraction_width(a.shape[1], used), nbp,
            TOURNEY_VARIANTS[variant],
            torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(f"knn_tourney ({variant}) failed with CUDA error {err}")
    return out[0], out[1], out[2]


def knn_tourney_probe(a: torch.Tensor, b: torch.Tensor,
                      used: Optional[int] = None, iters: int = 10,
                      variants: Sequence[str] = tuple(TOURNEY_VARIANTS)
                      ) -> Dict[str, float]:
    """B5's breakdown: ms per variant on these operands."""
    return {v: time_ms(lambda: knn_tourney_variant(a, b, v, used), iters)
            for v in variants}


def onehot_gram(codes_t: torch.Tensor, labels: torch.Tensor, num_bins: int,
                num_classes: int, variant: str = "full") -> torch.Tensor:
    """G of the one-hot MMA gram (``csrc/gram_probe.cu``) for an fmaj or
    jmaj shape of :func:`ops.hist.plan` → [wp, wp] int32; ``full`` equals
    :func:`ops.hist.cooc_counts_cols_ref`, ``dotonly`` is meaningless."""
    _on_cuda(codes_t, labels)
    f, n = codes_t.shape
    mode, jcp, wp = hist.plan(f, num_bins, num_classes)
    if mode not in ("fmaj", "jmaj"):
        raise ValueError(f"the one-hot gram takes fmaj and jmaj, not {mode}")
    g = torch.zeros((wp, wp), dtype=torch.int32, device=codes_t.device)
    with torch.cuda.device(codes_t.device):
        err = _kernel("gram_probe").gram_probe_onehot(
            codes_t.data_ptr(), labels.data_ptr(), g.data_ptr(), f, n,
            num_bins, num_classes, jcp, wp, int(mode == "fmaj"),
            _splits(codes_t.device, wp // 64, n), ONEHOT_VARIANTS[variant],
            torch.cuda.current_stream(codes_t.device).cuda_stream)
    if err:
        raise RuntimeError(f"gram_probe_onehot failed with CUDA error {err}")
    return g


def onehot_gram_probe(codes_t: torch.Tensor, labels: torch.Tensor,
                      num_bins: int, num_classes: int, iters: int = 20
                      ) -> Dict[str, float]:
    """The one-hot gram's breakdown beside B1: ms of ``full``, ``dotonly``
    and ``pair`` (the pair histogram, :func:`ops.hist.cooc_counts_cols`)."""
    times = {v: time_ms(lambda: onehot_gram(codes_t, labels, num_bins,
                                            num_classes, v), iters)
             for v in ONEHOT_VARIANTS}
    times["pair"] = time_ms(lambda: hist.cooc_counts_cols(
        codes_t, labels, num_bins, num_classes), iters)
    return times


def orient_gram(x: torch.Tensor, rows: bool) -> torch.Tensor:
    """XᵀX int32 of an int8 matrix given as [N, W] (``rows``) or [W, N],
    by the one-hot gram's mma.sync stage (``csrc/gram_probe.cu``); W a
    multiple of 64 and N of 128, the sums within int32."""
    _on_cuda(x)
    if x.dtype != torch.int8 or x.dim() != 2:
        raise TypeError(f"orient_gram takes a 2-D int8 matrix, got {x.dtype}")
    n, w = x.shape if rows else x.shape[::-1]
    g = torch.zeros((w, w), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        err = _kernel("gram_probe").gram_probe_orient(
            x.data_ptr(), g.data_ptr(), n, w, int(rows),
            _splits(x.device, w // 64, n),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"gram_probe_orient failed with CUDA error {err}")
    return g


def orient_gram_probe(x_rows: torch.Tensor, x_cols: torch.Tensor,
                      iters: int = 5) -> Dict[str, float]:
    """ms of the gram of one int8 matrix staged from [N, W] (``rows``) and
    from its transpose [W, N] (``cols``)."""
    return {"rows": time_ms(lambda: orient_gram(x_rows, True), iters),
            "cols": time_ms(lambda: orient_gram(x_cols, False), iters)}


def knn_operands(n: int, m: int, f: int, fc: int, nb: int, seed: int):
    """Seeded packed operands on the card, as the kNN paths build them:
    (q_mat, r_mat, used lanes)."""
    rng = np.random.default_rng(seed)
    codes_r = rng.integers(0, nb, (n, f)).astype(np.int32)
    cont_r = rng.random((n, fc), dtype=np.float32)
    codes_q = rng.integers(0, nb, (m, f)).astype(np.int32)
    cont_q = rng.random((m, fc), dtype=np.float32)
    r_mat, _ = tk.prepare_refs(codes_r, cont_r, nb)
    q_mat, _ = tk.prepare_queries(codes_q, cont_q, nb)
    return (q_mat.cuda(), r_mat.cuda(), tk.used_lanes(f, nb, fc))


def gram_operands(n: int, f: int, b: int, c: int, seed: int):
    """Seeded codes [F, n] and labels [n] int32 on the card."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    codes = torch.randint(0, b, (f, n), dtype=torch.int32, device="cuda",
                          generator=gen)
    labels = torch.randint(0, c, (n,), dtype=torch.int32, device="cuda",
                           generator=gen)
    return codes, labels


def orient_operands(n: int, w: int, seed: int):
    """A seeded int8 matrix in [−2, 2] as [N, W] and as its transpose: its
    gram's sums stay inside int32 for n < 2^28."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    x = torch.randint(-2, 3, (n, w), dtype=torch.int8, device="cuda",
                      generator=gen)
    return x, x.t().contiguous()


# the shapes of the main paths (chip_smoke.py): B5 at the 1M-row
# NearestNeighbor job (elearn: 9 continuous, w 60) and at knn_qps
# (6 × 10 + 8 continuous, w 114); the one-hot gram at a hospital MI chunk
# and at the wide tree's K = 1 level; the oriented gram at W 384, 16M rows
KNN_SHAPES = {"elearn w 60": (1_000_000, 4096, 0, 9, 10),
              "knn_qps w 114": (1_000_000, 4096, 6, 8, 10)}
GRAM_SHAPES = {"hospital chunk 10x13x2 fmaj, 250K rows": (250_000, 10, 13, 2),
               "wide tree K = 1 30x8x2 jmaj, 1M rows": (1_000_000, 30, 8, 2)}
ORIENT_SHAPE = (1 << 24, 384)


def main() -> int:
    import subprocess

    if not torch.cuda.is_available():
        raise SystemExit("the probes need an NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    for label, (n, m, f, fc, nb) in KNN_SHAPES.items():
        q, r, used = knn_operands(n, m, f, fc, nb, seed=1)
        print(json.dumps({"probe": "knn_tourney", "case": label,
                          "ms": knn_tourney_probe(q, r, used)}), flush=True)
        del q, r
    for label, (n, f, b, c) in GRAM_SHAPES.items():
        codes, labels = gram_operands(n, f, b, c, seed=2)
        print(json.dumps({"probe": "onehot_gram", "case": label,
                          "ms": onehot_gram_probe(codes, labels, b, c)}),
              flush=True)
    x_rows, x_cols = orient_operands(*ORIENT_SHAPE, seed=3)
    print(json.dumps({"probe": "orient_gram", "case": "W 384, 16M rows",
                      "ms": orient_gram_probe(x_rows, x_cols)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
