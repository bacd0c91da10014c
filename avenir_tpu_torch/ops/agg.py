"""Count tensors and their host-side accumulation — port of
``avenir_tpu/ops/agg.py``.

Every reducer of the reference's NB and MI jobs is a class-conditional count
(bayesian/BayesianDistribution.java:137-328,
explore/MutualInformation.java:136-403).  Here each is one integer
``bincount`` over a flattened cell index, so counts are exact and equal to
the JAX package's einsum counts cell for cell.  Per-chunk results are int32;
:class:`Accumulator` sums them in 64-bit on the host.

Drop-invalid contract (shared with the co-occurrence gram, ``ops/hist.py``):
a code outside [0, B) drops its cell, a label outside [0, C) drops the whole
row, and an empty chunk gives zeros.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from avenir_tpu_torch.telemetry import spans as tel

# The JAX einsum path sums float32 one-hots, exact only below 2^24 per cell;
# chunks stay under this cap on every path so per-chunk int32 counts are
# exact and the paths stay interchangeable.
MAX_EXACT_CHUNK_ROWS = 1 << 24


def check_chunk(n: int) -> None:
    if n >= MAX_EXACT_CHUNK_ROWS:
        raise ValueError(
            f"chunk of {n} rows exceeds the exact-count limit "
            f"{MAX_EXACT_CHUNK_ROWS}; split the stream into smaller chunks")


def one_hot(x: torch.Tensor, k: int, dtype=torch.float32) -> torch.Tensor:
    """One-hot encode along a new last axis of width ``k``; an
    out-of-range index (e.g. -1) gives an all-zero row, as
    ``jax.nn.one_hot`` does."""
    return (x.long()[..., None] == torch.arange(k, device=x.device)).to(dtype)


def _valid_labels(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    return (labels >= 0) & (labels < num_classes)


def _count(idx: torch.Tensor, keep: torch.Tensor, size: int) -> torch.Tensor:
    """int32 histogram of ``idx[keep]`` over [0, size)."""
    return torch.bincount(idx[keep].long(), minlength=size).to(torch.int32)


def class_counts(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """labels [N] → [C] class-prior counts."""
    check_chunk(labels.shape[0])
    return _count(labels, _valid_labels(labels, num_classes), num_classes)


def feature_counts(codes: torch.Tensor, num_bins: int) -> torch.Tensor:
    """codes [N, F] → [F, B] per-feature bin histograms (feature priors)."""
    check_chunk(codes.shape[0])
    f = codes.shape[1]
    codes = codes.long()
    keep = (codes >= 0) & (codes < num_bins)
    idx = torch.arange(f, device=codes.device)[None, :] * num_bins + codes
    return _count(idx, keep, f * num_bins).reshape(f, num_bins)


def feature_class_counts(codes: torch.Tensor, labels: torch.Tensor,
                         num_classes: int, num_bins: int) -> torch.Tensor:
    """codes [N, F], labels [N] → [F, B, C] class-conditional bin counts
    (the Naive-Bayes training shuffle)."""
    check_chunk(codes.shape[0])
    f = codes.shape[1]
    c, b = num_classes, num_bins
    codes = codes.long()
    lab = labels.long()[:, None]
    keep = (_valid_labels(labels, c)[:, None]
            & (codes >= 0) & (codes < b))                      # [N, F]
    feat = torch.arange(f, device=codes.device)[None, :]
    idx = (feat * b + codes) * c + lab
    return _count(idx, keep, f * b * c).reshape(f, b, c)


def pair_class_counts(codes_i: torch.Tensor, codes_j: torch.Tensor,
                      labels: torch.Tensor, num_classes: int,
                      num_bins: int) -> torch.Tensor:
    """codes_i [N, P], codes_j [N, P], labels [N] → [P, B, B, C]
    feature-pair × class joint counts (the MI job's pair tables)."""
    check_chunk(codes_i.shape[0])
    p = codes_i.shape[1]
    c, b = num_classes, num_bins
    ci, cj = codes_i.long(), codes_j.long()
    lab = labels.long()[:, None]
    keep = (_valid_labels(labels, c)[:, None]
            & (ci >= 0) & (ci < b) & (cj >= 0) & (cj < b))    # [N, P]
    pair = torch.arange(p, device=ci.device)[None, :]
    idx = ((pair * b + ci) * b + cj) * c + lab
    return _count(idx, keep, p * b * b * c).reshape(p, b, b, c)


def pair_class_counts_at(codes: torch.Tensor, labels: torch.Tensor,
                         pairs: torch.Tensor, num_classes: int,
                         num_bins: int) -> torch.Tensor:
    """codes [N, F], labels [N], pairs [P, 2] feature indices → the
    [P, B, B, C] :func:`pair_class_counts` of those pairs' columns."""
    pairs = pairs.to(codes.device)
    return pair_class_counts(codes[:, pairs[:, 0]], codes[:, pairs[:, 1]],
                             labels, num_classes, num_bins)


def pair_counts(codes_i: torch.Tensor, codes_j: torch.Tensor,
                num_bins: int) -> torch.Tensor:
    """codes_i [N, P], codes_j [N, P] → [P, B, B] joint histograms of P
    feature pairs (the MI job's feature-pair distributions)."""
    check_chunk(codes_i.shape[0])
    p, b = codes_i.shape[1], num_bins
    ci, cj = codes_i.long(), codes_j.long()
    keep = (ci >= 0) & (ci < b) & (cj >= 0) & (cj < b)
    idx = (torch.arange(p, device=ci.device)[None, :] * b + ci) * b + cj
    return _count(idx, keep, p * b * b).reshape(p, b, b)


def nb_mi_pipeline_step(codes: torch.Tensor, labels: torch.Tensor, ci, cj,
                        num_classes: int, num_bins: int):
    """The NB + MI counts of a chunk in one pass: → (fbc [F, B, C], pair
    [P, B, B, C]) for the P pairs (ci, cj).  The F diagonal pairs (f, f)
    ride along, since the [a, a, c] diagonal of an (f, f) joint is f's
    class-conditional bin count."""
    f = codes.shape[1]
    dev = codes.device
    diag = torch.arange(f, device=dev)
    cia = torch.cat([torch.as_tensor(ci, device=dev).long(), diag])
    cja = torch.cat([torch.as_tensor(cj, device=dev).long(), diag])
    all_counts = pair_class_counts(codes[:, cia], codes[:, cja], labels,
                                   num_classes, num_bins)
    ar = torch.arange(num_bins, device=dev)
    return all_counts[len(ci):, ar, ar, :], all_counts[:len(ci)]


MOMENT_BLOCK_ROWS = 1024


def class_moments(values: torch.Tensor, labels: torch.Tensor,
                  num_classes: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """values [N, Fc] float32, labels [N] → (count [C], Σx [C, Fc],
    Σx² [C, Fc]) summed in float64.

    Where the JAX package's float32 sums are exact (every partial sum
    representable, e.g. integer-valued data) these are the same numbers.
    Elsewhere a float32 Σx² of a 250K-row chunk is off by ~1e-5 relative
    in an order each device's matmul chooses, and NB's variance
    E[x²] − mean² magnifies that (hospital weights over 1M rows: NB's std
    1.8e-4 apart between an H100 and the CPU).  In float64 each block of
    MOMENT_BLOCK_ROWS rows is one product, and the blocks' sums are added
    after: however a device orders a block, a sum of positive terms is
    within ~(1024 + N/1024)·2⁻⁵³ of exact, so the two devices agree to
    ~1e-13 relative where one product over 1M rows left Σx² 1.3e-12
    apart (NumericalAttrStats on the hospital CSV on an H100, PERF.md
    §6)."""
    check_chunk(values.shape[0])
    oh = torch.nn.functional.one_hot(
        torch.where(_valid_labels(labels, num_classes), labels.long(),
                    num_classes), num_classes + 1)[:, :num_classes]
    oh = oh.to(torch.float64)                                  # [N, C]
    x = values.to(torch.float64)
    nb = -(-values.shape[0] // MOMENT_BLOCK_ROWS)
    pad = (0, 0, 0, nb * MOMENT_BLOCK_ROWS - values.shape[0])
    ohb = torch.nn.functional.pad(oh, pad).view(
        nb, MOMENT_BLOCK_ROWS, num_classes).transpose(1, 2)   # [nb, C, blk]
    xb = torch.nn.functional.pad(x, pad).view(nb, MOMENT_BLOCK_ROWS, x.shape[1])
    return (oh.sum(0), torch.bmm(ohb, xb).sum(0),
            torch.bmm(ohb, xb * xb).sum(0))


def segment_count(segments: torch.Tensor, num_segments: int) -> torch.Tensor:
    """[M] segment ids → [num_segments] int32 histogram."""
    check_chunk(segments.shape[0])
    seg = segments.long()
    return _count(seg, (seg >= 0) & (seg < num_segments), num_segments)


def transition_counts(a: torch.Tensor, b: torch.Tensor, num_a: int,
                      num_b: int) -> torch.Tensor:
    """a [M], b [M] paired codes → [num_a, num_b] int32 co-occurrence counts
    (Markov state transitions, HMM emissions); a pair with either code out
    of range counts nothing."""
    check_chunk(a.shape[0])
    a, b = a.long(), b.long()
    keep = (a >= 0) & (a < num_a) & (b >= 0) & (b < num_b)
    return _count(a * num_b + b, keep, num_a * num_b).reshape(num_a, num_b)


def weighted_transition_counts(a: torch.Tensor, b: torch.Tensor,
                               w: torch.Tensor, num_a: int, num_b: int
                               ) -> torch.Tensor:
    """[num_a, num_b] float32 sums of ``w`` over the pairs (a, b) — the
    partially tagged HMM's window weights.  Summed in float64 and rounded
    once, so the result does not hang on the order a device adds in; it is
    the JAX package's float32 einsum wherever that is exact (the default
    dyadic window below 2^22 pairs a cell)."""
    check_chunk(a.shape[0])
    a, b = a.long(), b.long()
    keep = (a >= 0) & (a < num_a) & (b >= 0) & (b < num_b)
    sums = torch.bincount((a * num_b + b)[keep],
                          weights=w[keep].to(torch.float64),
                          minlength=num_a * num_b)
    return sums.to(torch.float32).reshape(num_a, num_b)


class Accumulator:
    """Sums per-chunk results into int64/float64 numpy totals on the host,
    so streams of any length neither overflow nor lose counts."""

    def __init__(self):
        self._totals = {}

    def add(self, name: str, value) -> None:
        """Fold ``value`` into the total ``name``.  Traced as two spans:
        ``acc.fetch`` (a tensor's copy to the host, waiting for the device
        work behind it; attr ``bytes``) and ``acc.add`` (the widening and
        the add)."""
        tracer = tel.tracer()
        if isinstance(value, torch.Tensor):
            with tracer.span("acc.fetch") as sp:
                value = value.cpu().numpy()
                sp.set("bytes", value.nbytes)
        with tracer.span("acc.add"):
            arr = np.asarray(value)
            arr = (arr.astype(np.int64)
                   if np.issubdtype(arr.dtype, np.integer)
                   else arr.astype(np.float64))
            if name in self._totals:
                self._totals[name] = self._totals[name] + arr
            else:
                self._totals[name] = arr

    def get(self, name: str) -> np.ndarray:
        return self._totals[name]

    def __contains__(self, name: str) -> bool:
        return name in self._totals

    def names(self):
        return list(self._totals)

    def state(self) -> dict:
        """name → numpy total, a copy."""
        return {k: np.array(v) for k, v in self._totals.items()}

    def load(self, state: dict) -> None:
        """Replace the totals with ``state``."""
        self._totals = {k: np.asarray(v) for k, v in state.items()}
