"""Information-theoretic statistics over count tensors — port of the
mutual-information family of ``avenir_tpu/ops/info.py`` (the reference's
explore/MutualInformation.java:598-784).

Pure float32 functions over the trailing axes (leading axes batch over
feature pairs), safe on empty cells (0·log 0 = 0 via masked logs), exactly
as the JAX package computes them.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-12


def _safe_log(x: torch.Tensor) -> torch.Tensor:
    return torch.log(torch.where(x > 0, x, torch.ones_like(x)))


def normalize(counts: torch.Tensor, axis=None) -> torch.Tensor:
    """Counts → probabilities along ``axis`` (all mass if None)."""
    if axis is None:
        total = counts.sum()
    else:
        total = counts.sum(dim=axis, keepdim=True)
    return counts / torch.clamp(total, min=_EPS)


def entropy(p: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Shannon entropy (nats) of a probability vector along ``axis``."""
    return -(p * _safe_log(p)).sum(dim=axis)


def entropy_from_counts(counts: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return entropy(normalize(counts, axis=axis), axis=axis)


def gini(p: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Gini impurity 1 − Σp²."""
    return 1.0 - (p * p).sum(dim=axis)


def gini_from_counts(counts: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return gini(normalize(counts, axis=axis), axis=axis)


def hellinger_distance(p: torch.Tensor, q: torch.Tensor,
                       axis: int = -1) -> torch.Tensor:
    """Hellinger distance between two distributions along ``axis``."""
    d = ((torch.sqrt(p) - torch.sqrt(q)) ** 2).sum(dim=axis)
    return torch.sqrt(torch.clamp(d, min=0.0)) / math.sqrt(2.0)


def cumulative_level_table(table: torch.Tensor) -> torch.Tensor:
    """[F, B, K, C] level table → its inclusive prefix sum over the bin
    axis, ``cum[f, b] = Σ_{b' ≤ b} table[f, b']`` (exact in integer
    dtypes): every sorted threshold's left histogram is one row of it."""
    return torch.cumsum(table, dim=1, dtype=table.dtype)


def binary_split_histograms(cum: torch.Tensor, attr_of: torch.Tensor,
                            thr_of: torch.Tensor) -> torch.Tensor:
    """``cum`` [F, B, K, C] (the bin prefix sum of the level table),
    ``attr_of`` [S], ``thr_of`` [S] (codes < t go left) → [S, 2, K, C]
    segment×class histograms: left = cum[a, t−1], right = node total −
    left.  Equal to :func:`split_segment_histograms` for the same (a, t)."""
    left = cum[attr_of, thr_of - 1]                    # [S, K, C]
    total = cum[attr_of, -1]                           # [S, K, C]
    return torch.stack([left, total - left], dim=1)    # [S, 2, K, C]


def split_segment_histograms(table: torch.Tensor, seg_tab: torch.Tensor,
                             attr_of: torch.Tensor, gmax: int) -> torch.Tensor:
    """[F, B, K, C] level table, ``seg_tab`` [S, B] bin→segment maps and
    ``attr_of`` [S] → [S, G, K, C] per-split segment×class histograms, an
    exact integer contraction (in float64, which holds every count exactly;
    CUDA has no integer matmul).  Segments ≥ a split's segment count come
    out all-zero."""
    grange = torch.arange(gmax, dtype=seg_tab.dtype, device=seg_tab.device)
    m = (seg_tab[:, None, :] == grange[None, :, None]).to(torch.float64)
    t = table[attr_of].to(torch.float64)                 # [S, B, K, C]
    s_, b, k, c = t.shape
    h = torch.bmm(m, t.reshape(s_, b, k * c)).reshape(s_, gmax, k, c)
    return h.to(table.dtype)


def mutual_information(joint_counts: torch.Tensor) -> torch.Tensor:
    """MI(X;Y) in nats from joint counts [..., A, B]; empty cells
    contribute zero, matching the reference's skip-if-zero loops."""
    c = joint_counts.to(torch.float32)
    total = torch.clamp(c.sum(dim=(-2, -1), keepdim=True), min=_EPS)
    p = c / total
    pa = p.sum(dim=-1, keepdim=True)           # [..., A, 1]
    pb = p.sum(dim=-2, keepdim=True)           # [..., 1, B]
    ratio = p / torch.clamp(pa * pb, min=_EPS)
    return (p * _safe_log(ratio)).sum(dim=(-2, -1))


def conditional_mutual_information(joint_counts_z: torch.Tensor) -> torch.Tensor:
    """I(X;Y|Z) from counts [..., A, B, Z]: Σ_z p(z) · MI(X;Y | Z=z)."""
    c = joint_counts_z.to(torch.float32)
    total = torch.clamp(c.sum(dim=(-3, -2, -1), keepdim=True), min=_EPS)
    pz = c.sum(dim=(-3, -2)) / total.squeeze(-2).squeeze(-2)    # [..., Z]
    mi_given_z = mutual_information(torch.movedim(c, -1, -3))   # [..., Z]
    return (pz * mi_given_z).sum(dim=-1)
