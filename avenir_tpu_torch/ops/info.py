"""Information-theoretic statistics over count tensors — port of the
mutual-information family of ``avenir_tpu/ops/info.py`` (the reference's
explore/MutualInformation.java:598-784).

Pure float32 functions over the trailing axes (leading axes batch over
feature pairs), safe on empty cells (0·log 0 = 0 via masked logs), exactly
as the JAX package computes them.
"""

from __future__ import annotations

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
