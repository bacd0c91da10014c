"""The plain reference of the e-learning kNN configuration: every query
against every reference, by brute force on the card in blocks of
queries.

It imports nothing of the program and works out again whatever the
program derives from the inputs: the scaling bounds (the references'
min and max), the scaled features, each d² (the float64 sum, feature by
feature, of the squared float32 differences, rounded to float32), the
order by (d², reference index), the distances and the votes.  The
control is the same search with the scaled features, their differences
and d² in bfloat16 (``precision="bf16"``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def bounds(refs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    return refs.min(axis=0), refs.max(axis=0)


def scale01(x: np.ndarray, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """float32 features scaled to [0, 1] by the bounds (a zero range
    counts as 1e-9)."""
    span = np.maximum(hi - lo, np.float32(1e-9))
    return np.clip((x - lo) / span, 0.0, 1.0).astype(np.float32)


def top_k(q01: torch.Tensor, r01: torch.Tensor, k: int,
          precision: str = "exact") -> Tuple[torch.Tensor, torch.Tensor]:
    """(d² [M, k] float32, index [M, k] int64) of each query's k nearest
    references, ordered by (d², index)."""
    m, n = q01.shape[0], r01.shape[0]
    dev = r01.device
    ids = torch.arange(n, device=dev)
    block = max(1, min(m, (1 << 27) // max(n, 1)))
    out_d, out_i = [], []
    for m0 in range(0, m, block):
        q = q01[m0:m0 + block]
        if precision == "exact":
            acc = torch.zeros((q.shape[0], n), dtype=torch.float64,
                              device=dev)
            for j in range(q.shape[1]):
                d = (q[:, j, None] - r01[None, :, j]).double()
                acc += d * d
        else:
            qb, rb = q.bfloat16(), r01.bfloat16()
            acc = torch.zeros((q.shape[0], n), dtype=torch.bfloat16,
                              device=dev)
            for j in range(q.shape[1]):
                d = qb[:, j, None] - rb[None, :, j]
                acc = acc + d * d
        d2 = acc.float()
        key = (d2.view(torch.int32).long() << 32) | ids
        del acc, d2
        top = torch.topk(key, k, dim=1, largest=False, sorted=True).values
        del key
        out_i.append(top & 0xFFFFFFFF)
        out_d.append((top >> 32).to(torch.int32).view(torch.float32))
    return torch.cat(out_d), torch.cat(out_i)


def distances(d2: torch.Tensor, num_features: int) -> torch.Tensor:
    """sqrt(d² / features) in [0, 1]: the division in float32, the root
    in float64, rounded once."""
    total = torch.tensor(float(num_features), dtype=torch.float32,
                         device=d2.device)
    d = d2.clamp_min(0.0) / total
    return torch.sqrt(d.double()).float().clamp(0.0, 1.0)


def votes(labels: np.ndarray, idx: np.ndarray, num_classes: int) -> np.ndarray:
    """The class with most of the k neighbours' votes, the first on a tie."""
    neigh = labels[idx]
    counts = np.stack([(neigh == c).sum(axis=1) for c in range(num_classes)],
                      axis=1)
    return counts.argmax(axis=1)


def answers(ref_x: np.ndarray, ref_y: np.ndarray, q_x: np.ndarray, k: int,
            num_classes: int, device, precision: str = "exact"):
    """(distances [M, k], indices [M, k], predicted [M]) as numpy."""
    lo, hi = bounds(ref_x)
    r01 = torch.from_numpy(scale01(ref_x, lo, hi)).to(device)
    q01 = torch.from_numpy(scale01(q_x, lo, hi)).to(device)
    d2, idx = top_k(q01, r01, k, precision)
    dist = distances(d2, ref_x.shape[1]).cpu().numpy()
    idx = idx.cpu().numpy()
    return dist, idx, votes(ref_y, idx, num_classes)
