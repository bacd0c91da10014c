"""The numbers that decide ``correct`` in a kNN cell, over the query
batches checked:

- ``idx_off``: neighbour slots (query, rank) whose reference index is
  not the reference's;
- ``dist_off``: the largest absolute difference of a neighbour's
  distance from the reference's at the same rank;
- ``pred_off``: queries whose predicted class is not the reference's.

An answer of another shape reads ``inf``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def batch_gaps(dist, idx, pred, ref) -> Dict[str, float]:
    r_dist, r_idx, r_pred = ref
    dist, idx, pred = np.asarray(dist), np.asarray(idx), np.asarray(pred)
    if dist.shape != r_dist.shape or idx.shape != r_idx.shape \
            or pred.shape != r_pred.shape:
        return {"idx_off": float("inf"), "dist_off": float("inf"),
                "pred_off": float("inf")}
    return {"idx_off": float(np.sum(idx != r_idx)),
            "dist_off": float(np.max(np.abs(dist.astype(np.float64)
                                            - r_dist.astype(np.float64)))),
            "pred_off": float(np.sum(pred != r_pred))}


def total(gaps) -> Dict[str, float]:
    """Counts summed and the distance gap's maximum over the batches."""
    out = {"idx_off": 0.0, "dist_off": 0.0, "pred_off": 0.0}
    for g in gaps:
        out["idx_off"] += g["idx_off"]
        out["pred_off"] += g["pred_off"]
        out["dist_off"] = max(out["dist_off"], g["dist_off"])
    return out
