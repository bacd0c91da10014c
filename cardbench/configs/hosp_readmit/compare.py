"""The numbers that decide ``correct`` in a hospital cell, from one job's
outputs (the program's NB model and MI result, or the control's) against
the reference.

- ``counts_off``: the largest absolute difference of any count: the
  class counts, the NB feature × class table, the MI feature × class
  table and every pair × class table;
- ``nb_gap``: the largest absolute difference of the NB log prior and
  log posterior from the reference's float64 tables;
- ``mi_gap``: the largest absolute difference of any MI statistic from
  the reference's float64 statistics.

A result that lacks a pair, or a table of another shape, reads ``inf``.
"""

from __future__ import annotations

from typing import Dict, Iterable

import numpy as np

FEATURE_FIELDS = ("feature_class_mi", "feature_entropy", "class_entropy")
PAIR_FIELDS = ("feature_pair_mi", "pair_class_mi", "pair_class_entropy",
               "feature_pair_class_cond_mi")


def _absmax(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        return float("inf")
    return float(np.max(np.abs(a - b))) if a.size else 0.0


def job_gaps(outputs, ref) -> Dict[str, float]:
    nb, mi = outputs["nb"], outputs["mi"]
    t = ref.tables
    nb_gap = max(_absmax(nb.log_prior, ref.log_prior),
                 _absmax(nb.log_posterior, ref.log_posterior))
    pos = {p: k for k, p in enumerate(ref.pairs)}
    index = [tuple(int(x) for x in p)
             for p in np.asarray(mi.pair_index).reshape(-1, 2)]
    if sorted(index) != sorted(pos):
        return {"counts_off": float("inf"), "nb_gap": nb_gap,
                "mi_gap": float("inf")}
    order = [pos[p] for p in index]
    counts_off = max(_absmax(nb.class_counts, t["class"]),
                     _absmax(nb.bin_counts, t["fbc"]),
                     _absmax(mi.class_counts, t["class"]),
                     _absmax(mi.feature_class_counts, t["fbc"]),
                     _absmax(mi.pair_class_counts, t["pcc"][order]))
    mi_gap = max([_absmax(getattr(mi, k), ref.mi[k]) for k in FEATURE_FIELDS]
                 + [_absmax(getattr(mi, k), ref.mi[k][order])
                    for k in PAIR_FIELDS])
    return {"counts_off": counts_off, "nb_gap": nb_gap, "mi_gap": mi_gap}


def worst(gaps: Iterable[Dict[str, float]]) -> Dict[str, float]:
    """The largest reading of each number over many jobs."""
    out: Dict[str, float] = {}
    for g in gaps:
        for k, v in g.items():
            out[k] = max(out.get(k, float("-inf")), v)
    return out
