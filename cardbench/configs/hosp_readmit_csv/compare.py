"""The numbers that decide ``correct`` in the CSV cell, read from one
job's written part files (the program's, or the control's lines)
against the reference:

- ``counts_off``: the largest absolute difference of any count the NB
  file carries: each class x feature x bin count, each bin's total and
  each class count (a count the file leaves out is 0);
- ``mi_gap``: the largest absolute difference of any MI statistic the
  MI file prints (every feature's and pair's, and the ``mim`` ranking's
  scores) from the reference's float64 statistics.

A file that is missing, has a line the format does not know, misses a
statistic or holds one twice, or ranks the features out of order reads
``inf``.  The NB file holds counts alone, so a scoring job's log tables,
made from them, are the reference's wherever ``counts_off`` is 0.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Iterable, List, Optional

import numpy as np

from cardbench.configs.hosp_readmit import reference as tables_ref

from . import reference

INF = float("inf")
PART = "part-00000"
MI_FAMILIES = {"featurePairMI": "feature_pair_mi",
               "featurePairClassMI": "pair_class_mi",
               "featurePairClassCondMI": "feature_pair_class_cond_mi"}


def read_part(directory: str) -> Optional[List[str]]:
    """A stage's written lines, or None where its part file is missing."""
    path = os.path.join(directory, PART)
    if not os.path.exists(path):
        return None
    with open(path) as fh:
        return [ln.rstrip("\n") for ln in fh if ln.strip()]


def nb_counts(lines: List[str], schema: dict) -> Optional[dict]:
    """{"class", "fbc", "total"} read from an NB file; None where a line
    does not parse."""
    feats = reference.features(schema)
    nb = reference.n_bins(schema)
    classes = reference.class_field(schema)["cardinality"]
    cpos = {c: i for i, c in enumerate(classes)}
    fpos = {str(f["ordinal"]): k for k, f in enumerate(feats)}
    labels = [{reference.bin_label(f, b): b for b in range(n)}
              for f, n in zip(feats, nb)]
    fbc = np.zeros((len(feats), max(nb), len(classes)), np.int64)
    total = np.zeros((len(feats), max(nb)), np.int64)
    cc = np.zeros(len(classes), np.int64)
    for line in lines:
        cols = line.split(",")
        try:
            cls, ordinal, label, n = cols
            n = int(n)
            if not ordinal and not label:
                cc[cpos[cls]] += n
                continue
            k = fpos[ordinal]
            b = labels[k][label]
            if cls:
                fbc[k, b, cpos[cls]] += n
            else:
                total[k, b] += n
        except (KeyError, ValueError):
            return None
    return {"class": cc, "fbc": fbc, "total": total}


def mi_values(lines: List[str], schema: dict) -> Optional[Dict[str, np.ndarray]]:
    """The MI file's statistics by the reference's names, and the
    ``mim`` scores as ``mim``; None where a line does not parse, a value
    is missing or given twice, or the ranking is out of order."""
    names = [f["name"] for f in reference.features(schema)]
    fpos = {n: k for k, n in enumerate(names)}
    ppos = {(names[i], names[j]): k
            for k, (i, j) in enumerate(tables_ref.pairs(len(names)))}
    out = {k: np.full(len(names), np.nan) for k in ("feature_class_mi", "mim")}
    out.update({k: np.full(len(ppos), np.nan) for k in MI_FAMILIES.values()})
    ranked: List[float] = []
    scores = False
    try:
        for line in lines:
            cols = line.split(",")
            if cols == ["featureScore:mim"] and not scores:
                scores = True
                continue
            if scores and len(cols) == 2:
                slot, at, value = "mim", fpos[cols[0]], float(cols[1])
                ranked.append(value)
            elif scores:
                return None
            elif cols[0] == "featureClassMI" and len(cols) == 3:
                slot, at, value = "feature_class_mi", fpos[cols[1]], float(cols[2])
            elif cols[0] in MI_FAMILIES and len(cols) == 4:
                slot = MI_FAMILIES[cols[0]]
                at, value = ppos[(cols[1], cols[2])], float(cols[3])
            else:
                return None
            if not np.isnan(out[slot][at]):
                return None
            out[slot][at] = value
    except (KeyError, ValueError, IndexError):
        return None
    if any(np.isnan(v).any() for v in out.values()) \
            or any(a < b for a, b in zip(ranked, ranked[1:])):
        return None
    return out


def _absmax(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b))) if a.size else 0.0


def job_gaps(files: Dict[str, Optional[List[str]]], ref, schema: dict
             ) -> Dict[str, float]:
    """The two numbers of one job from its ``bayes`` and ``mi`` lines
    (None for a file that is missing)."""
    t = ref.tables
    nb = nb_counts(files["bayes"], schema) if files.get("bayes") else None
    counts_off = INF if nb is None else max(
        _absmax(nb["class"], t["class"]), _absmax(nb["fbc"], t["fbc"]),
        _absmax(nb["total"], np.asarray(t["fbc"]).sum(-1)))
    mi = mi_values(files["mi"], schema) if files.get("mi") else None
    if mi is None:
        mi_gap = INF
    else:
        want = dict(ref.mi, mim=ref.mi["feature_class_mi"])
        mi_gap = max(_absmax(v, want[k]) for k, v in mi.items())
    return {"counts_off": counts_off, "mi_gap": mi_gap}


def worst(gaps: Iterable[Dict[str, float]]) -> Dict[str, float]:
    """The largest reading of each number over many jobs."""
    out: Dict[str, float] = {}
    for g in gaps:
        for k, v in g.items():
            out[k] = max(out.get(k, -math.inf), v)
    return out
