"""The plain reference of the CSV configuration: each part file's bytes
parsed with NumPy, binned by the schema's rule, counted; a job's tables
the sum of its parts'; NB and MI from the tables.

It imports nothing of the program.  The parse is the tutorial's
format and nothing more: newline-ended lines of twelve comma-separated
fields, a line with another count raises.  Binning (the ``encoding``
line of the configuration): a numeric feature's code is ``floor(v /
bucketWidth) - floor(min / bucketWidth)``, a categorical one's its
index in ``cardinality``, a value outside it the one bin past them, a
class outside the class values counts nowhere.  The counting, the
float64 NB log tables and MI statistics are the ``hosp_readmit``
configuration's reference (``count_tables``, ``from_tables``), already
held against its control.

The control (:func:`control_lines`) is the same one precision step down,
written as the program writes its part files (:func:`nb_lines`,
:func:`mi_lines`): the counts summed over the parts in float32, the MI
statistics in bfloat16.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from cardbench.configs.hosp_readmit import reference as tables_ref

NEWLINE, COMMA = 10, 44


def features(schema: dict) -> List[dict]:
    return [f for f in sorted(schema["fields"], key=lambda f: f["ordinal"])
            if f.get("feature")]


def class_field(schema: dict) -> dict:
    return [f for f in schema["fields"] if f["name"] == "readmitted"][0]


def n_bins(schema: dict) -> List[int]:
    out = []
    for f in features(schema):
        if f["dataType"] == "categorical":
            out.append(len(f["cardinality"]) + 1)
        else:
            bw = f["bucketWidth"]
            out.append(math.floor(f["max"] / bw) - math.floor(f["min"] / bw)
                       + 1)
    return out


def _words(buf: np.ndarray) -> np.ndarray:
    """uint64 [len(buf)]: element ``i`` the eight bytes from ``i`` (little
    endian, zeros past the end), a strided view of a padded copy."""
    padded = np.concatenate([buf, np.zeros(16, np.uint8)])
    return np.ndarray((len(buf) + 8,), np.dtype("<u8"), padded,
                      strides=(1,))


def _word(words, start, length, k: int) -> np.ndarray:
    """The ``k``-th eight bytes of each field, zero past its length."""
    n = np.clip(length - 8 * k, 0, 8).astype(np.uint64)
    keep = np.where(n == 8, np.uint64(2 ** 64 - 1),
                    (np.uint64(1) << (np.uint64(8) * n)) - np.uint64(1))
    return words[start + 8 * k] & keep


def _categories(words, start, length, names: Sequence[str]) -> np.ndarray:
    """Each field's index in ``names``; ``len(names)`` for any other
    value."""
    tokens = [n.encode() for n in names]
    width = -(-max(len(t) for t in tokens) // 8)
    keys = [_word(words, start, length, k) for k in range(width)]
    code = np.full(len(start), len(tokens), np.int32)
    for i, t in enumerate(tokens):
        hit = length == len(t)
        for key, want in zip(keys, np.frombuffer(t.ljust(8 * width, b"\0"),
                                                 "<u8")):
            hit &= key == want
        code[hit] = i
    return code


def _number(words, start, length) -> np.ndarray:
    """Each field's decimal digits (at most eight) as an int64; an empty
    field, one of more digits or with another character raises."""
    if length.size and (int(length.min()) < 1 or int(length.max()) > 8):
        raise ValueError("a numeric field of no digit or more than eight")
    key = _word(words, start, length, 0)
    value = np.zeros(len(start), np.int64)
    for j in range(int(length.max()) if length.size else 0):
        live = j < length
        d = ((key >> np.uint64(8 * j)) & np.uint64(255)).astype(np.int64) - 48
        if np.any(live & ((d < 0) | (d > 9))):
            raise ValueError("a numeric field with a non-digit")
        value = np.where(live, value * 10 + d, value)
    return value


def parse(data: bytes, schema: dict):
    """(int32 codes [rows, F], int32 labels [rows]) of one part's text."""
    buf = np.frombuffer(data, np.uint8)
    ends = np.flatnonzero(buf == NEWLINE)
    if len(buf) and (not len(ends) or ends[-1] != len(buf) - 1):
        raise ValueError("the text does not end with a newline")
    rows = len(ends)
    nfields = len(schema["fields"])
    commas = np.flatnonzero(buf == COMMA)
    if len(commas) != rows * (nfields - 1):
        raise ValueError("a line without its fields")
    commas = commas.reshape(rows, nfields - 1)
    starts = np.concatenate([[0], ends[:-1] + 1]).astype(np.int64)
    if rows and (np.any(commas[:, 0] < starts) or np.any(commas[:, -1] > ends)):
        raise ValueError("a line without its fields")
    bounds = np.concatenate([starts[:, None] - 1, commas, ends[:, None]],
                            axis=1)                       # [rows, fields + 1]
    first = bounds[:, :-1] + 1
    length = bounds[:, 1:] - first
    words = _words(buf)
    codes = np.empty((rows, len(features(schema))), np.int32)
    for k, f in enumerate(features(schema)):
        o = f["ordinal"]
        if f["dataType"] == "categorical":
            codes[:, k] = _categories(words, first[:, o], length[:, o],
                                      f["cardinality"])
        else:
            bw = f["bucketWidth"]
            codes[:, k] = (np.floor_divide(
                _number(words, first[:, o], length[:, o]), bw)
                - math.floor(f["min"] / bw))
    cf = class_field(schema)
    o = cf["ordinal"]
    labels = _categories(words, first[:, o], length[:, o],
                         cf["cardinality"])
    labels[labels == len(cf["cardinality"])] = -1
    return codes, labels


def part_tables(path: str, schema: dict, device="cpu"
                ) -> Dict[str, np.ndarray]:
    """One part file's exact int64 count tables, on the host."""
    with open(path, "rb") as fh:
        codes, labels = parse(fh.read(), schema)
    return tables_ref.on_host(tables_ref.count_tables(
        torch.from_numpy(codes).to(device),
        torch.from_numpy(labels).to(device), n_bins(schema),
        len(class_field(schema)["cardinality"])))


def job_tables(parts: Sequence[Dict[str, np.ndarray]], dtype=np.int64
               ) -> Dict[str, np.ndarray]:
    """A job's tables: its parts' summed in ``dtype``."""
    return {k: sum(p[k].astype(dtype) for p in parts) for k in parts[0]}


def from_tables(tables, schema: dict, laplace: float):
    """The reference's NB log tables and MI statistics (float64)."""
    return tables_ref.from_tables(tables, n_bins(schema), laplace)


# -- the part files as the jobs write them -------------------------------------

def bin_label(f: dict, code: int) -> str:
    """A bin's label in the NB file: the absolute bin id of a numeric
    feature, the value of a categorical one."""
    if f["dataType"] == "categorical":
        return (f["cardinality"][code] if code < len(f["cardinality"])
                else "__OOV__")
    return str(code + math.floor(f["min"] / f["bucketWidth"]))


def nb_lines(tables, schema: dict) -> List[str]:
    """The BayesianDistribution part file of these count tables: a
    ``class,ordinal,bin,count`` line for each non-zero count, a
    ``,ordinal,bin,total`` line for each bin with any, a ``class,,,count``
    line for each class."""
    fbc, cc = tables["fbc"], tables["class"]
    classes = class_field(schema)["cardinality"]
    out = []
    for k, (f, nb) in enumerate(zip(features(schema), n_bins(schema))):
        for b in range(nb):
            label = bin_label(f, b)
            total = 0
            for c, cv in enumerate(classes):
                n = int(fbc[k, b, c])
                total += n
                if n:
                    out.append(f"{cv},{f['ordinal']},{label},{n}")
            if total:
                out.append(f",{f['ordinal']},{label},{total}")
    out += [f"{cv},,,{int(cc[c])}" for c, cv in enumerate(classes)]
    return out


def mi_lines(mi: Dict[str, np.ndarray], schema: dict) -> List[str]:
    """The MutualInformation part file of these statistics: every
    feature's and pair's MI, six decimals, then the ``mim`` ranking."""
    names = [f["name"] for f in features(schema)]
    out = [f"featureClassMI,{n},{mi['feature_class_mi'][k]:.6f}"
           for k, n in enumerate(names)]
    for k, (i, j) in enumerate(tables_ref.pairs(len(names))):
        a, b = names[i], names[j]
        out += [f"featurePairMI,{a},{b},{mi['feature_pair_mi'][k]:.6f}",
                f"featurePairClassMI,{a},{b},{mi['pair_class_mi'][k]:.6f}",
                f"featurePairClassCondMI,{a},{b},"
                f"{mi['feature_pair_class_cond_mi'][k]:.6f}"]
    out.append("featureScore:mim")
    fc = np.asarray(mi["feature_class_mi"], np.float64)
    out += [f"{names[k]},{fc[k]:.6f}" for k in np.argsort(-fc, kind="stable")]
    return out


def control_lines(parts: Sequence[Dict[str, np.ndarray]], schema: dict
                  ) -> Dict[str, List[str]]:
    """The control's part files for a job of these parts: the tables
    summed in float32 and the MI statistics in bfloat16.  The NB file
    carries the counts alone, so NB's float32 log tables leave no mark
    on it, and float32 holds every count of a job under 2^24 rows
    exactly: the control fails by its MI."""
    tables = job_tables(parts, np.float32)
    mi = tables_ref.mi_stats(tables, dtype=torch.bfloat16)
    return {"bayes": nb_lines(tables, schema), "mi": mi_lines(mi, schema)}
