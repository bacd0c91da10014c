"""CSV part files of hospital-readmission rows from a seed: the rules of
avenir's ``resource/hosp_readmit.rb`` (the ``hosp_readmit``
configuration's frozen, vectorised copy, ``raw_block``) rendered as the
tutorial's text.

A row is ``id,age,weight,height,employmentStatus,familyStatus,diet,
exercise,followUp,smoking,alcohol,readmitted``: a unique id
(``P<part:02d><row:07d>``), the numeric values as integers inside the
tutorial's ranges, the categorical ones and the class as the schema's
names.  The values of every part are drawn on ``device`` from one
``torch.Generator`` seeded with the seed, part after part; the text is
rendered with NumPy, a fixed-width byte matrix a part and the padding
masked out, so no Python loop runs per row.  The same seed and sizes
give the same bytes on every device the draws agree on.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import List

import numpy as np

from cardbench.configs.hosp_readmit import generator as rules

ID_WIDTH = 10


def field_order(schema: dict) -> List[dict]:
    return sorted(schema["fields"], key=lambda f: f["ordinal"])


def _table(tokens: List[bytes]):
    """(uint8 [V, W] padded tokens, int64 [V] lengths)."""
    width = max(len(t) for t in tokens)
    tab = np.zeros((len(tokens), width), np.uint8)
    for i, t in enumerate(tokens):
        tab[i, :len(t)] = np.frombuffer(t, np.uint8)
    return tab, np.array([len(t) for t in tokens], np.int64)


def _ids(part: int, rows: int) -> np.ndarray:
    """uint8 [rows, ID_WIDTH]: ``P``, the part in two digits, the row in
    seven."""
    if rows > 10 ** 7 or part >= 100:
        raise ValueError("ids hold 100 parts of at most 10,000,000 rows")
    out = np.empty((rows, ID_WIDTH), np.uint8)
    out[:, 0] = ord("P")
    out[:, 1] = ord("0") + part // 10
    out[:, 2] = ord("0") + part % 10
    r = np.arange(rows, dtype=np.int64)
    for k in range(7):
        out[:, ID_WIDTH - 1 - k] = ord("0") + (r // 10 ** k) % 10
    return out


def render(raw: dict, schema: dict, part: int) -> bytes:
    """One part's text from its raw values (NumPy arrays of
    :func:`rules.raw_block`'s fields)."""
    rows = len(raw["readmitted"])
    cols = []                                    # (uint8 [n, W], lengths [n])
    for f in field_order(schema):
        name = f["name"]
        if f.get("id"):
            cols.append((_ids(part, rows), np.full(rows, ID_WIDTH)))
            continue
        v = np.asarray(raw[name]).astype(np.int64)
        if f["dataType"] == "categorical":
            tab, lens = _table([c.encode() for c in f["cardinality"]])
        else:
            top = int(v.max()) if rows else 0
            tab, lens = _table([str(x).encode() for x in range(top + 1)])
        cols.append((tab[v], lens[v]))
    width = sum(c.shape[1] for c, _ in cols) + len(cols)   # delimiters, \n
    mat = np.empty((rows, width), np.uint8)
    keep = np.zeros((rows, width), bool)
    at = 0
    for k, (c, lens) in enumerate(cols):
        w = c.shape[1]
        mat[:, at:at + w] = c
        keep[:, at:at + w] = np.arange(w)[None, :] < lens[:, None]
        at += w
        mat[:, at] = ord("\n") if k == len(cols) - 1 else ord(",")
        keep[:, at] = True
        at += 1
    return mat[keep].tobytes()


def write_pool(paths: List[str], schema: dict, seed: int, part_rows: int,
               device, threads: int = 1) -> None:
    """A part file of ``part_rows`` rows at each of ``paths``.  The
    values are drawn part after part; ``threads`` render and write the
    parts side by side."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    raws = [{k: v.to(torch.uint8).cpu().numpy()        # every value < 256
             for k, v in rules.raw_block(gen, part_rows, device).items()}
            for _ in paths]

    def write(p):
        with open(paths[p], "wb") as fh:
            fh.write(render(raws[p], schema, p))

    with ThreadPoolExecutor(max(1, threads)) as pool:
        list(pool.map(write, range(len(paths))))
