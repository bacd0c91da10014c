"""Abandoned-cart retargeting generator — planted-structure port of
resource/retarget.py.

Mechanism (retarget.py:9-22): 9 campaign types (send-hour 1/2/3 × cross-sell /
social / none) with a fixed conversion-probability table (1C 75% ... 3N 15%);
cart amount is independent noise. A correct decision tree must split on
campaignType first and ignore amount.
"""

from __future__ import annotations

import numpy as np

RETARGET_SCHEMA_JSON = {
    "fields": [
        {"name": "custID", "ordinal": 0, "id": True, "dataType": "string"},
        {"name": "campaignType", "ordinal": 1, "dataType": "categorical", "feature": True,
         "maxSplit": 2,
         "cardinality": ["1C", "1S", "1N", "2C", "2S", "2N", "3C", "3S", "3N"]},
        {"name": "amount", "ordinal": 2, "dataType": "int", "feature": True,
         "bucketWidth": 50},
        {"name": "succeeded", "ordinal": 3, "dataType": "categorical",
         "cardinality": ["N", "Y"]},
    ]
}

CONVERSION = {"1C": 75, "1S": 60, "1N": 50, "2C": 60, "2S": 40, "2N": 30,
              "3C": 20, "3S": 20, "3N": 15}


def generate_retarget(n: int, seed: int = 42) -> np.ndarray:
    rng = np.random.default_rng(seed)
    types = np.array(list(CONVERSION), object)
    t = rng.choice(types, size=n)
    conv_prob = np.vectorize(CONVERSION.get)(t)
    conv = rng.integers(1, 101, size=n) < conv_prob
    amount = 20 + rng.integers(0, 301, size=n)
    rows = np.empty((n, 4), dtype=object)
    rows[:, 0] = [str(1000000 + int(i)) for i in rng.integers(0, 999999, size=n)]
    rows[:, 1] = t
    rows[:, 2] = amount.astype(str).astype(object)
    rows[:, 3] = np.where(conv, "Y", "N").astype(object)
    return rows
