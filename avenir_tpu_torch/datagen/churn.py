"""Customer-churn generator — planted-structure port of resource/usage.rb.

Mechanism (usage.rb:20-82): categorical usage/payment features drawn from
fixed weighted distributions; churn probability starts at 25% and is scaled
by per-level multipliers (overage minutes ×1.8, high data ×1.6, high CS calls
×1.6, poor payment ×1.3, old account ×1.2...); ``status`` is ``closed`` with
that probability. A correct Naive Bayes / Cramér / MI implementation must
recover these drivers (minUsed, dataUsed, csCalls strongest).
"""

from __future__ import annotations

import json
from typing import Tuple

import numpy as np

CHURN_SCHEMA_JSON = {
    "fields": [
        {"name": "id", "ordinal": 0, "id": True, "dataType": "string"},
        {"name": "minUsed", "ordinal": 1, "dataType": "categorical",
         "cardinality": ["low", "med", "high", "overage"], "feature": True},
        {"name": "dataUsed", "ordinal": 2, "dataType": "categorical",
         "cardinality": ["low", "med", "high"], "feature": True},
        {"name": "CSCalls", "ordinal": 3, "dataType": "categorical",
         "cardinality": ["low", "med", "high"], "feature": True},
        {"name": "payment", "ordinal": 4, "dataType": "categorical",
         "cardinality": ["poor", "average", "good"], "feature": True},
        {"name": "acctAge", "ordinal": 5, "dataType": "categorical",
         "cardinality": ["1", "2", "3", "4", "5"], "feature": True},
        {"name": "status", "ordinal": 6, "dataType": "categorical",
         "cardinality": ["open", "closed"]},
    ]
}

_MIN_LEVELS = (["low", "med", "high", "overage"], [2, 5, 3, 2])
_DATA_LEVELS = (["low", "med", "high"], [4, 6, 2])
_CS_LEVELS = (["low", "med", "high"], [6, 3, 1])
_PAY_LEVELS = (["poor", "average", "good"], [2, 5, 4])

_MIN_MULT = {"low": 1.2, "med": 1.0, "high": 1.4, "overage": 1.8}
_DATA_MULT = {"low": 1.1, "med": 1.3, "high": 1.6}
_CS_MULT = {"low": 1.0, "med": 1.2, "high": 1.6}
_PAY_MULT = {"poor": 1.3, "average": 1.0, "good": 1.0}
_AGE_MULT = {1: 1.0, 2: 1.0, 3: 1.05, 4: 1.2, 5: 1.3}


def _draw(rng: np.random.Generator, n: int, levels_weights) -> np.ndarray:
    levels, weights = levels_weights
    p = np.asarray(weights, np.float64)
    return rng.choice(np.array(levels, object), size=n, p=p / p.sum())


def generate_churn(n: int, seed: int = 42) -> np.ndarray:
    """Object array [n, 7] of CSV fields matching CHURN_SCHEMA_JSON."""
    rng = np.random.default_rng(seed)
    min_used = _draw(rng, n, _MIN_LEVELS)
    data_used = _draw(rng, n, _DATA_LEVELS)
    cs_calls = _draw(rng, n, _CS_LEVELS)
    payment = _draw(rng, n, _PAY_LEVELS)
    acct_age = rng.integers(1, 5, size=n)  # 1..4 as in usage.rb rand(4)+1

    pr = np.full(n, 25.0)
    pr *= np.vectorize(_MIN_MULT.get)(min_used)
    pr *= np.vectorize(_DATA_MULT.get)(data_used)
    pr *= np.vectorize(_CS_MULT.get)(cs_calls)
    pr *= np.vectorize(_PAY_MULT.get)(payment)
    pr *= np.vectorize(_AGE_MULT.get)(acct_age)
    pr = np.minimum(pr, 99.0)
    closed = rng.uniform(0, 100, size=n) < pr

    rows = np.empty((n, 7), dtype=object)
    # ids are zero-padded so lexicographic order == generation order for
    # any downstream sort/group; n past the width would break that (GL003)
    assert n < 10 ** 10, "customer ids overflow the 10-digit width"
    rows[:, 0] = [f"C{int(i):010d}" for i in range(n)]
    rows[:, 1] = min_used
    rows[:, 2] = data_used
    rows[:, 3] = cs_calls
    rows[:, 4] = payment
    rows[:, 5] = acct_age.astype(str).astype(object)
    rows[:, 6] = np.where(closed, "closed", "open").astype(object)
    return rows


def churn_schema_string() -> str:
    return json.dumps(CHURN_SCHEMA_JSON)
