"""Hospital-readmission generator — planted-structure port of
resource/hosp_readmit.rb.

Mechanism (hosp_readmit.rb:20-98): weighted draws for 3 numeric + 7
categorical features; readmission probability starts at 20% and gains
additive bumps — age>80 +10, living alone +9, low follow-up +8, smoker +6,
unemployed +6, high alcohol +5, heavy+short +5, retired +4, poor diet +4 —
with employment/diet correlated to age/employment. MI feature ranking must
surface the strong drivers (age, familyStatus, followUp, smoking).
"""

from __future__ import annotations

import numpy as np

HOSP_SCHEMA_JSON = {
    "fields": [
        {"name": "id", "ordinal": 0, "id": True, "dataType": "string"},
        {"name": "age", "ordinal": 1, "dataType": "int", "feature": True,
         "bucketWidth": 10, "min": 10, "max": 90},
        {"name": "weight", "ordinal": 2, "dataType": "int", "feature": True,
         "bucketWidth": 10, "min": 130, "max": 250},
        {"name": "height", "ordinal": 3, "dataType": "int", "feature": True,
         "bucketWidth": 5, "min": 50, "max": 75},
        {"name": "employmentStatus", "ordinal": 4, "dataType": "categorical", "feature": True,
         "cardinality": ["employed", "unemployed", "retired"]},
        {"name": "familyStatus", "ordinal": 5, "dataType": "categorical", "feature": True,
         "cardinality": ["alone", "with partner"]},
        {"name": "diet", "ordinal": 6, "dataType": "categorical", "feature": True,
         "cardinality": ["average", "poor", "good"]},
        {"name": "exercise", "ordinal": 7, "dataType": "categorical", "feature": True,
         "cardinality": ["average", "low", "high"]},
        {"name": "followUp", "ordinal": 8, "dataType": "categorical", "feature": True,
         "cardinality": ["average", "low", "high"]},
        {"name": "smoking", "ordinal": 9, "dataType": "categorical", "feature": True,
         "cardinality": ["non smoker", "smoker"]},
        {"name": "alcohol", "ordinal": 10, "dataType": "categorical", "feature": True,
         "cardinality": ["average", "low", "high"]},
        {"name": "readmitted", "ordinal": 11, "dataType": "categorical",
         "cardinality": ["N", "Y"]},
    ]
}


def _range_draw(rng, n, ranges_weights):
    """Weighted draw of ranges then uniform int within range."""
    ranges = [r for r, _ in ranges_weights]
    w = np.array([w for _, w in ranges_weights], np.float64)
    pick = rng.choice(len(ranges), size=n, p=w / w.sum())
    lo = np.array([r[0] for r in ranges])[pick]
    hi = np.array([r[1] for r in ranges])[pick]
    return rng.integers(lo, hi + 1)


def _cat_draw(rng, n, values_weights):
    vals = np.array([v for v, _ in values_weights], object)
    w = np.array([w for _, w in values_weights], np.float64)
    return rng.choice(vals, size=n, p=w / w.sum())


def generate_hosp_readmit(n: int, seed: int = 42) -> np.ndarray:
    rng = np.random.default_rng(seed)
    age = _range_draw(rng, n, [((10, 20), 2), ((21, 30), 3), ((31, 40), 6), ((41, 50), 10),
                               ((51, 60), 14), ((61, 70), 19), ((71, 80), 25), ((81, 90), 21)])
    wt = _range_draw(rng, n, [((130, 140), 9), ((141, 150), 13), ((151, 160), 16),
                              ((161, 170), 20), ((171, 180), 23), ((181, 190), 20),
                              ((191, 200), 17), ((201, 211), 14), ((211, 220), 10),
                              ((221, 230), 7), ((231, 240), 5), ((241, 250), 3)])
    ht = _range_draw(rng, n, [((50, 55), 9), ((56, 60), 12), ((61, 65), 16),
                              ((66, 70), 23), ((71, 75), 14)])
    emp = _cat_draw(rng, n, [("employed", 10), ("unemployed", 1), ("retired", 3)])
    emp = np.where((age > 68) & (rng.uniform(size=n) < 0.8), "retired", emp).astype(object)
    fam = _cat_draw(rng, n, [("alone", 10), ("with partner", 15)])
    diet = _cat_draw(rng, n, [("average", 10), ("poor", 4), ("good", 2)])
    diet = np.where((emp == "unemployed") & (rng.uniform(size=n) < 0.7), "poor", diet).astype(object)
    ex = _cat_draw(rng, n, [("average", 10), ("low", 12), ("high", 4)])
    follow = _cat_draw(rng, n, [("average", 10), ("low", 14), ("high", 3)])
    smoke = _cat_draw(rng, n, [("non smoker", 10), ("smoker", 3)])
    alco = _cat_draw(rng, n, [("average", 10), ("low", 16), ("high", 4)])

    prob = np.full(n, 20.0)
    prob += np.select([age > 80, age > 70, age > 60], [10, 5, 3], 0)
    prob += np.select([(wt > 200) & (ht < 70), (wt > 180) & (ht < 60)], [5, 3], 0)
    prob += np.select([emp == "unemployed", emp == "retired"], [6, 4], 0)
    prob += np.where(fam == "alone", 9, 0)
    prob += np.select([diet == "poor", diet == "average"], [4, 2], 0)
    prob += np.select([ex == "low", ex == "average"], [3, 1], 0)
    prob += np.where(follow == "low", 8, 0)   # the rb's 'avearge' typo branch never fires
    prob += np.where(smoke == "smoker", 6, 0)
    prob += np.select([alco == "high", alco == "average"], [5, 2], 0)
    readmit = rng.uniform(0, 100, size=n) < prob

    rows = np.empty((n, 12), dtype=object)
    # zero-padded ids: lexicographic == generation order (graftlint GL003)
    assert n < 10 ** 10, "patient ids overflow the 10-digit width"
    rows[:, 0] = [f"P{int(i):010d}" for i in range(n)]
    rows[:, 1] = age.astype(str).astype(object)
    rows[:, 2] = wt.astype(str).astype(object)
    rows[:, 3] = ht.astype(str).astype(object)
    rows[:, 4] = emp
    rows[:, 5] = fam
    rows[:, 6] = diet
    rows[:, 7] = ex
    rows[:, 8] = follow
    rows[:, 9] = smoke
    rows[:, 10] = alco
    rows[:, 11] = np.where(readmit, "Y", "N").astype(object)
    return rows
