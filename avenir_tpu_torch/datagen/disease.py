"""Disease-risk patient generator — planted-structure port of
resource/disease.rb (the rule-mining tutorial's data,
resource/tutorial_diesase_rule_mining.txt); a copy of the JAX package's.

Mechanism (disease.rb): weighted categorical draws — race EUA:10 AFA:3
LAA:1 ASA:1, diet LF:2 REG:8 HF:4, family history NFH:5 FH:1, domestic
life S:2 DP:4 — age uniform 20-79, weight uniform 120-239. Disease
probability starts at 15% and multiplies by age band (<40 ×1.0, <50
×1.05, <60 ×1.15, <70 ×1.4, else ×1.5), race (AFA ×1.2, ASA ×0.9, LAA
×0.95), diet (HF ×1.15), family history (FH ×1.2), and single domestic
life (×1.2), capped at 99%. Age is the strongest planted driver — the
rule-mining (candidate-split) job should rank an age split highest.

Schema mirrors resource/patient.json (age binned bucketWidth 5 with
min/max/maxSplit; weight continuous; open-vocabulary categoricals there —
declared here for streaming use).
"""

from __future__ import annotations

import numpy as np

DISEASE_SCHEMA_JSON = {
    "fields": [
        {"name": "patientID", "ordinal": 0, "id": True, "dataType": "string"},
        {"name": "age", "ordinal": 1, "dataType": "int", "feature": True,
         "min": 20, "max": 80, "maxSplit": 3, "bucketWidth": 5},
        {"name": "race", "ordinal": 2, "dataType": "categorical", "feature": True,
         "cardinality": ["EUA", "AFA", "LAA", "ASA"]},
        {"name": "weight", "ordinal": 3, "dataType": "int", "feature": True,
         "min": 120, "max": 240, "maxSplit": 3, "bucketWidth": 20},
        {"name": "diet", "ordinal": 4, "dataType": "categorical", "feature": True,
         "cardinality": ["LF", "REG", "HF"]},
        {"name": "familyHistory", "ordinal": 5, "dataType": "categorical",
         "feature": True, "cardinality": ["NFH", "FH"]},
        {"name": "domesticLife", "ordinal": 6, "dataType": "categorical",
         "feature": True, "cardinality": ["S", "DP"]},
        {"name": "disease", "ordinal": 7, "dataType": "categorical",
         "cardinality": ["No", "Yes"]},
    ]
}

_RACE_MULT = {"AFA": 1.2, "ASA": 0.9, "LAA": 0.95, "EUA": 1.0}
_DIET_MULT = {"HF": 1.15, "LF": 1.0, "REG": 1.0}


def _weighted(rng, values_weights):
    values = [v for v, _ in values_weights]
    w = np.array([float(x) for _, x in values_weights])
    return lambda n: rng.choice(values, size=n, p=w / w.sum())


def generate_disease(n: int, seed: int = 0) -> np.ndarray:
    """[n, 8] object array of rows in disease.rb's column order."""
    rng = np.random.default_rng(seed)
    age = rng.integers(20, 80, size=n)
    race = _weighted(rng, [("EUA", 10), ("AFA", 3), ("LAA", 1), ("ASA", 1)])(n)
    weight = rng.integers(120, 240, size=n)
    diet = _weighted(rng, [("LF", 2), ("REG", 8), ("HF", 4)])(n)
    fam = _weighted(rng, [("NFH", 5), ("FH", 1)])(n)
    dom = _weighted(rng, [("S", 2), ("DP", 4)])(n)

    pr = np.full(n, 15.0)
    age_mult = np.select(
        [age < 40, age < 50, age < 60, age < 70],
        [1.0, 1.05, 1.15, 1.4], default=1.5)
    pr *= age_mult
    pr *= np.vectorize(_RACE_MULT.get)(race)
    pr *= np.vectorize(_DIET_MULT.get)(diet)
    pr *= np.where(fam == "FH", 1.2, 1.0)
    pr *= np.where(dom == "S", 1.2, 1.0)
    pr = np.minimum(pr, 99.0)
    status = np.where(rng.integers(0, 100, size=n) < pr, "Yes", "No")

    rows = np.empty((n, 8), dtype=object)
    # zero-padded ids: lexicographic == generation order (graftlint GL003)
    assert n < 10 ** 11, "patient ids overflow the 11-digit width"
    rows[:, 0] = [f"P{i:011d}" for i in range(n)]
    rows[:, 1] = [str(v) for v in age]
    rows[:, 2] = race
    rows[:, 3] = [str(v) for v in weight]
    rows[:, 4] = diet
    rows[:, 5] = fam
    rows[:, 6] = dom
    rows[:, 7] = status
    return rows
