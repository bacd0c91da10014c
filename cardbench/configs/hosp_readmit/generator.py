"""Hospital-readmission rows from a seed: a frozen, vectorised copy of the
rules of avenir's ``resource/hosp_readmit.rb``.

Three numeric features drawn as a weighted range and then uniformly
within it, seven categorical ones by weight, employment and diet
correlated with age and employment, and a readmission probability of 20%
plus additive bumps.  The rows are drawn on ``device`` from one
``torch.Generator`` in blocks of :data:`BLOCK` rows, sixteen uniforms a
row in one call a block, and come out already encoded by the
configuration's schema: int32 codes [N, F] and int32 labels [N].  The
same seed, device and block size give the same rows, whatever the row
count asked.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

BLOCK = 1 << 22

AGE = [((10, 20), 2), ((21, 30), 3), ((31, 40), 6), ((41, 50), 10),
       ((51, 60), 14), ((61, 70), 19), ((71, 80), 25), ((81, 90), 21)]
WEIGHT = [((130, 140), 9), ((141, 150), 13), ((151, 160), 16),
          ((161, 170), 20), ((171, 180), 23), ((181, 190), 20),
          ((191, 200), 17), ((201, 211), 14), ((211, 220), 10),
          ((221, 230), 7), ((231, 240), 5), ((241, 250), 3)]
HEIGHT = [((50, 55), 9), ((56, 60), 12), ((61, 65), 16), ((66, 70), 23),
          ((71, 75), 14)]
# categorical weights, in the order of the schema's cardinality lists
EMPLOYMENT = [10, 1, 3]          # employed, unemployed, retired
FAMILY = [10, 15]                # alone, with partner
DIET = [10, 4, 2]                # average, poor, good
EXERCISE = [10, 12, 4]           # average, low, high
FOLLOW_UP = [10, 14, 3]          # average, low, high
SMOKING = [10, 3]                # non smoker, smoker
ALCOHOL = [10, 16, 4]            # average, low, high

NUMERIC = ("age", "weight", "height")
CATEGORICAL = ("employmentStatus", "familyStatus", "diet", "exercise",
               "followUp", "smoking", "alcohol")


def binned_fields(schema: dict) -> List[dict]:
    return [f for f in schema["fields"] if f.get("feature")]


def n_bins(schema: dict) -> List[int]:
    """Bins of each feature: the bucket range of a numeric feature, and a
    categorical one's values plus one bin for a value outside them."""
    out = []
    for f in binned_fields(schema):
        if f["dataType"] == "categorical":
            out.append(len(f["cardinality"]) + 1)
        else:
            bw = f["bucketWidth"]
            out.append(math.floor(f["max"] / bw) - math.floor(f["min"] / bw)
                       + 1)
    return out


def class_values(schema: dict) -> List[str]:
    return [f for f in schema["fields"]
            if f["name"] == "readmitted"][0]["cardinality"]


def _cdf(weights: Sequence[float], device):
    import torch

    w = torch.tensor(weights, dtype=torch.float64)
    return (torch.cumsum(w, 0) / w.sum()).to(torch.float32).to(device)


def _pick(u, weights, device):
    """Index of a weighted draw for each uniform in ``u``."""
    import torch

    cdf = _cdf(weights, device)
    return torch.searchsorted(cdf, u, right=True).clamp_(max=len(weights) - 1)


def _range(u_pick, u_in, table, device):
    import torch

    idx = _pick(u_pick, [w for _, w in table], device)
    lo = torch.tensor([r[0] for r, _ in table], device=device)[idx]
    hi = torch.tensor([r[1] for r, _ in table], device=device)[idx]
    v = lo + torch.floor(u_in * (hi - lo + 1).to(u_in.dtype)).long()
    return torch.minimum(v, hi)


def raw_block(gen, rows: int, device) -> Dict[str, "object"]:
    """One block's raw values: the numeric features as int64, each
    categorical one as the index of its value, and the readmission flag."""
    import torch

    u = torch.rand((16, rows), generator=gen, device=device)
    age = _range(u[0], u[1], AGE, device)
    wt = _range(u[2], u[3], WEIGHT, device)
    ht = _range(u[4], u[5], HEIGHT, device)
    emp = _pick(u[6], EMPLOYMENT, device)
    emp = torch.where((age > 68) & (u[7] < 0.8), 2, emp)
    fam = _pick(u[8], FAMILY, device)
    diet = _pick(u[9], DIET, device)
    diet = torch.where((emp == 1) & (u[10] < 0.7), 1, diet)
    ex = _pick(u[11], EXERCISE, device)
    follow = _pick(u[12], FOLLOW_UP, device)
    smoke = _pick(u[13], SMOKING, device)
    alco = _pick(u[14], ALCOHOL, device)

    def steps(pairs, default=0.0):
        out = torch.full((rows,), default, dtype=torch.float32, device=device)
        for cond, bump in reversed(pairs):       # first true condition wins
            out = torch.where(cond, bump, out)
        return out

    prob = torch.full((rows,), 20.0, dtype=torch.float32, device=device)
    prob += steps([(age > 80, 10.0), (age > 70, 5.0), (age > 60, 3.0)])
    prob += steps([((wt > 200) & (ht < 70), 5.0),
                   ((wt > 180) & (ht < 60), 3.0)])
    prob += steps([(emp == 1, 6.0), (emp == 2, 4.0)])
    prob += steps([(fam == 0, 9.0)])
    prob += steps([(diet == 1, 4.0), (diet == 0, 2.0)])
    prob += steps([(ex == 1, 3.0), (ex == 0, 1.0)])
    prob += steps([(follow == 1, 8.0)])
    prob += steps([(smoke == 1, 6.0)])
    prob += steps([(alco == 2, 5.0), (alco == 0, 2.0)])
    readmit = u[15] * 100.0 < prob
    return {"age": age, "weight": wt, "height": ht, "employmentStatus": emp,
            "familyStatus": fam, "diet": diet, "exercise": ex,
            "followUp": follow, "smoking": smoke, "alcohol": alco,
            "readmitted": readmit}


def encode_block(raw, schema: dict):
    """The block's int32 codes [rows, F] and labels [rows], by the
    schema's binning."""
    import torch

    cols = []
    for f, nb in zip(binned_fields(schema), n_bins(schema)):
        v = raw[f["name"]]
        if f["dataType"] != "categorical":
            bw = f["bucketWidth"]
            v = (torch.div(v, bw, rounding_mode="floor")
                 - math.floor(f["min"] / bw)).clamp(0, nb - 1)
        cols.append(v.to(torch.int32))
    return (torch.stack(cols, dim=1).contiguous(),
            raw["readmitted"].to(torch.int32))


def generate(schema: dict, rows: int, seed: int, device,
             block: int = BLOCK):
    """(codes int32 [rows, F], labels int32 [rows]) on ``device``, drawn
    in blocks of ``block`` rows."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    codes = torch.empty((rows, len(binned_fields(schema))), dtype=torch.int32,
                        device=device)
    labels = torch.empty((rows,), dtype=torch.int32, device=device)
    for start in range(0, rows, block):
        c, lab = encode_block(raw_block(gen, block, device), schema)
        take = min(block, rows - start)
        codes[start:start + take] = c[:take]
        labels[start:start + take] = lab[:take]
    return codes, labels


def csv_rows(raw, schema: dict, count: int) -> List[List[str]]:
    """The first ``count`` rows of a raw block as the tutorial's CSV
    fields (id, the ten features, the class), for checking the encoding
    against the program's own encoder."""
    fields = {f["name"]: f for f in schema["fields"]}
    out = []
    for i in range(count):
        row = [f"P{i:010d}"]
        for name in NUMERIC:
            row.append(str(int(raw[name][i])))
        for name in CATEGORICAL:
            row.append(fields[name]["cardinality"][int(raw[name][i])])
        row.append(class_values(schema)[int(raw["readmitted"][i])])
        out.append(row)
    return out
