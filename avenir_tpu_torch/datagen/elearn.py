"""E-learning activity generator — planted-structure port of
resource/elearn.py.

Mechanism (elearn.py:13-105): 9 truncated-Gaussian activity signals; failure
probability starts at 10% and gains additive bumps for low activity — low
testScore up to +34, low assignmentScore up to +28, low contentTime up to
+10, etc.; ``status`` is F with that probability. A correct kNN classifier
must beat the majority baseline by exploiting locality in the signal space.
"""

from __future__ import annotations

import numpy as np

ELEARN_SCHEMA_JSON = {
    "fields": [
        {"name": "userID", "ordinal": 0, "id": True, "dataType": "string"},
        {"name": "contentTime", "ordinal": 1, "dataType": "int", "feature": True},
        {"name": "discussTime", "ordinal": 2, "dataType": "int", "feature": True},
        {"name": "organizerTime", "ordinal": 3, "dataType": "int", "feature": True},
        {"name": "emailCount", "ordinal": 4, "dataType": "int", "feature": True},
        {"name": "testScore", "ordinal": 5, "dataType": "int", "feature": True},
        {"name": "assignmentScore", "ordinal": 6, "dataType": "int", "feature": True},
        {"name": "chatMsgCount", "ordinal": 7, "dataType": "int", "feature": True},
        {"name": "searchTime", "ordinal": 8, "dataType": "int", "feature": True},
        {"name": "bookMarkCount", "ordinal": 9, "dataType": "int", "feature": True},
        {"name": "status", "ordinal": 10, "dataType": "categorical",
         "cardinality": ["P", "F"]},
    ]
}


def generate_elearn(n: int, seed: int = 42) -> np.ndarray:
    rng = np.random.default_rng(seed)

    def gauss(mu, sd, lo=0, hi=None):
        v = rng.normal(mu, sd, size=n)
        v = np.maximum(v, lo)
        if hi is not None:
            v = np.clip(v, lo, hi)
        return v.astype(np.int64)

    content = gauss(300, 100)
    discuss = gauss(80, 40)
    organizer = gauss(40, 20)
    email = gauss(10, 6)
    test = np.clip(rng.normal(50, 30, size=n), 10, 100).astype(np.int64)
    assign = np.clip(rng.normal(60, 40, size=n), 10, 100).astype(np.int64)
    chat = gauss(100, 60)
    search = gauss(60, 40)
    bookmark = gauss(12, 8)

    prob = np.full(n, 10.0)
    prob += np.select([content < 100, content < 150], [10, 6], 0)
    prob += np.select([discuss < 30, discuss < 50], [8, 4], 0)
    prob += np.where(discuss < 10, 5, 0)      # elearn.py's organizer bump keys on discussTime
    prob += np.where(email < 3, 6, 0)
    prob += np.select([test < 30, test < 40, test < 50], [34, 20, 14], 0)
    prob += np.select([assign < 35, assign < 50, assign < 60], [28, 18, 10], 0)
    prob += np.where(chat < 20, 4, 0)
    prob += np.select([search < 15, search < 30], [7, 3], 0)
    prob += np.where(bookmark < 4, 8, 0)
    fail = rng.integers(0, 101, size=n) < prob

    cols = [content, discuss, organizer, email, test, assign, chat, search, bookmark]
    rows = np.empty((n, 11), dtype=object)
    rows[:, 0] = [str(1000000 + int(i)) for i in rng.integers(0, 1000000, size=n)]
    for j, c in enumerate(cols):
        rows[:, j + 1] = c.astype(str).astype(object)
    rows[:, 10] = np.where(fail, "F", "P").astype(object)
    return rows
