"""E-learning activity rows from a seed: a frozen, vectorised copy of the
rules of avenir's ``resource/elearn.py``.

Nine truncated-Gaussian activity signals, truncated to whole numbers,
and a failure probability of 10% plus additive bumps for low activity;
``status`` is F with that probability.  The rows come out as the
configuration's encoding gives them: float32 features [N, 9] (whole
numbers) and int32 labels [N] (P 0, F 1), drawn with numpy from one
stream of the seed, in the order of the fields.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

FEATURES = ("contentTime", "discussTime", "organizerTime", "emailCount",
            "testScore", "assignmentScore", "chatMsgCount", "searchTime",
            "bookMarkCount")


def generate(rows: int, seed: int, stream: int) -> Tuple[np.ndarray,
                                                          np.ndarray]:
    """(features float32 [rows, 9], labels int32 [rows]) of stream
    ``stream`` of ``seed`` (the references and the queries draw from two
    streams)."""
    rng = np.random.default_rng([seed % (1 << 64), stream])

    def gauss(mu, sd):
        return np.maximum(rng.normal(mu, sd, size=rows), 0).astype(np.int64)

    content = gauss(300, 100)
    discuss = gauss(80, 40)
    organizer = gauss(40, 20)
    email = gauss(10, 6)
    test = np.clip(rng.normal(50, 30, size=rows), 10, 100).astype(np.int64)
    assign = np.clip(rng.normal(60, 40, size=rows), 10, 100).astype(np.int64)
    chat = gauss(100, 60)
    search = gauss(60, 40)
    bookmark = gauss(12, 8)

    prob = np.full(rows, 10.0)
    prob += np.select([content < 100, content < 150], [10, 6], 0)
    prob += np.select([discuss < 30, discuss < 50], [8, 4], 0)
    prob += np.where(discuss < 10, 5, 0)
    prob += np.where(email < 3, 6, 0)
    prob += np.select([test < 30, test < 40, test < 50], [34, 20, 14], 0)
    prob += np.select([assign < 35, assign < 50, assign < 60], [28, 18, 10], 0)
    prob += np.where(chat < 20, 4, 0)
    prob += np.select([search < 15, search < 30], [7, 3], 0)
    prob += np.where(bookmark < 4, 8, 0)
    fail = rng.integers(0, 101, size=rows) < prob

    cols = [content, discuss, organizer, email, test, assign, chat, search,
            bookmark]
    return (np.stack(cols, axis=1).astype(np.float32),
            fail.astype(np.int32))


def csv_rows(features: np.ndarray, labels: np.ndarray, class_values):
    """The rows as the tutorial's CSV fields (id, nine signals, status)."""
    return [[str(1000000 + i)] + [str(int(v)) for v in features[i]]
            + [class_values[int(labels[i])]] for i in range(len(labels))]
