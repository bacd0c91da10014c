"""Validation metrics, arbitration and counters.

The reference's validation-mode machinery: the confusion matrix with ×100
integer accuracy/recall/precision published as Hadoop counters
(util/ConfusionMatrix.java:34-77, consumed at
bayesian/BayesianPredictor.java:170-180), the misclassification-cost
arbitrator (util/CostBasedArbitrator.java:35-45), and the counter channel
itself (a plain named-counter object returned alongside results).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence

import numpy as np


class Counters:
    """Named counters — the in-process stand-in for Hadoop job counters.
    Mutations take a lock, so one Counters may be shared across threads."""

    def __init__(self):
        self._groups: Dict[str, Dict[str, int]] = {}
        self._lock = threading.Lock()

    def increment(self, group: str, name: str, amount: int = 1) -> None:
        with self._lock:
            g = self._groups.setdefault(group, {})
            g[name] = g.get(name, 0) + amount

    def set(self, group: str, name: str, value: int) -> None:
        with self._lock:
            self._groups.setdefault(group, {})[name] = int(value)

    def get(self, group: str, name: str) -> int:
        with self._lock:
            return self._groups.get(group, {}).get(name, 0)

    def as_dict(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {g: dict(d) for g, d in self._groups.items()}

    def merge(self, other: "Counters") -> "Counters":
        """Adopt every counter from ``other``, overwriting same-named ones."""
        for group, vals in other.as_dict().items():
            for name, value in vals.items():
                self.set(group, name, value)
        return self

    def merge_add(self, other: "Counters") -> "Counters":
        """Sum every counter from ``other`` into this one (Hadoop's counter
        merge): a rollup of many sources keeps every contributor's
        count."""
        for group, vals in other.as_dict().items():
            for name, value in vals.items():
                self.increment(group, name, value)
        return self


class ConfusionMatrix:
    """Multi-class confusion counts with the reference's binary metrics
    (exposed for a designated positive class)."""

    def __init__(self, class_values: Sequence[str], pos_class: Optional[str] = None):
        self.class_values = list(class_values)
        self.pos_class = pos_class if pos_class is not None else (self.class_values[0] if self.class_values else None)
        k = len(self.class_values)
        self.matrix = np.zeros((k, k), dtype=np.int64)   # [actual, predicted]

    def add_batch(self, actual: np.ndarray, predicted: np.ndarray) -> None:
        k = len(self.class_values)
        idx = actual.astype(np.int64) * k + predicted.astype(np.int64)
        self.matrix += np.bincount(idx, minlength=k * k).reshape(k, k)

    # -- binary metrics (×100 ints to mirror the reference's counter values) --
    def _binary(self):
        p = self.class_values.index(self.pos_class)
        tp = int(self.matrix[p, p])
        fn = int(self.matrix[p, :].sum() - tp)
        fp = int(self.matrix[:, p].sum() - tp)
        tn = int(self.matrix.sum() - tp - fn - fp)
        return tp, fp, tn, fn

    @property
    def accuracy(self) -> int:
        total = int(self.matrix.sum())
        correct = int(np.trace(self.matrix))
        return (100 * correct) // total if total else 0

    @property
    def recall(self) -> int:
        tp, _, _, fn = self._binary()
        return (100 * tp) // (tp + fn) if tp + fn else 0

    @property
    def precision(self) -> int:
        tp, fp, _, _ = self._binary()
        return (100 * tp) // (tp + fp) if tp + fp else 0

    def publish(self, counters: Counters, group: str = "Validation") -> None:
        counters.set(group, "accuracy", self.accuracy)
        counters.set(group, "recall", self.recall)
        counters.set(group, "precision", self.precision)
        correct = int(np.trace(self.matrix))
        counters.set(group, "correct", correct)
        counters.set(group, "incorrect", int(self.matrix.sum()) - correct)


class CostBasedArbitrator:
    """Expected-misclassification-cost argmin over class posteriors:
    pick argmin_k Σ_c P(c|x) · cost[c, k] (a [C] cost vector is the
    reference's per-class form, util/CostBasedArbitrator.java:35-45)."""

    def __init__(self, class_values: Sequence[str], cost: np.ndarray):
        cost = np.asarray(cost, dtype=np.float64)
        k = len(class_values)
        if cost.shape == (k,):
            full = np.tile(cost[:, None], (1, k))
            np.fill_diagonal(full, 0.0)
            cost = full
        if cost.shape != (k, k):
            raise ValueError(f"cost must be [{k}] or [{k},{k}], got {cost.shape}")
        self.class_values = list(class_values)
        self.cost = cost

    def arbitrate(self, probs: np.ndarray) -> np.ndarray:
        """probs [N, C] → predicted class index [N] minimizing expected cost."""
        expected = probs @ self.cost                     # [N, K]
        return np.argmin(expected, axis=-1).astype(np.int32)
