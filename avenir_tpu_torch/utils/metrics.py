"""Validation metrics, arbitration, counters and latency tracking.

The reference's validation-mode machinery: the confusion matrix with ×100
integer accuracy/recall/precision published as Hadoop counters
(util/ConfusionMatrix.java:34-77, consumed at
bayesian/BayesianPredictor.java:170-180), the misclassification-cost
arbitrator (util/CostBasedArbitrator.java:35-45), and the counter channel
itself (a plain named-counter object returned alongside results).

:class:`LatencyTracker` and :func:`serving_stats` are the stats schema of
the in-process RL serving loop (``pipeline/streaming.py``), the JAX
package's shared serving schema.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence

import numpy as np


def percentile_of(values, q: float) -> float:
    """The one percentile definition: numpy's linear interpolation over the
    given samples (0.0 for none)."""
    arr = np.asarray(values, np.float64)
    if arr.size == 0:
        return 0.0
    return float(np.percentile(arr, q))


def percentile_summary(samples_ms,
                       percentiles=(50.0, 95.0, 99.0)) -> Dict[str, float]:
    """The shared wall-time summary: ``count``, ``mean_ms``,
    ``p50_ms``/``p95_ms``/``p99_ms`` (configurable), ``max_ms``."""
    arr = np.asarray(list(samples_ms), np.float64)
    out: Dict[str, float] = {"count": int(arr.size)}
    if not arr.size:
        out["mean_ms"] = out["max_ms"] = 0.0
        for q in percentiles:
            out[f"p{q:g}_ms"] = 0.0
        return out
    out["mean_ms"] = float(arr.mean())
    for q in percentiles:
        out[f"p{q:g}_ms"] = percentile_of(arr, q)
    out["max_ms"] = float(arr.max())
    return out


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


class LatencyTracker:
    """Per-request latency percentiles over a bounded ring of recent samples
    (default 8192), so a long-lived serving loop does not grow host memory
    per request.  Thread-safe."""

    def __init__(self, capacity: int = 8192):
        self._buf = np.zeros(max(int(capacity), 1), np.float64)
        self._next = 0
        self._filled = 0
        self.count = 0                      # total samples ever recorded
        self._lock = threading.Lock()

    def record(self, seconds: float) -> None:
        with self._lock:
            self._buf[self._next] = seconds
            self._next = (self._next + 1) % len(self._buf)
            self._filled = min(self._filled + 1, len(self._buf))
            self.count += 1

    def percentile(self, q: float) -> float:
        """q-th percentile in seconds over the retained window (0.0 when
        no sample was recorded yet)."""
        with self._lock:
            if not self._filled:
                return 0.0
            return percentile_of(self._buf[:self._filled], q)

    @property
    def p50_ms(self) -> float:
        return self.percentile(50.0) * 1e3

    @property
    def p99_ms(self) -> float:
        return self.percentile(99.0) * 1e3

    def snapshot(self) -> Dict[str, float]:
        return {"p50_ms": round(self.p50_ms, 4),
                "p99_ms": round(self.p99_ms, 4),
                "latency_samples": self.count}


def serving_stats(counters: Counters,
                  latency: Dict[str, LatencyTracker],
                  identity: Optional[Dict[str, str]] = None
                  ) -> Dict[str, dict]:
    """Per served model, the ``Serving.<name>`` counter group merged with
    its latency percentiles.  Counter names inside the group: ``requests``,
    ``batches``, ``shed`` and the batched-size histogram ``bucket.<n>``
    (the RL loop, which dispatches one event at a time, reports everything
    under ``bucket.1``).  Covers the union of the trackers and the
    ``Serving.<name>`` groups (a model with counters and no tracker reports
    zeroed latency).  ``identity`` (``telemetry.export.fleet_identity``:
    process index and replica suffix) merges into every row, so stats
    federated from several replicas never collide on a model name."""
    groups = counters.as_dict()
    prefix = "Serving."
    names = set(latency) | {g[len(prefix):] for g in groups
                            if g.startswith(prefix)}
    out: Dict[str, dict] = {}
    for name in sorted(names):
        stats = dict(groups.get(f"Serving.{name}", {}))
        tracker = latency.get(name)
        stats.update(tracker.snapshot() if tracker is not None else
                     {"p50_ms": 0.0, "p99_ms": 0.0, "latency_samples": 0})
        if identity:
            stats.update(identity)
        out[name] = stats
    return out


class ConfusionMatrix:
    """Multi-class confusion counts with the reference's binary metrics
    (exposed for a designated positive class)."""

    def __init__(self, class_values: Sequence[str], pos_class: Optional[str] = None):
        self.class_values = list(class_values)
        self.pos_class = pos_class if pos_class is not None else (self.class_values[0] if self.class_values else None)
        k = len(self.class_values)
        self.matrix = np.zeros((k, k), dtype=np.int64)   # [actual, predicted]

    def add(self, actual: int, predicted: int, count: int = 1) -> None:
        self.matrix[actual, predicted] += count

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
