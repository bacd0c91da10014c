"""Distribution-drift detection over windowed count tables; port of
``avenir_tpu/stream/drift.py`` (host numpy float64, the same arithmetic in
the same order, so the divergences equal the JAX package's to the bit).

The detector never touches rows: it reads the class-count vector and the
per-feature bin marginals ALREADY aggregated for the window's consumers
(``ScanTables``: the host int64 totals of the window's panes), so drift
detection is a handful of tiny host-side vector ops per window.

Divergence metrics (``stream.drift.metric``):

- ``js``  — Jensen–Shannon divergence (log2, so bounded in [0, 1]) between
  the window's distribution and the reference window's;
- ``chisquare`` — a scale-free Pearson form over the probability vectors,
  Σ (p−q)²/q (the counts' chi-square statistic divided by n).

The score is the MAX over the monitored distributions
(``stream.drift.source``: the class distribution, every feature's bin
marginal, or both) — drift in any single feature is drift.

Hysteresis: a window past ``stream.drift.threshold`` extends a streak; only
``stream.drift.min.windows`` CONSECUTIVE drifted windows fire a
:class:`DriftEvent` (one noisy window never triggers a retrain).  On fire,
the reference rebases to the firing window — the new regime becomes normal
— and the streak resets.  Every scored window journals a ``drift.window``
event; a fire journals ``drift.detected`` (``telemetry/schema.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from avenir_tpu_torch.core.config import ConfigError, JobConfig
from avenir_tpu_torch.pipeline.scan import ScanTables
from avenir_tpu_torch.telemetry import spans as tel
from avenir_tpu_torch.utils.metrics import Counters

_EPS = 1e-12

METRICS = ("js", "chisquare")
SOURCES = ("class", "features", "both")


def js_divergence(p: np.ndarray, q: np.ndarray) -> float:
    """Jensen–Shannon divergence between two probability vectors (log2)."""
    p = np.asarray(p, np.float64)
    q = np.asarray(q, np.float64)
    m = 0.5 * (p + q)

    def kl(a, b):
        mask = a > 0
        return float(np.sum(a[mask] * np.log2(a[mask] / np.maximum(b[mask],
                                                                   _EPS))))

    return 0.5 * kl(p, m) + 0.5 * kl(q, m)


def chisquare_divergence(p: np.ndarray, q: np.ndarray) -> float:
    """Σ (p−q)²/q over probability vectors — the Pearson statistic of the
    window counts against the reference distribution, divided by n.

    Both vectors are additively smoothed (half a pseudo-count spread over
    the support) before the division: a category present in the window
    but absent from the sampled reference window must read as moderate
    divergence, not an ε-denominator blow-up that fires the detector on a
    single rare-category row."""
    p = np.asarray(p, np.float64)
    q = np.asarray(q, np.float64)
    k = max(len(q), 1)
    alpha = 0.5 / k
    p = (p + alpha) / (1.0 + 0.5)
    q = (q + alpha) / (1.0 + 0.5)
    return float(np.sum((p - q) ** 2 / q))


_METRIC_FNS = {"js": js_divergence, "chisquare": chisquare_divergence}


@dataclass
class DriftEvent:
    """A sustained-drift firing: the window that tripped it, the score, and
    how many consecutive windows exceeded the threshold."""

    window: int
    divergence: float
    streak: int
    threshold: float


class DriftDetector:
    """Per-window divergence against a reference window, with hysteresis.

    The FIRST non-empty window becomes the reference; each later non-empty
    window is scored against it.  ``update`` returns a :class:`DriftEvent`
    when drift is sustained, else None.  Empty windows neither score nor
    extend the streak (no rows = no evidence)."""

    def __init__(self, threshold: float, min_windows: int = 2,
                 metric: str = "js", source: str = "both",
                 counters: Optional[Counters] = None):
        if metric not in _METRIC_FNS:
            raise ConfigError(
                f"unknown stream.drift.metric {metric!r}; known: {METRICS}")
        if source not in SOURCES:
            raise ConfigError(
                f"unknown stream.drift.source {source!r}; known: {SOURCES}")
        if threshold <= 0:
            raise ConfigError(
                f"stream.drift.threshold must be > 0, got {threshold}")
        self.threshold = float(threshold)
        self.min_windows = max(int(min_windows), 1)
        self.metric = metric
        self.source = source
        self.counters = counters if counters is not None else Counters()
        self.streak = 0
        self.fired = 0
        self.last_divergence: Optional[float] = None
        self._reference: Optional[List[np.ndarray]] = None

    @classmethod
    def from_conf(cls, conf: JobConfig,
                  counters: Optional[Counters] = None
                  ) -> Optional["DriftDetector"]:
        """A detector when ``stream.drift.threshold`` is set; else None."""
        threshold = conf.get_float("stream.drift.threshold")
        if threshold is None:
            return None
        return cls(threshold,
                   min_windows=conf.get_int("stream.drift.min.windows", 2),
                   metric=conf.get("stream.drift.metric", "js"),
                   source=conf.get("stream.drift.source", "both"),
                   counters=counters)

    # -- distributions --------------------------------------------------------
    def _distributions(self, tables: ScanTables) -> List[np.ndarray]:
        """The monitored probability vectors of one window, in a fixed
        order: [class?, feature 0 marginal?, feature 1 marginal?, ...].

        ``source="features"`` with no [F, B, C] table in the window is a
        LOUD error: it means no registered consumer aggregates feature
        counts, so the detector would score 0.0 forever while the operator
        believes covariate-shift monitoring is armed.  ``source="both"``
        degrades to class-only in that case by design (class counts are
        always aggregated)."""
        if self.source == "features" and tables.fbc is None:
            raise ConfigError(
                "stream.drift.source=features but no registered consumer "
                "aggregates the [F, B, C] feature count table — add a "
                "counting consumer (naiveBayes / mutualInfo / cramer) to "
                "stream.consumers, or monitor source=class")
        out: List[np.ndarray] = []
        if self.source in ("class", "both"):
            counts = np.asarray(tables.class_counts, np.float64)
            out.append(counts / max(counts.sum(), _EPS))
        if self.source in ("features", "both") and tables.fbc is not None:
            marginals = np.asarray(tables.fbc, np.float64).sum(axis=2)  # [F,B]
            for i in range(marginals.shape[0]):
                row = marginals[i, :int(tables.meta.n_bins[i])]
                out.append(row / max(row.sum(), _EPS))
        return out

    def divergence(self, tables: ScanTables) -> float:
        """Max divergence of this window's distributions vs the reference
        (0.0 before a reference exists)."""
        if self._reference is None:
            return 0.0
        fn = _METRIC_FNS[self.metric]
        return max((fn(p, q) for p, q in
                    zip(self._distributions(tables), self._reference)),
                   default=0.0)

    def rebase(self, tables: ScanTables) -> None:
        """Make this window the reference distribution (initial window, or
        the post-retrain regime)."""
        self._reference = self._distributions(tables)

    # -- checkpointable state (rides the WindowCheckpointer snapshot) ---------
    def state(self) -> dict:
        """Reference distributions + hysteresis cursors — everything a
        resumed stream needs so its drift sequence matches an
        uninterrupted run's over the remaining windows."""
        return {
            "streak": self.streak,
            "fired": self.fired,
            "last": self.last_divergence,
            "reference": (list(self._reference)
                          if self._reference is not None else None),
        }

    def load(self, state: dict) -> None:
        self.streak = int(state["streak"])
        self.fired = int(state["fired"])
        last = state["last"]
        self.last_divergence = None if last is None else float(last)
        ref = state["reference"]
        self._reference = ([np.asarray(r) for r in ref]
                           if ref is not None else None)

    # -- the per-window step --------------------------------------------------
    def update(self, window, commit: bool = True) -> Optional[DriftEvent]:
        """Score one :class:`~avenir_tpu_torch.stream.windows.WindowResult`;
        returns a :class:`DriftEvent` when drift is sustained.

        ``commit=False`` leaves the firing UNCONSUMED: the reference does
        not rebase and the streak keeps growing, so the very next drifted
        window fires again.  A caller whose drift response can fail or
        defer (the retrain controller) scores with ``commit=False`` and
        calls :meth:`commit_fire` only once the response actually landed —
        otherwise a one-time step change whose first firing was deferred
        would become the rebased "normal" and never re-fire."""
        if window.rows == 0:
            # no evidence — reset the published score so a consumer of
            # per-window drift lines never reads the PREVIOUS window's
            # divergence attributed to this one
            self.last_divergence = 0.0
            return None
        if self._reference is None:
            self.rebase(window.tables)
            self.last_divergence = 0.0
            return None
        d = self.divergence(window.tables)
        self.last_divergence = d
        drifted = d > self.threshold
        self.streak = self.streak + 1 if drifted else 0
        tel.tracer().event("drift.window", window=window.index,
                           divergence=round(d, 6),
                           threshold=self.threshold, streak=self.streak)
        if self.streak < self.min_windows:
            return None
        event = DriftEvent(window=window.index, divergence=d,
                           streak=self.streak, threshold=self.threshold)
        self.fired += 1
        self.counters.increment("Stream", "drift.detected")
        tel.tracer().event("drift.detected", window=window.index,
                           divergence=round(d, 6),
                           threshold=self.threshold, windows=self.streak)
        if commit:
            self.commit_fire(window.tables)
        return event

    def commit_fire(self, tables: ScanTables) -> None:
        """Consume a firing: the drifted regime becomes the new normal
        (without a rebase the detector would re-fire every window forever)
        and the streak resets."""
        self.rebase(tables)
        self.streak = 0
