"""Rate and percentile arithmetic, taken over every unit of a window."""

from __future__ import annotations

import math
from typing import Sequence


def rate(items: Sequence[int], t_start: float, t_last_end: float) -> float:
    """Items of every unit completed, over the time from the window's
    start to the last completion."""
    span = t_last_end - t_start
    if not items or span <= 0:
        raise ValueError("no unit completed in the window")
    return float(sum(items)) / span


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0 < q < 100) of all values, by the
    nearest rank: the smallest value with at least q% of the values at or
    below it.  Every value counts; none is dropped as an outlier."""
    if not values:
        raise ValueError("no values")
    if not 0 < q < 100:
        raise ValueError(f"percentile {q} outside (0, 100)")
    ordered = sorted(values)
    rank = max(math.ceil(q / 100.0 * len(ordered)), 1)
    return float(ordered[rank - 1])

