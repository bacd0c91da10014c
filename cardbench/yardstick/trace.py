"""Reading a ``torch.profiler`` Chrome trace: the device's busy time, its
idle gaps and what the host was doing in them, and kernel time by name.

Times in the trace are microseconds.  The profiled window is the range
the harness marks with a user annotation of a known name, or, in a trace
of device activity alone, the window's length by the host's clock from
the first device event; device events are clipped to it.
"""

from __future__ import annotations

import bisect
import json
import re
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
WINDOW_MARK = "cardbench.window"

Interval = Tuple[float, float]


class Trace:
    """The events of one profiled window: the span of the
    :data:`WINDOW_MARK` annotation, or, in a trace of device activity alone, ``window_s``
    from the first device event (the window's length by the host's
    clock, the card synchronised at both ends)."""

    def __init__(self, events: Sequence[dict],
                 window_s: Optional[float] = None):
        spans = [e for e in events if e.get("ph") == "X"]
        marks = [e for e in spans if e.get("name") == WINDOW_MARK
                 and e.get("cat") == "user_annotation"]
        if marks:
            self.start = float(marks[0]["ts"])
            self.end = self.start + float(marks[0]["dur"])
        elif window_s is not None:
            firsts = [float(e["ts"]) for e in spans
                      if e.get("cat") in DEVICE_CATS]
            self.start = min(firsts) if firsts else 0.0
            self.end = self.start + 1e6 * window_s
        else:
            raise ValueError(f"trace holds no {WINDOW_MARK!r} annotation")
        self.device: List[Tuple[float, float, str]] = []
        for e in spans:
            if e.get("cat") not in DEVICE_CATS:
                continue
            s = max(float(e["ts"]), self.start)
            t = min(float(e["ts"]) + float(e.get("dur", 0.0)), self.end)
            if t > s:
                self.device.append((s, t, str(e.get("name", ""))))
        self.device.sort()
        self.host = sorted(
            (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
             str(e.get("name", "")))
            for e in spans
            if e.get("cat") in HOST_CATS and e.get("name") != WINDOW_MARK)
        self._host_starts = [h[0] for h in self.host]

    @classmethod
    def load(cls, path: str, window_s: Optional[float] = None) -> "Trace":
        with open(path) as fh:
            doc = json.load(fh)
        events = doc["traceEvents"] if isinstance(doc, dict) else doc
        return cls(events, window_s)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    def busy_intervals(self) -> List[Interval]:
        """The union of the device events, as disjoint sorted intervals."""
        return merge((s, t) for s, t, _ in self.device)

    @property
    def busy_s(self) -> float:
        return sum(t - s for s, t in self.busy_intervals()) / 1e6

    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def kernels(self, pattern: str) -> List[Tuple[float, float, str]]:
        """Device events whose name, up to its argument list, matches the
        regular expression ``pattern`` (searched)."""
        rx = re.compile(pattern)
        return [d for d in self.device if rx.search(short_name(d[2]))]

    def kernel_s(self, pattern: str) -> float:
        return sum(t - s for s, t, _ in self.kernels(pattern)) / 1e6

    def top_ops(self, n: int = 10) -> List[List]:
        """The ``n`` device operations that took most time, by name."""
        total: Dict[str, float] = defaultdict(float)
        for s, t, name in self.device:
            total[short_name(name)] += t - s
        ranked = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name, us / 1e6] for name, us in ranked]

    def gaps(self) -> List[Interval]:
        """The idle gaps of the window: where no device event runs."""
        out, cursor = [], self.start
        for s, t in self.busy_intervals():
            if s > cursor:
                out.append((cursor, s))
            cursor = max(cursor, t)
        if self.end > cursor:
            out.append((cursor, self.end))
        return out

    def host_at(self, ts: float, lookback: int = 5000) -> Optional[str]:
        """The innermost host operation open at ``ts`` (the shortest one
        that covers it), or None."""
        hi = bisect.bisect_right(self._host_starts, ts)
        best = None
        for s, t, name in self.host[max(hi - lookback, 0):hi]:
            if t >= ts and (best is None or t - s < best[1] - best[0]):
                best = (s, t, name)
        return None if best is None else best[2]

    def idle_by_host(self, n: int = 10) -> List[List]:
        """Idle time summed by what the host was doing at each gap's
        middle, the ``n`` largest."""
        total: Dict[str, float] = defaultdict(float)
        for s, t in self.gaps():
            label = self.host_at(0.5 * (s + t)) or "no host op"
            total[short_name(label)] += t - s
        ranked = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name, us / 1e6] for name, us in ranked]


def merge(intervals: Iterable[Interval]) -> List[Interval]:
    out: List[List[float]] = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return [(s, t) for s, t in out]


def short_name(name: str, limit: int = 96) -> str:
    """A kernel's name without its return type, anonymous namespace and
    argument list, cut to ``limit`` characters: ``void (anonymous
    namespace)::f<8>(int*, ...)`` → ``f<8>``."""
    head = name.replace("(anonymous namespace)::", "").strip()
    if head.startswith("void "):
        head = head[5:]
    return head.split("(", 1)[0].strip()[:limit]
