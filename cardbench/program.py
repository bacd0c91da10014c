"""What the benchmark reads from the program under test besides its
entries: its launch and fallback counters and its span journal.

Each counter is a plain attribute the program keeps; a counter the
program no longer has reads None, and the metrics that need it are left
out of the line.
"""

from __future__ import annotations

import importlib
import importlib.util
from typing import Dict, List, Optional

PACKAGE = "avenir_tpu_torch"
SCAN_RUN_SPAN = "cardbench.scan.run"   # the benchmark's span around a job

COUNTERS = {
    "b1_launches": ("avenir_tpu_torch.ops.hist", "cooc_counts_cols.launches"),
    "b5_launches": ("avenir_tpu_torch.ops.knn", "knn_tourney.launches"),
    "b6_launches": ("avenir_tpu_torch.ops.knn", "knn_topk.launches"),
    "knn_fallback_rows": ("avenir_tpu_torch.models.knn",
                          "_nearest_neighbors_kernel.fallback_rows"),
}


def present() -> bool:
    """Is the program importable from this checkout?"""
    return importlib.util.find_spec(PACKAGE) is not None


def read_counters() -> Dict[str, Optional[int]]:
    out: Dict[str, Optional[int]] = {}
    for name, (module, attr) in COUNTERS.items():
        try:
            obj = importlib.import_module(module)
            for part in attr.split("."):
                obj = getattr(obj, part)
            out[name] = int(obj)
        except (ImportError, AttributeError, TypeError, ValueError):
            out[name] = None
    return out


def counter_deltas(before: Dict[str, Optional[int]],
                   after: Dict[str, Optional[int]]) -> Dict[str, Optional[int]]:
    return {k: (None if before.get(k) is None or after.get(k) is None
                else after[k] - before[k]) for k in after}


def span(name: str):
    """A span of the benchmark's own in the program's tracer: inert unless
    a :class:`SpanJournal` has it on."""
    from avenir_tpu_torch.telemetry import spans

    return spans.tracer().span(name)


class SpanJournal:
    """The program's span tracer, on for the window of a traced run, with
    its journal in ``directory``."""

    def __init__(self, directory: str):
        from avenir_tpu_torch.telemetry import spans

        self._tracer = spans.tracer()
        self._tracer.enable(journal_dir=directory)
        self.path = self._tracer.journal_path

    def unit_span(self, index: int):
        """The harness's span around one unit, which every span the
        program opens inside it descends from."""
        from cardbench.harness import UNIT_SPAN

        return self._tracer.span(UNIT_SPAN, attrs={"index": index})

    def close(self) -> List[dict]:
        """Turn the tracer off and return the journal's events."""
        from avenir_tpu_torch.telemetry import journal

        self._tracer.disable()
        return journal.read_events(self.path) if self.path else []
