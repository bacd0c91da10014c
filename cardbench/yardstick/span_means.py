"""Means of the program's spans over a traced window's units: per chunk
of the fused scan, per job, and per kNN call.  Each reads only the
``LayerContext``'s span durations, which leave out the units either
profile slowed, and gives None where the program has no such span."""

from __future__ import annotations

from typing import Optional

CHUNK = "scan.chunk"          # one per chunk folded
CALL = "knn.predict"          # one per kNN call


def per_chunk(ctx, name: str) -> Optional[float]:
    """The ``name`` spans summed over the window, over the number of
    chunks (``scan.chunk`` spans), in ms."""
    ms = ctx.span_ms(name)
    chunks = len(ctx.span_ms(CHUNK))
    return sum(ms) / chunks if ms and chunks else None


def per_job(ctx, name: str) -> Optional[float]:
    """The mean over the window's units of each unit's ``name`` spans, in
    ms."""
    by_unit = ctx.span_ms_by_unit(name)
    return sum(by_unit.values()) / len(by_unit) if by_unit else None


def per_call(ctx, name: str) -> Optional[float]:
    """The mean over the window's kNN calls (units holding a
    ``knn.predict`` span) of each call's ``name`` spans, a call without
    one counting 0, in ms."""
    calls = ctx.span_ms_by_unit(CALL)
    if not calls:
        return None
    by_unit = ctx.span_ms_by_unit(name)
    return sum(by_unit.get(u, 0.0) for u in calls) / len(calls)
