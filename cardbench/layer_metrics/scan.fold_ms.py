"""Fused scan (``pipeline/scan.py`` ``ChunkFolder.fold``, ``ops/agg.py``):
the mean of the program's ``scan.chunk`` spans over the traced window,
in ms.  A chunk's fold is the device transpose, B1, the class count, the
fetches of both to the host and their int64 accumulation there."""


def read(ctx):
    ms = ctx.span_ms("scan.chunk")
    return sum(ms) / len(ms) if ms else None
