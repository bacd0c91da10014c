"""Read-out and models (``ChunkFolder.finalize``,
``models/naive_bayes.py``, ``models/mutual_info.py``): per job, the
benchmark's own span around ``SharedScan.run`` less the program's
``scan`` span inside it, the mean over the traced window's jobs, in
ms."""

from cardbench.program import SCAN_RUN_SPAN


def read(ctx):
    run = ctx.span_ms_by_unit(SCAN_RUN_SPAN)
    scan = ctx.span_ms_by_unit("scan")
    units = sorted(set(run) & set(scan))
    if not units:
        return None
    return sum(run[u] - scan[u] for u in units) / len(units)
