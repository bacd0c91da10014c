"""kNN model on the B6 route (``models/knn.py``: B6's certificate and
its fallback to the exact scan), where the cell holds no tail end to
end: the share of the window's queries whose certificate failed, from
the program's ``fallback_rows`` counter."""


def read(ctx):
    rows = ctx.counters.get("knn_fallback_rows")
    if rows is None or not ctx.items:
        return None
    return 100.0 * rows / ctx.items
