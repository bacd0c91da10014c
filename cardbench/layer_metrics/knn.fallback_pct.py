"""kNN model (``models/knn.py``: the tile loop and the certificate's
fallback to the exact scan): the share of the window's queries whose
certificate failed, from the program's ``fallback_rows`` counter."""


def read(ctx):
    rows = ctx.counters.get("knn_fallback_rows")
    if rows is None or not ctx.items:
        return None
    return 100.0 * rows / ctx.items
