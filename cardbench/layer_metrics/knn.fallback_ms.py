"""kNN model (``models/knn.py``: the exact scan of the rows whose
certificate failed): the program's ``knn.fallback`` span, the mean per
call, a call without one counting 0, in ms."""

from cardbench.yardstick.span_means import per_call


def read(ctx):
    return per_call(ctx, "knn.fallback")
