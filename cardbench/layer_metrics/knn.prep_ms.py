"""kNN model (``models/knn.py``, ``ops/knn.py::search``): the query-side
host work before the launch (normalisation, upload, query pack), the
program's ``knn.prep`` spans, the mean per call, in ms."""

from cardbench.yardstick.span_means import per_call


def read(ctx):
    return per_call(ctx, "knn.prep")
