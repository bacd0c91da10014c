"""kNN model (``ops/knn.py::search``): the host enqueuing B5 or B6, the
candidates' assembly, the exact re-rank and the certificate, the
program's ``knn.launch`` spans, the mean per call, in ms."""

from cardbench.yardstick.span_means import per_call


def read(ctx):
    return per_call(ctx, "knn.launch")
