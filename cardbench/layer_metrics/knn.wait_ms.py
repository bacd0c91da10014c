"""kNN model (``models/knn.py`` ``_nearest_neighbors_kernel``): the host
blocked on the card while each tile's answers come to it, the program's
``knn.fetch`` spans, the mean per call, in ms."""

from cardbench.yardstick.span_means import per_call


def read(ctx):
    return per_call(ctx, "knn.fetch")
