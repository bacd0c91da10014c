"""kNN model (``models/knn.py`` ``KNN.predict``): the vote, weights,
class scores and the decision, the program's ``knn.vote`` span, the
mean per call, in ms."""

from cardbench.yardstick.span_means import per_call


def read(ctx):
    return per_call(ctx, "knn.vote")
