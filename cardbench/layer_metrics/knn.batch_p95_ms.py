"""kNN model (``models/knn.py`` ``KNN.predict``), where a call's tail
spreads too widely from run to run to be held end to end: the 95th
percentile of the traced window's calls that neither profile slowed,
each from the call until its answers are on the host, in ms."""

from cardbench.yardstick.stats import percentile


def read(ctx):
    return 1e3 * percentile(ctx.latencies, 95) if ctx.latencies else None
