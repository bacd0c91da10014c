"""The 95th percentile over every batch of the window of the time from
the call to ``predict`` until its answers are on the host."""

from cardbench.yardstick.stats import percentile


def read(window):
    return 1e3 * percentile(window.latencies, 95)
