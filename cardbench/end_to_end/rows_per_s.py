"""Rows of every job completed in the window, over the time from the
window's start to the last completion."""

from cardbench.yardstick.stats import rate


def read(window):
    return rate(window.items, window.t0, window.ends[-1])
