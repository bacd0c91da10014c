"""Fused scan (``ops/agg.py`` ``Accumulator.add``): the host's int64
widening and adding of a chunk's tables, the program's ``acc.add`` spans
summed over the traced window, over its chunks, in ms."""

from cardbench.yardstick.span_means import per_chunk


def read(ctx):
    return per_chunk(ctx, "acc.add")
