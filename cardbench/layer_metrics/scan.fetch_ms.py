"""Fused scan (``ops/agg.py`` ``Accumulator.add``): the host blocked on
the card while a chunk's class counts and gram come to it, the
program's ``acc.fetch`` spans summed over the traced window, over its
chunks, in ms."""

from cardbench.yardstick.span_means import per_chunk


def read(ctx):
    return per_chunk(ctx, "acc.fetch")
