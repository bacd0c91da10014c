"""Fused scan (``pipeline/scan.py`` ``ChunkFolder._fold``): the host's
time enqueuing a chunk's work, the program's ``scan.launch`` spans (the
placement and the class count; B1 with its device transpose) summed
over the traced window, over its chunks, in ms."""

from cardbench.yardstick.span_means import per_chunk


def read(ctx):
    return per_chunk(ctx, "scan.launch")
