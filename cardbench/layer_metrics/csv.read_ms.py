"""Input (``jobs/base.py`` ``Job._iter_chunks_retrying``): a chunk
task's line read on the feeder's worker thread, the program's
``input.read`` spans summed over the traced window, over its chunks, in
ms."""

from cardbench.yardstick.span_means import per_chunk


def read(ctx):
    return per_chunk(ctx, "input.read")
