"""Input (``jobs/base.py`` ``encode_chunk``, ``runtime/native.py``): a
chunk's decode by the native encoder (or the Python one), the program's
``input.encode`` spans summed over the traced window, over its chunks,
in ms."""

from cardbench.yardstick.span_means import per_chunk


def read(ctx):
    return per_chunk(ctx, "input.encode")
