"""Read-out and models (``ChunkFolder.finalize``,
``models/naive_bayes.py``, ``models/mutual_info.py``): the program's own
``scan.finalize`` span, the mean over the traced window's jobs, in ms."""

from cardbench.yardstick.span_means import per_job


def read(ctx):
    return per_job(ctx, "scan.finalize")
