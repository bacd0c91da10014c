"""Output (``pipeline/scan.py`` ``run_fused_stages``): each stage's part
file, its lines made and written, the program's ``output.write`` spans
summed over a job, the mean over the traced window's jobs, in ms."""

from cardbench.yardstick.span_means import per_job


def read(ctx):
    return per_job(ctx, "output.write")
