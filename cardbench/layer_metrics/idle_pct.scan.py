"""Device (the card) under the fused scan: the share of the profiled
window in which no kernel, copy or fill runs (the union of the trace's
device intervals)."""


def read(ctx):
    return None if ctx.trace is None else ctx.trace.idle_pct()
