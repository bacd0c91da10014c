"""Kernel B5 (``csrc/knn_tourney.cu``):
its share of the roofline over its launches in the profiled window, its
time by name in the device trace.  Each launch counts 2 · queries ·
references · used lanes bf16 operations and the bytes of its operands
over the used lanes and of the k answers a query; operations bound
it."""

from cardbench.yardstick.work import knn_roofline_read

KERNELS = r"\btourney(_half)?_kernel\b"


def read(ctx):
    return knn_roofline_read(ctx, KERNELS, KERNELS)
