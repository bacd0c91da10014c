"""Kernel B6 (``csrc/knn_topk.cu``: its range pass and its merge):
its share of the roofline over its launches in the profiled window, its
time by name in the device trace.  Each launch counts 2 · queries ·
references · used lanes bf16 operations and the bytes of its operands
over the used lanes and of the k answers a query; operations bound
it."""

from cardbench.yardstick.work import knn_roofline_read


def read(ctx):
    return knn_roofline_read(ctx, r"\b(topk_kernel|merge_kernel)\b",
                             r"\btopk_kernel\b")
