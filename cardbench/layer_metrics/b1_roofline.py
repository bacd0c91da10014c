"""Kernel B1 (``csrc/cooc_pair.cu`` through ``ops/hist.py``): its share of
the roofline over its launches in the profiled window.  Its time is that
of its three kernels (the class count, the scatter sort and the pair
pass) by name in the device trace; its bytes are, for each launch, the
int32 codes and labels of a chunk read once and the NB and pair count
tables as int32 written once, over the card's HBM peak (a sparse count's
increments bound nothing)."""

from cardbench.yardstick.work import b1_bytes, roofline_pct

KERNELS = r"\b(class_count_kernel|class_scatter_kernel|pair_kernel)\b"
LAUNCH = r"\bpair_kernel\b"


def read(ctx):
    if ctx.trace is None or ctx.peaks is None:
        return None
    seconds = ctx.trace.kernel_s(KERNELS)
    launches = len(ctx.trace.kernels(LAUNCH))
    if seconds <= 0 or launches == 0:
        return None
    s = ctx.shape
    nbytes = launches * b1_bytes(s["chunk_rows"], s["n_bins"],
                                 s["num_classes"])
    return roofline_pct(seconds, ctx.peaks["int8_ops"], 0,
                        ctx.peaks["hbm_bytes"], nbytes)
