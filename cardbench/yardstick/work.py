"""Work counts of the port's kernels, from the problem's shapes only.

A roofline share is the least time the card could take for the work the
inputs need, over the time the kernel took.  The counts here depend on
the problem (rows, features, bins, classes, queries, references, used
lanes) and never on the layout or padding an implementation chooses, so
a kernel that pads more does not earn a higher share.
"""

from __future__ import annotations

from typing import Sequence


def count_table_cells(n_bins: Sequence[int], num_classes: int) -> int:
    """Cells of the NB feature × class table and of every i < j feature
    pair × class table, at each feature's own bin count."""
    nb = [int(b) for b in n_bins]
    pairs = sum(nb[i] * nb[j] for i in range(len(nb))
                for j in range(i + 1, len(nb)))
    return num_classes * (sum(nb) + pairs)


def b1_bytes(rows: int, n_bins: Sequence[int], num_classes: int) -> int:
    """Bytes one launch of the co-occurrence count (B1) must move: the
    int32 codes [rows, F] and labels [rows] as handed over, read once, and
    the NB and pair count tables as int32, written once.  Its operations
    are increments of a sparse count, far below any peak, so bytes bound
    it."""
    f = len(n_bins)
    return 4 * f * rows + 4 * rows + 4 * count_table_cells(n_bins,
                                                          num_classes)


def knn_flops(queries: int, refs: int, used_lanes: int) -> int:
    """Operations of one kNN candidate launch (B5 or B6): the distance
    product of the query and reference operands over the lanes that can be
    non-zero, a multiply and an add for each."""
    return 2 * queries * refs * used_lanes


def knn_bytes(queries: int, refs: int, used_lanes: int, k: int) -> int:
    """Bytes one kNN candidate launch must move: the bf16 query and
    reference operands over the used lanes, read once, and each query's k
    answers (an int32 index and a float32 d²), written once."""
    return 2 * used_lanes * (queries + refs) + 8 * queries * k


def knn_used_lanes(num_binned: int, num_bins: int, num_cont: int) -> int:
    """Lanes the packed kNN operands use: the one-hot lanes of the binned
    features, six limb groups of the continuous ones and six norm lanes."""
    return num_binned * num_bins + 6 * num_cont + 6


def roofline_pct(seconds: float, peak_ops: float, ops: float,
                 peak_bytes: float, nbytes: float) -> float:
    """A kernel's share of its roofline, in per cent: the least time the
    card could take (the larger of ``ops`` over its operation peak and
    ``nbytes`` over its memory peak) over the time it took."""
    least = max(ops / peak_ops if ops else 0.0, nbytes / peak_bytes)
    return 100.0 * least / seconds


def knn_roofline_read(ctx, kernels: str, launch: str):
    """The roofline share of a kNN candidate kernel (B5 or B6) in a traced
    run: the kernels matching ``kernels`` by name in the device trace, a
    launch per kernel matching ``launch``, each launch the work of the
    cell's batch against its references; None where the trace has none."""
    if ctx.trace is None or ctx.peaks is None:
        return None
    seconds = ctx.trace.kernel_s(kernels)
    launches = len(ctx.trace.kernels(launch))
    if seconds <= 0 or launches == 0:
        return None
    s = ctx.shape
    m, n, w = s["batch"], s["refs"], s["used_lanes"]
    return roofline_pct(seconds, ctx.peaks["bf16_flops"],
                        launches * knn_flops(m, n, w),
                        ctx.peaks["hbm_bytes"],
                        launches * knn_bytes(m, n, w, s["k"]))
