"""Per-shard folds and their reductions — port of the scan half of
``avenir_tpu/parallel/collectives.py``.

The JAX package runs one ``shard_map`` program per chunk: each device's
Pallas gram over its rows, then ``psum`` over the data axis.  Here each
shard's block is folded on its own device through the same wrapper the
unsharded scan launches (``ops/hist.py::cooc_counts``: B1, or B2/B3 in
the per-class modes, one launch per shard; its plain version for a CPU
block), and the partials are summed in shard order onto the mesh's first
device — the all-reduce as explicit tensor adds, in one process.  The
int32 gram and class counts are exact whatever the order; the class
moments are float64 sums (``agg.class_moments``), exact where the JAX
package's float32 partials are.

The model steps of the JAX module (NB, NB-2D, kNN, LR, MI: its
``:44-238``) are ROADMAP.md, Queue 1 item 7g-ii.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from avenir_tpu_torch.parallel.mesh import Mesh, shard_parts


def all_reduce_sum(partials: Sequence[torch.Tensor]) -> torch.Tensor:
    """The exact sum of per-shard partials, added in shard order on the
    first shard's device."""
    total = partials[0]
    for p in partials[1:]:
        total = total + p.to(total.device)
    return total


def quantized_allreduce_sum(partials: Sequence[torch.Tensor]) -> torch.Tensor:
    """The EQuARX-style int8 all-reduce of the JAX package
    (``quantized_allreduce_sum``, arXiv 2506.17615) in its float32
    arithmetic: each shard's partial is quantized row by row (trailing
    axis) with the scale ``s = max(max|row|, 127) / 127``, rounded half to
    even to int8, then every shard's int8 block and scales are
    dequantized and summed in float32 on the first shard's device.

    Exact whenever every partial cell is ≤ 127 in magnitude (the scale is
    then 1); otherwise each shard's term is off by at most s/2 a cell.
    One process moves no bytes on a wire, so the bytes saved are the
    JAX package's logical payload only (``Shard::collective.bytes``)."""
    qmax = 127.0
    dev = partials[0].device
    out = None
    for x in partials:
        xf = x.to(torch.float32)
        s = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=qmax) / qmax
        q = torch.round(xf / s).to(torch.int8)
        term = q.to(dev).to(torch.float32) * s.to(dev)
        out = term if out is None else out + term
    return out


def check_placement(mesh: Mesh, data_axis: str, *arrays) -> None:
    """Raise unless each staged operand is split over ``mesh``'s data
    devices (a lone tensor only on a one-device axis): no fold runs more
    shards than the mesh has devices."""
    devs = [torch.device(d) for d in mesh.axis_devices(data_axis)]
    for x in arrays:
        blocks = shard_parts(x)
        if [b.device for b in blocks] != devs:
            raise ValueError(
                f"operand split over {[str(b.device) for b in blocks]}, "
                f"not the mesh's {data_axis!r} devices "
                f"{[str(d) for d in devs]}")


def shard_grams(mesh: Mesh, codes, labels, num_bins: int,
                num_classes: int, data_axis: str = "data"
                ) -> List[torch.Tensor]:
    """Each shard's gram G over its own rows, on its own device."""
    from avenir_tpu_torch.ops import hist

    check_placement(mesh, data_axis, codes, labels)
    return [hist.cooc_counts(c, y, num_bins, num_classes)
            for c, y in zip(shard_parts(codes), shard_parts(labels))]


def sharded_cooc_step(mesh: Mesh, num_bins: int, num_classes: int,
                      data_axis: str = "data"):
    """fn(codes, labels) → G: the per-shard gram summed exactly, in the
    single-device layout (``hist.plan`` / ``w_index``), so
    ``hist.counts_from_cooc`` reads it unchanged."""
    def step(codes, labels):
        return all_reduce_sum(shard_grams(mesh, codes, labels, num_bins,
                                          num_classes, data_axis))

    return step


def sharded_scan_step(mesh: Mesh, num_bins: int, num_classes: int,
                      data_axis: str = "data", quantized: bool = False,
                      moments: bool = True):
    """The sharded SharedScan chunk step: fn(codes, labels, cont) →
    (G, class counts [C], count [C], Σx [C, Fc], Σx² [C, Fc]), or just
    (G, class counts) under ``moments=False``, each reduced over the
    shards of ``mesh``'s data axis (the operands' :class:`Blocks`).

    G is exact (int32 partials summed), or under ``quantized`` the
    rounded :func:`quantized_allreduce_sum` of the partials, as the JAX
    package rounds it; class counts are always exact, the moments float64
    sums in shard order."""
    from avenir_tpu_torch.ops import agg

    def step(codes, labels, cont):
        grams = shard_grams(mesh, codes, labels, num_bins, num_classes,
                            data_axis)
        if quantized:
            g = torch.round(quantized_allreduce_sum(grams)).to(torch.int32)
        else:
            g = all_reduce_sum(grams)
        ys = shard_parts(labels)
        cc = all_reduce_sum([agg.class_counts(y, num_classes) for y in ys])
        if not moments:
            return g, cc
        parts = [agg.class_moments(x, y, num_classes)
                 for x, y in zip(shard_parts(cont), ys)]
        return (g, cc, *(all_reduce_sum([p[k] for p in parts])
                         for k in range(3)))

    return step
