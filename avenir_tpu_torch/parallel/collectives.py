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

The count models' ``mesh=`` seams (NB, MI, correlation, Fisher, the
tree, NumericalAttrStats) fold through :func:`shard_sum` the same way:
one count function per shard on that shard's device, the partials
summed in shard order.  The model steps of the JAX module
(``sharded_nb_fit_step``, ``sharded_nb_fit_step_2d``,
``sharded_knn_topk``, ``sharded_lr_step``, ``sharded_mi_step``: its
``:44-238``) are ROADMAP.md, Queue 1 item 7g-ii (b).
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from avenir_tpu_torch.parallel.mesh import Blocks, Mesh, shard_parts


def all_reduce_sum(partials: Sequence[torch.Tensor]) -> torch.Tensor:
    """The exact sum of per-shard partials, added in shard order on the
    first shard's device."""
    total = partials[0]
    for p in partials[1:]:
        total = total + p.to(total.device)
    return total


def quantized_allreduce_sum(partials: Sequence[torch.Tensor]) -> torch.Tensor:
    """The EQuARX-style int8 all-reduce of the JAX package
    (``quantized_allreduce_sum``, arXiv 2506.17615) in the float32
    arithmetic XLA compiles it to on the CPU: each shard's partial is
    quantized row by row (trailing axis) with the scale
    ``s = max(max|row|, 127) · float32(1/127)`` (XLA folds the division
    by 127 into a multiply by its float32 reciprocal), rounded half to
    even to int8, then every shard's term ``q · s`` is added to the
    running float32 sum in shard order with a single rounding (XLA fuses
    the product into the sum): the product and sum in float64, rounded
    once to float32.  Each step is an IEEE-rounded elementwise op, so
    ``cuda`` and the CPU give the same bits.

    Exact whenever every partial cell is ≤ 127 in magnitude (the scale is
    then 1); otherwise each shard's term is off by at most s/2 a cell.
    One process moves no bytes on a wire, so the bytes saved are the
    JAX package's logical payload only (``Shard::collective.bytes``)."""
    qmax = 127.0
    dev = partials[0].device
    out = None
    for x in partials:
        xf = x.to(torch.float32)
        inv = torch.tensor(1.0 / qmax, dtype=torch.float32, device=xf.device)
        s = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=qmax) * inv
        q = torch.round(xf / s).to(torch.int8)
        term = q.to(dev).double() * s.to(dev).double()
        out = term.float() if out is None else (out.double() + term).float()
    return out


def _shard_call(fn, args, i: int):
    """``fn`` on shard ``i``: each :class:`Blocks` operand's ``i``-th block,
    every other tensor copied to that block's device, the rest as given."""
    dev = next(a.parts[i].device for a in args if isinstance(a, Blocks))
    return fn(*(a.parts[i] if isinstance(a, Blocks)
                else a.to(dev) if isinstance(a, torch.Tensor) else a
                for a in args))


def per_shard(fn, *args):
    """``fn`` applied to each shard's blocks of the :class:`Blocks`
    operands, on that shard's device: a :class:`Blocks` of the results
    (a tuple of them when ``fn`` returns a tuple).  Without a
    :class:`Blocks` operand, ``fn(*args)`` itself."""
    blocks = [a for a in args if isinstance(a, Blocks)]
    if not blocks:
        return fn(*args)
    outs = [_shard_call(fn, args, i) for i in range(len(blocks[0].parts))]
    if isinstance(outs[0], tuple):
        return tuple(Blocks(tuple(o[k] for o in outs))
                     for k in range(len(outs[0])))
    return Blocks(tuple(outs))


def shard_sum(fn, *args):
    """A count function over a sharded batch: ``fn`` on each shard's
    blocks on that shard's device (:func:`per_shard`), the partials
    reduced in shard order by :func:`all_reduce_sum` onto the first
    shard's device — int32 / int64 counts exactly, float64 moments in
    shard order; a tuple result is reduced element by element.  Without
    a :class:`Blocks` operand, ``fn(*args)`` itself."""
    out = per_shard(fn, *args)
    if isinstance(out, Blocks):
        return all_reduce_sum(out.parts)
    if isinstance(out, tuple) and out and isinstance(out[0], Blocks):
        return tuple(all_reduce_sum(o.parts) for o in out)
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
    return list(shard_parts(per_shard(
        lambda c, y: hist.cooc_counts(c, y, num_bins, num_classes),
        codes, labels)))


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
        cc = shard_sum(lambda y: agg.class_counts(y, num_classes), labels)
        if not moments:
            return g, cc
        return (g, cc, *shard_sum(
            lambda x, y: agg.class_moments(x, y, num_classes), cont, labels))

    return step
