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
tree, NumericalAttrStats, the Markov family) fold through
:func:`shard_sum` the same way: one count function per shard on that
shard's device, the partials summed in shard order.

The explicit steps of the JAX module (its ``:44-238``) follow the same
plan: :func:`sharded_nb_fit_step`, :func:`sharded_nb_fit_step_2d`,
:func:`sharded_mi_step` (counts), :func:`sharded_knn_topk` (a per-shard
top-k merged in shard order) and :func:`sharded_lr_step` (float32
gradient partials summed in shard order).  The JAX steps count with XLA
einsums, not with a Pallas kernel, so their counterparts here count with
``ops/agg.py`` (``bincount``) and scan with ``ops/knn.py``'s tile
scan on every device, a card included: none of them is the plain
version of B1–B6, and none stands in for a kernel.  The two-axis steps
put rows over ``data`` and a feature or pair block over ``model``: shard
(i, j) counts row block i of column block j on ``mesh.device_at(data=i,
model=j)``, and the sum over i lands on the ``model`` axis' j-th device,
so the large table comes back as :class:`Blocks` along its axis 0.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from avenir_tpu_torch.device import to_device
from avenir_tpu_torch.parallel.mesh import (Blocks, Mesh, maybe_shard_batch,
                                            pad_batch, padded_size,
                                            shard_parts)


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
                      moments: bool = True, proc_axis=None):
    """The sharded SharedScan chunk step: fn(codes, labels, cont) →
    (G, class counts [C], count [C], Σx [C, Fc], Σx² [C, Fc]), or just
    (G, class counts) under ``moments=False``, each reduced over the
    shards of ``mesh``'s data axis (the operands' :class:`Blocks`).

    G is exact (int32 partials summed), or under ``quantized`` the
    rounded :func:`quantized_allreduce_sum` of the partials, as the JAX
    package rounds it; class counts are always exact, the moments float64
    sums in shard order.

    With ``proc_axis`` (a fleet's global mesh) the operands are this
    process's row block and the reduction is hierarchical, as the JAX
    package's: the gram summed exactly over the local shards, then over
    the processes in process order (under ``quantized`` only this
    cross-process leg is the int8 reduce); class counts and moments are
    summed over every (process, shard) partial in that order.  One
    packed host gather a chunk (``mesh.all_process_gather_state``)
    carries the partials; every process gets the same totals."""
    from avenir_tpu_torch.ops import agg

    def local(codes, labels, cont):
        grams = shard_grams(mesh, codes, labels, num_bins, num_classes,
                            data_axis)
        cc = per_shard(lambda y: agg.class_counts(y, num_classes), labels)
        mom = (per_shard(lambda x, y: agg.class_moments(x, y, num_classes),
                         cont, labels) if moments else ())
        return grams, cc, mom

    def step(codes, labels, cont):
        grams, cc, mom = local(codes, labels, cont)
        if quantized:
            g = torch.round(quantized_allreduce_sum(grams)).to(torch.int32)
        else:
            g = all_reduce_sum(grams)
        cc = all_reduce_sum(shard_parts(cc))
        if not moments:
            return g, cc
        return (g, cc, *(all_reduce_sum(shard_parts(m)) for m in mom))

    def global_step(codes, labels, cont):
        from avenir_tpu_torch.parallel.mesh import all_process_gather_state

        grams, cc, mom = local(codes, labels, cont)
        dev = grams[0].device
        host = lambda parts: np.stack(  # noqa: E731
            [p.cpu().numpy() for p in shard_parts(parts)])
        mine = {"g": all_reduce_sum(grams).cpu().numpy(), "cc": host(cc)}
        for k, m in zip(("cnt", "s1", "s2"), mom):
            mine[k] = host(m)
        procs = all_process_gather_state(mine)
        gs = [torch.from_numpy(np.ascontiguousarray(p["g"])).to(dev)
              for p in procs]
        if quantized:
            g = torch.round(quantized_allreduce_sum(gs)).to(torch.int32)
        else:
            g = all_reduce_sum(gs)

        def flat(key):
            parts = [torch.from_numpy(np.ascontiguousarray(part)).to(dev)
                     for p in procs for part in p[key]]
            return all_reduce_sum(parts)

        if not moments:
            return g, flat("cc")
        return g, flat("cc"), flat("cnt"), flat("s1"), flat("s2")

    return step if proc_axis is None else global_step


# ---------------------------------------------------------------------------
# the explicit model steps (the JAX module's :44-238)
# ---------------------------------------------------------------------------

def _on_data(mesh: Mesh, data_axis: str, *arrays) -> list:
    """Operands split over ``mesh``'s data axis (:func:`maybe_shard_batch`:
    rows padded with −1 codes and 0.0 floats), a lone tensor of a
    one-device axis on that axis' device."""
    dev = mesh.axis_devices(data_axis)[0]
    return [a.to(dev) if isinstance(a, torch.Tensor) else a
            for a in maybe_shard_batch(mesh, *arrays, data_axis=data_axis)]


def _float_rows(a):
    """A float operand as float32 (its pads then fill with 0.0); a
    :class:`Blocks` or tensor stays where it is."""
    if isinstance(a, Blocks):
        return a
    if isinstance(a, torch.Tensor):
        return a.float()
    return np.asarray(a, np.float32)


def _host(a) -> np.ndarray:
    return a.numpy(force=True) if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _row_blocks(mesh: Mesh, data_axis: str, *arrays) -> list:
    """Each host array padded to a multiple of the data axis' size and cut
    into its equal row blocks (numpy, in shard order)."""
    d = mesh.size(data_axis)
    host = [_host(a) for a in arrays]
    padded = pad_batch(padded_size(host[0].shape[0], d), *host)
    if len(host) == 1:
        padded = [padded]
    return [np.split(a, d) for a in padded]


def _put(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return to_device(np.ascontiguousarray(a), device)


def _column_blocks(mesh: Mesh, model_axis: str, width: int, what: str
                   ) -> int:
    """The columns each ``model`` shard takes; raises unless ``width``
    divides over the axis, as the JAX package's ``shard_map`` does."""
    m = mesh.size(model_axis)
    if width % m:
        raise ValueError(f"{what} ({width}) is not divisible by the "
                         f"{model_axis!r} axis size {m}")
    return width // m


def sharded_nb_fit_step(mesh: Mesh, num_classes: int, num_bins: int,
                        num_cont: int, data_axis: str = "data"):
    """The Naive-Bayes sufficient statistics over ``mesh``'s data axis:
    fn(codes [N, F], labels [N], cont [N, Fc]) → (fbc [F, B, C], cc [C],
    cc, Σx [C, Fc], Σx² [C, Fc]).  Counts are exact int32 sums of the
    shards' ``agg`` counts; the moments float64 (``agg.class_moments``),
    summed in shard order."""
    from avenir_tpu_torch.ops import agg

    def step(codes, labels, cont):
        codes, labels, cont = _on_data(mesh, data_axis, codes, labels,
                                       _float_rows(cont))
        fbc = shard_sum(lambda c, y: agg.feature_class_counts(
            c, y, num_classes, num_bins), codes, labels)
        cc = shard_sum(lambda y: agg.class_counts(y, num_classes), labels)
        _count, s1, s2 = shard_sum(lambda x, y: agg.class_moments(
            x, y, num_classes), cont, labels)
        return fbc, cc, cc, s1, s2

    return step


def sharded_nb_fit_step_2d(mesh: Mesh, num_classes: int, num_bins: int,
                           data_axis: str = "data",
                           model_axis: str = "model"):
    """The (data × model) NB step: fn(codes [N, F], labels [N]) → (fbc,
    cc).  Rows go over ``data`` and features over ``model``; fbc comes
    back as :class:`Blocks` over the ``model`` axis' devices, block j the
    [F / model, B, C] counts of feature block j summed over the data
    shards, and cc [C] on the first device.  F must divide over
    ``model``."""
    from avenir_tpu_torch.ops import agg

    def step(codes, labels):
        fw = _column_blocks(mesh, model_axis, _host(codes).shape[1],
                            "the feature count")
        code_rows, label_rows = _row_blocks(mesh, data_axis, codes, labels)
        blocks = []
        for j in range(mesh.size(model_axis)):
            parts = []
            for i, (c, y) in enumerate(zip(code_rows, label_rows)):
                dev = mesh.device_at(**{data_axis: i, model_axis: j})
                parts.append(agg.feature_class_counts(
                    _put(c[:, j * fw:(j + 1) * fw], dev), _put(y, dev),
                    num_classes, num_bins))
            blocks.append(all_reduce_sum(parts))
        cc = all_reduce_sum([
            agg.class_counts(_put(y, mesh.device_at(**{data_axis: i})),
                             num_classes)
            for i, y in enumerate(label_rows)])
        return Blocks(tuple(blocks)), cc

    return step


def sharded_mi_step(mesh: Mesh, num_classes: int, num_bins: int,
                    data_axis: str = "data", model_axis: str = "model"):
    """The (data × model) MI count step: fn(codes [N, F], labels [N],
    ci [P], cj [P]) → (pabc, fbc [F, B, C], cc [C]).  Rows go over
    ``data`` and the pair list over ``model``: pabc comes back as
    :class:`Blocks` over the ``model`` axis' devices, block j the
    [P / model, B, B, C] joint counts of pair block j summed over the data
    shards; fbc and cc on the first device.  Each shard keeps the JAX
    package's per-shard chunk cap (``agg.check_chunk``).  P must divide
    over ``model``."""
    from avenir_tpu_torch.ops import agg

    def step(codes, labels, ci, cj):
        ci, cj = _host(ci).astype(np.int64), _host(cj).astype(np.int64)
        pw = _column_blocks(mesh, model_axis, len(ci), "the pair count")
        code_rows, label_rows = _row_blocks(mesh, data_axis, codes, labels)

        def pair_block(c, y, i, j):
            agg.check_chunk(c.shape[0])
            dev = mesh.device_at(**{data_axis: i, model_axis: j})
            sel = slice(j * pw, (j + 1) * pw)
            return agg.pair_class_counts(
                _put(c[:, ci[sel]], dev), _put(c[:, cj[sel]], dev),
                _put(y, dev), num_classes, num_bins)

        pabc = Blocks(tuple(
            all_reduce_sum([pair_block(c, y, i, j) for i, (c, y)
                            in enumerate(zip(code_rows, label_rows))])
            for j in range(mesh.size(model_axis))))
        firsts = [mesh.device_at(**{data_axis: i})
                  for i in range(len(code_rows))]
        fbc = all_reduce_sum([
            agg.feature_class_counts(_put(c, d), _put(y, d), num_classes,
                                     num_bins)
            for c, y, d in zip(code_rows, label_rows, firsts)])
        cc = all_reduce_sum([agg.class_counts(_put(y, d), num_classes)
                             for y, d in zip(label_rows, firsts)])
        return pabc, fbc, cc

    return step


def sharded_knn_topk(mesh: Mesh, k: int, num_bins: int,
                     metric: str = "euclidean", data_axis: str = "data",
                     ref_tile: int = 65536):
    """Exact global k-NN with the references split over the data axis:
    fn(test_codes, test_cont, ref_codes, ref_cont, lo, hi, n_real) →
    ([M, k] float32 distances, [M, k] int64 global reference indices).

    The queries go to every shard; each shard walks its reference block
    in ``ref_tile``-row tiles with a running top-k
    (``ops/knn.py::topk_over_tiles``; the whole block as one tile
    when it is not tile-divisible), its indices offset by the block's
    base and pad rows (global index ≥ ``n_real``) masked to +inf.  The
    [M, D·k] candidates are gathered onto the first shard's device in
    shard order and cut to k by a stable sort, so an equal distance keeps
    the lower global index.  Requires k ≤ a shard's rows."""
    from avenir_tpu_torch.ops.knn import topk_over_tiles

    def step(test_codes, test_cont, ref_codes, ref_cont, lo, hi, n_real):
        rc, rx = _on_data(mesh, data_axis, ref_codes, _float_rows(ref_cont))
        n_real = int(n_real)
        local = int(shard_parts(rc)[0].shape[0])
        if k > local:
            raise ValueError(f"k={k} exceeds a shard's {local} reference "
                             f"rows")
        tile = ref_tile if local >= ref_tile and local % ref_tile == 0 \
            else local
        queries = [torch.as_tensor(a) for a in (test_codes, test_cont, lo,
                                                hi)]
        best = []
        for i, (c, x) in enumerate(zip(shard_parts(rc), shard_parts(rx))):
            tc, tx, lo_d, hi_d = (q.to(c.device) for q in queries)
            base = i * local
            d, idx = topk_over_tiles(
                tc, tx, c.reshape(local // tile, tile, c.shape[1]),
                x.reshape(local // tile, tile, x.shape[1]),
                min(max(n_real - base, 0), local), lo_d, hi_d, k, num_bins,
                metric)
            best.append((d, idx + base))
        dev = best[0][0].device
        cd = torch.cat([d.to(dev) for d, _ in best], dim=1)
        ci = torch.cat([i.to(dev) for _, i in best], dim=1)
        order = torch.sort(cd, dim=1, stable=True).indices[:, :k]
        return torch.gather(cd, 1, order), torch.gather(ci, 1, order)

    return step


def sharded_lr_step(mesh: Mesh, data_axis: str = "data"):
    """The data-parallel logistic-regression step: fn(w [D], x [N, D],
    y [N], n_total, lr, l2) → new w [D] float32 on the first shard's
    device.  Each shard computes its float32 partial xᵀ(y − σ(xw)) on its
    device (``ops/linear.py::chunk_grad``, TF32 off); the partials
    are summed in shard order, then ``w + lr · (Σ / n_total − l2 · w)`` in
    float32.  Pad rows are 0.0 and add nothing; ``n_total`` is the true
    row count."""
    from avenir_tpu_torch.ops.linear import chunk_grad, full_float32

    def step(w, x, y, n_total, lr, l2):
        x, y = _on_data(mesh, data_axis, _float_rows(x), _float_rows(y))
        dev = mesh.axis_devices(data_axis)[0]
        w, n_total, lr, l2 = (torch.as_tensor(v, dtype=torch.float32).to(dev)
                              for v in (w, n_total, lr, l2))
        with full_float32():
            g = shard_sum(lambda xs, ys, ws: chunk_grad(ws, xs, ys), x, y, w)
            return w + lr * (g / n_total - l2 * w)

    return step
