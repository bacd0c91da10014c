"""SharedScan — one encode and one gram pass serving every count job of a
pipeline; port of ``avenir_tpu/pipeline/scan.py`` (the NB, MI, correlation,
Fisher and moments consumers, the planner's seams, the stream windows'
restore check and the ``shard.*`` route over local devices).

The reference runs one MapReduce Tool per statistic, each rescanning the
dataset.  Here the stages that read one artifact share:

- ONE chunk stream (native parse → encode → ``DeviceFeeder`` staging, via
  the jobs' ``encoded_data_source``);
- ONE device pass per chunk (:class:`ChunkFolder`): the co-occurrence gram
  G (``ops/hist.py``: B1, or B2/B3 in the per-class plan modes) and the
  class moments of the same resident chunk (``hist.gram_moments``) when a
  consumer wants them;
- 64-bit host accumulation keyed by the layout-qualified ``g_key``.

Under a ``shard.*`` plan (``parallel/shard.py``) each chunk is padded to
its shard target and split into equal row blocks, one per device of the
mesh; each block is folded on its device (B1–B3 once per shard) and the
partials are summed (``parallel/collectives.py``), the gram keyed with
the mesh's qualifier.  The result equals the unsharded fold's.  Without
a plan, a data ``mesh`` (the jobs' ``auto_mesh``) splits each chunk the
same way and folds it as the JAX package does on the same kind of mesh:
the ``sharded`` route (B1–B3 a shard, the plain ``g_key``) on a mesh of
CUDA cards, the per-table ``agg`` counts a shard on a CPU mesh; neither
packs.

At the end each consumer is finalized from the shared tables through the
models' data-free constructors: NB's [F, B, C] table is G's diagonal block,
MI's pair tensors are ``counts_from_cooc``, a correlation stage's
contingency tables are the class-summed pair tensors (feature pairs) or the
[F, B, C] block (against the class), and Fisher reads the class moments.  The results equal each
model's own ``fit`` over the same chunks (tests/test_torch_scan.py).

Row-validity: rows whose label is out of range drop out of every table
(the NB/MI drop-invalid contract).

Traced, a scan is a ``scan`` span holding a ``scan.read`` and a
``scan.chunk`` a chunk (in it each ``scan.launch``, ``acc.fetch`` and
``acc.add``), then ``scan.finalize`` beside it; every live span is also
a ``torch.profiler`` range while a capture runs (``telemetry/spans.py``).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from avenir_tpu_torch.core.encoding import EncodedDataset, peek_chunks
from avenir_tpu_torch.device import to_device
from avenir_tpu_torch.ops import agg
from avenir_tpu_torch.telemetry import spans as tel
from avenir_tpu_torch.utils.metrics import Counters


class ScanError(ValueError):
    """A SharedScan configuration the engine cannot serve."""


class ScanTables:
    """The shared per-stream totals every consumer finalizes from."""

    def __init__(self, meta: EncodedDataset, rows: int,
                 class_counts: np.ndarray,
                 fbc: Optional[np.ndarray],
                 pair_index: np.ndarray,
                 pcc: Optional[np.ndarray],
                 moments: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]):
        self.meta = meta                      # first-chunk shape metadata
        self.rows = rows
        self.class_counts = class_counts      # [C] int64
        self.fbc = fbc                        # [F, B, C] int64 or None
        self.pair_index = pair_index          # [P, 2] all i<j binned pairs
        self.pcc = pcc                        # [P, B, B, C] int64 or None
        self.moments = moments                # (cnt [C], s1 [C,Fc], s2) or None

    def pair_pos(self) -> Dict[Tuple[int, int], int]:
        return {(int(i), int(j)): k
                for k, (i, j) in enumerate(self.pair_index)}


class ScanConsumer:
    """Base consumer: declare what the scan must compute, finalize from
    the shared tables.  ``name`` keys the result in :meth:`SharedScan.run`'s
    output dict (pipeline stages use their stage name)."""

    needs_bin = False          # the [F, B, C] class-conditional table
    needs_pairs = False        # the [P, B, B, C] pair-class tensors
    needs_moments = False      # continuous (count, Σx, Σx²) class moments

    def __init__(self, name: str = ""):
        self.name = name or type(self).__name__

    def required_pairs(self, num_binned: int) -> List[Tuple[int, int]]:
        """The (i, j) i<j feature pairs this consumer reads; the engine
        aggregates the union across consumers."""
        return []

    def finalize(self, tables: ScanTables):
        raise NotImplementedError


class NaiveBayesConsumer(ScanConsumer):
    """NB class-conditional counts are G's [F, B, C] diagonal block; the
    Gaussian moments ride the fused moment step.  Finalizes through
    ``naive_bayes.model_from_counts``, equal to ``NaiveBayes.fit``."""

    needs_bin = True
    needs_moments = True

    def __init__(self, laplace: float = 1.0, name: str = ""):
        super().__init__(name)
        self.laplace = laplace

    def finalize(self, t: ScanTables):
        from avenir_tpu_torch.models import naive_bayes as nb

        mom = t.moments
        return nb.model_from_counts(
            class_values=list(t.meta.class_values),
            n_bins=np.asarray(t.meta.n_bins, np.int64),
            bin_counts=t.fbc,
            class_counts=t.class_counts,
            cont_count=mom[0] if mom is not None else None,
            cont_sum=mom[1] if mom is not None else None,
            cont_sumsq=mom[2] if mom is not None else None,
            laplace=self.laplace,
        )


class MutualInfoConsumer(ScanConsumer):
    """All MI distribution families from the shared [F, B, C] and
    [P, B, B, C] tensors — ``mutual_info.result_from_counts``."""

    needs_bin = True
    needs_pairs = True

    def __init__(self, feature_names: Optional[Sequence[str]] = None,
                 name: str = ""):
        super().__init__(name)
        self.feature_names = feature_names

    def required_pairs(self, num_binned: int) -> List[Tuple[int, int]]:
        return [(i, j) for i in range(num_binned)
                for j in range(i + 1, num_binned)]

    def finalize(self, t: ScanTables):
        from avenir_tpu_torch.models import mutual_info as mi

        meta = t.meta
        f, b, c = meta.num_binned, meta.max_bins, meta.num_classes
        names = (list(self.feature_names) if self.feature_names is not None
                 else [f"f{o}" for o in meta.binned_ordinals])
        fbc = t.fbc if t.fbc is not None else np.zeros((f, b, c), np.int64)
        pcc = t.pcc if t.pcc is not None else np.zeros((0, b, b, c), np.int64)
        return mi.result_from_counts(
            feature_names=names,
            class_values=list(meta.class_values),
            n_bins=meta.n_bins,
            class_counts=t.class_counts,
            feature_class_counts=fbc,
            pair_index=t.pair_index,
            pair_class_counts=pcc,
        )


class CorrelationConsumer(ScanConsumer):
    """Cramér / heterogeneity statistics from the shared gram: the
    against-class contingency stack is the [F, B, C] diagonal block, the
    feature-pair stack the class-summed pair read-out —
    ``correlation.result_from_counts``, with the attribute selection of
    ``CategoricalCorrelation.fit``."""

    def __init__(self, algorithm: str = "cramerIndex",
                 src: Optional[Sequence[int]] = None,
                 dst: Optional[Sequence[int]] = None,
                 against_class: bool = False,
                 feature_names: Optional[Sequence[str]] = None,
                 name: str = ""):
        super().__init__(name)
        from avenir_tpu_torch.models.correlation import STATS
        if algorithm not in STATS:
            raise ValueError(
                f"unknown algorithm {algorithm!r}; known: {sorted(STATS)}")
        self.algorithm = algorithm
        self.src = src
        self.dst = dst
        self.against_class = against_class
        self.feature_names = feature_names
        self.needs_bin = against_class
        self.needs_pairs = not against_class

    def required_pairs(self, num_binned: int) -> List[Tuple[int, int]]:
        from avenir_tpu_torch.models.correlation import select_pairs

        if self.against_class:
            return []
        return select_pairs(num_binned, [""] * num_binned, self.src,
                            self.dst)[0]

    def finalize(self, t: ScanTables):
        from avenir_tpu_torch.models import correlation as corr

        meta = t.meta
        f, b, c = meta.num_binned, meta.max_bins, meta.num_classes
        names = (list(self.feature_names) if self.feature_names is not None
                 else [f"f{o}" for o in meta.binned_ordinals])
        pairs, pair_names = corr.select_pairs(f, names, self.src, self.dst,
                                              self.against_class)
        if self.against_class and t.fbc is not None:
            cont = corr.class_tables(t.fbc, pairs, max(b, c))
        elif self.against_class:                 # no binned feature
            cont = np.zeros((len(pairs), max(b, c), max(b, c)), np.int64)
        elif pairs:
            pos = t.pair_pos()
            sel = np.array([pos[p] for p in pairs], np.int64)
            cont = t.pcc[sel].sum(axis=-1)               # [P, B, B] int64
        else:
            cont = np.zeros((0, b, b), np.int64)
        return corr.result_from_counts(self.algorithm, pairs, pair_names,
                                       cont, meta.n_bins, meta.num_classes)


class FisherConsumer(ScanConsumer):
    """Univariate Fisher discriminant from the fused class moments —
    ``fisher.model_from_moments`` over the ``class_moments`` sums the
    standalone fit accumulates."""

    needs_moments = True

    def finalize(self, t: ScanTables):
        from avenir_tpu_torch.models import fisher

        if t.moments is None:
            raise ScanError("Fisher consumer requires continuous features")
        cnt, s1, s2 = t.moments
        return fisher.model_from_moments(list(t.meta.class_values),
                                         cnt, s1, s2)


class MomentsConsumer(ScanConsumer):
    """The raw per-class (count, Σx, Σx²) totals of the continuous block,
    from the same fused moment step."""

    needs_moments = True

    def finalize(self, t: ScanTables):
        if t.moments is None:
            raise ScanError("Moments consumer requires continuous features")
        return t.moments


class ChunkFolder:
    """One SharedScan chunk pass, folding into a caller-owned
    :class:`~avenir_tpu_torch.ops.agg.Accumulator`.

    Fixes the routing once from the consumers and the stream's shape:

    - ``shard``: under a ``shard.*`` plan where some plan mode takes the
      shape — each shard's block folded on its device
      (``collectives.sharded_scan_step``: one gram launch per shard on
      ``cuda``, its plain version on the CPU) and the partials summed,
      the gram keyed under the mesh-qualified ``g_key``;
    - ``kernel``: without a mesh, ``hist.use_kernel(f, b, c, device)`` —
      the data is on CUDA and some plan mode takes the shape — one gram
      launch per chunk (B1, B2 or B3), with the class moments beside it;
    - ``sharded``: under a data ``mesh`` of CUDA cards where some plan
      mode takes the shape — one gram launch per shard, summed
      (``collectives.sharded_scan_step``), under the plain ``g_key``;
    - ``packed``: without a mesh, where ``hist.pack_tables`` finds that
      one one-hot product (``hist.gram_counts``) beats the per-table
      counts;
    - ``einsum``: else the ``agg`` counts per table, as
      ``MutualInformation.fit`` runs them (under a plan or a mesh, per
      shard on each shard's device, summed in shard order).

    All give equal counts: the read-out ``counts_from_cooc`` reads the
    same cells of either gram.  ``counters`` receives the ``Shard`` group
    of a sharded fold."""

    def __init__(self, consumers: Sequence[ScanConsumer],
                 meta: EncodedDataset, device, pair_chunk: int = 256,
                 pack_on: bool = True,
                 pack_max_width: Optional[int] = None, shard=None,
                 counters: Optional[Counters] = None, mesh=None):
        from avenir_tpu_torch.ops import hist
        from avenir_tpu_torch.parallel.mesh import mesh_on_cuda

        if not consumers:
            raise ScanError("no consumers registered")
        self.consumers = list(consumers)
        self.meta = meta
        self.device = torch.device(device)
        self.shard = shard                # parallel/shard.ShardSpec or None
        self.mesh = shard.mesh if shard is not None else mesh
        self.counters = counters
        self.pair_chunk = pair_chunk
        f, b, c = meta.num_binned, meta.max_bins, meta.num_classes
        self.f, self.b, self.c = f, b, c
        self.needs_counts = any(x.needs_bin or x.needs_pairs
                                for x in self.consumers) and f > 0 and b > 0
        self.needs_moments = any(x.needs_moments
                                 for x in self.consumers) and meta.num_cont > 0
        union = sorted({p for x in self.consumers
                        for p in x.required_pairs(f)})
        self.pair_index = (np.array(union, np.int32).reshape(-1, 2) if union
                           else np.zeros((0, 2), np.int32))
        self.step = None
        self.pack = None
        if self.needs_counts:
            from avenir_tpu_torch.parallel import collectives

            if shard is not None and hist.applicable(f, b, c):
                self._shard_step = collectives.sharded_scan_step(
                    shard.mesh, b, c, data_axis=shard.data_axis,
                    quantized=shard.quantized, moments=self.needs_moments,
                    proc_axis=shard.proc_axis if shard.is_global else None)
                self.step = "shard"
            elif self.mesh is None and hist.use_kernel(f, b, c, self.device):
                self.step = "kernel"
            elif mesh_on_cuda(self.mesh) and hist.applicable(f, b, c):
                self._shard_step = collectives.sharded_scan_step(
                    self.mesh, b, c, moments=self.needs_moments)
                self.step = "sharded"
            else:
                self.step = "einsum"
        # the packed gram is one unsharded program
        if self.step == "einsum" and pack_on and self.mesh is None:
            self.pack = hist.pack_tables(f, b, c, len(self.pair_index),
                                         max_width=pack_max_width)
            if self.pack is not None:
                self.step = "packed"
        self.gk = (self.pack.g_key if self.step == "packed"
                   else hist.g_key(f, b, c) + self.g_suffix)
        if self.step == "shard":
            # the JAX package's logical all-reduce payload of one chunk:
            # the gram (int8 and float32 row scales when quantized, int32
            # otherwise) and the class count and moment sums; a global
            # plan pays two legs, the exact in-process sum and the
            # cross-process one (int8 when quantized)
            mode, _, wp = hist.plan(f, b, c)
            cells = (c * wp * wp) if mode in ("cls", "clsb") else (wp * wp)
            qbytes = cells + 4 * (cells // wp)
            counts = 4 * c * (2 + 2 * meta.num_cont
                              if self.needs_moments else 1)
            if shard.is_global:
                self._collective_bytes = (
                    4 * cells + (qbytes if shard.quantized else 4 * cells)
                    + 2 * counts)
            else:
                self._collective_bytes = (
                    (qbytes if shard.quantized else 4 * cells) + counts)
        # the straggler probe, built on the first fold under profile.on
        self._skew = None

    @property
    def program_tag(self) -> Optional[str]:
        """Routing label; a packed routing carries its pack signature."""
        if self.step == "packed":
            return f"packed:{self.pack.signature}"
        return self.step

    def cost_probe(self, ds: EncodedDataset):
        """(fn, args) of this folder's one per-chunk program over ``ds`` on
        the folder's device — what the planner times (``pipeline/plan.py``):
        the kernel route's gram (B1–B3, with the moments beside it) or the
        packed one-hot product.  None on the einsum route, which is several
        programs a chunk."""
        from avenir_tpu_torch.ops import hist

        if self.step not in ("kernel", "packed"):
            return None
        codes = to_device(ds.codes, self.device)
        labels = to_device(ds.labels, self.device)
        kernel = self.step == "kernel"
        if self.needs_moments:
            fn = hist.gram_moments if kernel else hist.gram_counts_moments
            return fn, (codes, labels, to_device(ds.cont, self.device),
                        self.b, self.c)
        fn = hist.cooc_counts if kernel else hist.gram_counts
        return fn, (codes, labels, self.b, self.c)

    def cost(self, ds: EncodedDataset):
        """The analytic cost of this chunk's fold on the kernel route
        (``telemetry.profile.kernel_cost``), or None on the plain routes,
        which record their shapes only."""
        if self.step != "kernel":
            return None
        from avenir_tpu_torch.telemetry import profile as _profile

        return _profile.kernel_cost(
            "scan.chunk", self.f, self.b, self.c, ds.num_rows,
            num_cont=self.meta.num_cont if self.needs_moments else 0)

    def fold(self, ds: EncodedDataset, acc: agg.Accumulator) -> None:
        """One chunk's device pass and its 64-bit host accumulation into
        ``acc`` (which waits for the device once per chunk), inside a
        ``blackbox.watchdog_guard`` (one attribute check when
        ``blackbox.watchdog.sec`` is unset) and a tenancy slot: batch
        SharedScan chunks and stream panes both pass here, so one arbiter
        hook fair-queues both against every other tenant on the card.
        The slot covers the launch and the wait for the device, so it is
        held as long as the card works for the tenant.  Un-tenanted runs
        get the shared null context; a tenant past its queue share raises
        the typed ``TenantShedError`` to its own workload."""
        from avenir_tpu_torch import tenancy
        from avenir_tpu_torch.telemetry import blackbox

        with blackbox.watchdog_guard("fold"), tenancy.pool().slot():
            self._fold(ds, acc)

    def _fold(self, ds: EncodedDataset, acc: agg.Accumulator) -> None:
        """Place the chunk and fold it.  Traced: each group of work the
        host enqueues is a ``scan.launch`` span (here the placement and,
        off the sharded steps, the class count), each host accumulation
        an ``acc.fetch`` and an ``acc.add`` (``agg.Accumulator.add``)."""
        from avenir_tpu_torch.parallel.collectives import shard_sum
        from avenir_tpu_torch.parallel.mesh import place_batch

        sharded = self.step in ("shard", "sharded")
        with tel.tracer().span("scan.launch"):
            if self.shard is not None:
                codes, labels, cont = self.shard.shard_batch(
                    ds.codes, ds.labels, ds.cont)
            else:
                codes, labels, cont = place_batch(
                    self.mesh, self.device, ds.codes, ds.labels,
                    ds.cont if self.needs_moments else None)
            if not sharded:
                class_counts = shard_sum(agg.class_counts, labels, self.c)
        if sharded:
            self._fold_shard(codes, labels, cont, acc)
            return
        acc.add("class", class_counts)
        self._fold_local(codes, labels, cont, acc)

    def _fold_shard(self, codes, labels, cont, acc: agg.Accumulator) -> None:
        """One chunk through the per-shard gram step: every shard's gram,
        class counts (and class moments when a consumer reads them)
        summed over the shards; under a ``shard.*`` plan also the
        ``Shard`` counters and, under ``profile.on``, the straggler probe
        on the same staged blocks."""
        out = self._shard_step(codes, labels, cont)
        acc.add("class", out[1])
        acc.add(self.gk, out[0])
        if self.needs_moments:
            acc.add("cont_count", out[2])
            acc.add("cont_sum", out[3])
            acc.add("cont_sumsq", out[4])
        if self.shard is None:
            return
        if self.counters is not None:
            # staged rows include the ballast; true rows are the stream's
            # Records::Processed
            self.counters.increment("Shard", "chunks")
            self.counters.increment("Shard", "collective.bytes",
                                    self._collective_bytes)
        from avenir_tpu_torch.telemetry import profile as _profile

        if _profile.profiler().enabled:
            if self._skew is None:
                from avenir_tpu_torch.parallel.skew import DeviceSkewProbe

                self._skew = DeviceSkewProbe(self.shard, self.b, self.c,
                                             counters=self.counters)
            self._skew.maybe_probe(codes, labels)

    def _fold_local(self, codes, labels, cont, acc: agg.Accumulator) -> None:
        """The rest of one chunk on the kernel, packed or einsum route
        (:meth:`_fold` has counted the classes); on the einsum route a
        chunk split over a mesh (:class:`Blocks`) is counted per shard and
        summed in shard order."""
        from avenir_tpu_torch.ops import hist
        from avenir_tpu_torch.parallel.collectives import shard_sum

        tracer = tel.tracer()
        moments = None
        if self.step == "kernel":
            with tracer.span("scan.launch"):
                if self.needs_moments:
                    g, *moments = hist.gram_moments(codes, labels, cont,
                                                    self.b, self.c)
                else:
                    g = hist.cooc_counts(codes, labels, self.b, self.c)
            acc.add(self.gk, g)
        elif self.step == "packed":
            with tracer.span("scan.launch"):
                if self.needs_moments:
                    g, *moments = hist.gram_counts_moments(
                        codes, labels, cont, self.b, self.c)
                else:
                    g = hist.gram_counts(codes, labels, self.b, self.c)
            acc.add(self.gk, g)
        elif self.step == "einsum":
            with tracer.span("scan.launch"):
                fc = shard_sum(agg.feature_class_counts, codes, labels,
                               self.c, self.b)
            acc.add("fc", fc)
            for s in range(0, len(self.pair_index), self.pair_chunk):
                sl = torch.from_numpy(
                    self.pair_index[s:s + self.pair_chunk]).long()
                with tracer.span("scan.launch"):
                    pcc = shard_sum(agg.pair_class_counts_at, codes, labels,
                                    sl, self.c, self.b)
                # SharedScan accumulators live only for one fused scan, and windowed
                # pane accumulators carry the run fingerprint in their snapshot
                # envelope (stream/windows.py); the pcc<s> keys are the port
                # contract's and mirror models/mutual_info.py's family
                # graftlint: disable=GL002
                acc.add(f"pcc{s}", pcc)
        if self.needs_moments and moments is None:
            with tracer.span("scan.launch"):
                moments = shard_sum(agg.class_moments, cont, labels, self.c)
        if moments is not None:
            acc.add("cont_count", moments[0])
            acc.add("cont_sum", moments[1])
            acc.add("cont_sumsq", moments[2])

    @property
    def g_suffix(self) -> str:
        """The mesh qualifier this folder's gram key carries ("" off the
        sharded route), which a pane snapshot records as its writing
        topology."""
        return self.shard.g_suffix if self.step == "shard" else ""

    def state_matches_routing(self, state: Dict[str, Any]) -> bool:
        """Does a persisted accumulator-state mapping use THIS folder's
        key family?  False means folding it with fresh panes would mix
        key families, and the restore seam refuses it.  Catches a
        kernel↔einsum routing crossing in both directions — gram state
        written on ``cuda`` (``g:…``) landing on the CPU's einsum
        routing, and einsum ``fc`` counts landing on a gram routing
        (where :meth:`tables`' gram-first read-out would ignore them) —
        a packed gram under another key than this folder's, and a gram
        folded under another mesh topology (another ``g_suffix``).  State
        written under this folder's own topology matches and resumes;
        other state is adopted (:meth:`adopt_state`) or refused."""
        gram = [k for k in state
                if isinstance(k, str) and k.startswith("g:")]
        if self.step == "einsum":
            return not gram
        return "fc" not in state and all(k == self.gk for k in gram)

    def adopt_state(self, state: Dict[str, Any]) -> Tuple[Dict[str, Any],
                                                          List[str]]:
        """Redistribute one persisted accumulator-state mapping onto this
        folder's routing — "refuse or reshard, never silently fold":
        :meth:`tables` keeps the refusal, and the restore seams call this
        first under ``shard.reshard.on.restore``.  Returns ``(state,
        rekeyed_keys)``; state that already matches comes back as is.

        Exact by construction (``checkpoint/reshard.py``): the 64-bit host
        totals do not depend on the mesh, so a new qualifier moves the
        same bytes.  Packed and unpacked grams hold the same G for one
        (F, B, C), so the base key is renamed to this folder's own.  On
        the chunked-einsum routing a gram is demoted through
        ``counts_from_cooc``, the read-out :meth:`tables` runs.  Raises
        :class:`~avenir_tpu_torch.checkpoint.reshard.ReshardError` on a
        foreign base layout (the schema changed), mixed topology or
        provenance, or einsum counts promoted onto a gram routing (pairs
        outside the persisted union were never counted)."""
        from avenir_tpu_torch.checkpoint import reshard
        from avenir_tpu_torch.ops import hist

        reshard.state_suffix(state)         # refuse mixed-topology state
        base_gk = hist.g_key(self.f, self.b, self.c)
        accepted = {base_gk, hist.packed_g_key(self.f, self.b, self.c)}
        gram_keys = [k for k in state
                     if isinstance(k, str) and k.startswith("g:")]
        for key in gram_keys:
            base, _ = reshard.split_mesh_key(key)
            if base not in accepted:
                raise reshard.ReshardError(
                    f"gram state {key!r} has base layout {base!r} but "
                    f"this fold's is {base_gk!r} — the kernel layout "
                    f"(schema shape F/B/C) changed; no redistribution "
                    f"can reconcile different layouts")
        if len(gram_keys) > 1:
            raise reshard.ReshardError(
                f"state holds gram counts under {sorted(gram_keys)} — "
                f"mixed kernel/packed provenance in one mapping means "
                f"the same rows were split across two accumulators; "
                f"redistribution cannot prove they partition the stream")
        if gram_keys and "fc" in state:
            raise reshard.ReshardError(
                f"state holds both gram {gram_keys[0]!r} and einsum 'fc' "
                f"counts — mixed-routing state cannot be redistributed")
        if self.step == "einsum":
            if not gram_keys:
                return state, []            # same chunked-einsum routing
            (key,) = gram_keys
            out = {k: v for k, v in state.items() if k != key}
            fbc, pcc = hist.counts_from_cooc(
                np.asarray(state[key]), self.f, self.b, self.c,
                self.pair_index[:, 0], self.pair_index[:, 1])
            out["fc"] = np.asarray(fbc)
            pcc = np.asarray(pcc)
            for s in range(0, len(self.pair_index), self.pair_chunk):
                out[f"pcc{s}"] = pcc[s:s + self.pair_chunk]
            return out, [key]
        if "fc" in state and not gram_keys:
            raise reshard.ReshardError(
                "state was folded under the chunked-einsum routing "
                "('fc'/'pcc<off>' keys) but this fold reads the fused "
                "gram — pair counts outside the persisted union were "
                "never aggregated, so promotion is impossible; restore "
                "on an einsum-routed topology or start clean")
        # at most one gram key is left (one topology, one base): rename
        # its base to this routing's own, then move the mesh suffix
        renamed: List[str] = []
        own_base = self.pack.g_key if self.step == "packed" else base_gk
        if gram_keys:
            (key,) = gram_keys
            base, suffix = reshard.split_mesh_key(key)
            if base != own_base:
                state = {(own_base + suffix if k == key else k): v
                         for k, v in state.items()}
                renamed = [key]
        out, moved = reshard.rekey_state(state, self.g_suffix)
        return out, renamed + moved

    def tables(self, acc: agg.Accumulator, rows: int) -> ScanTables:
        """The shared totals from an accumulator this folder filled; an
        empty accumulator gives all-zero tables.  Gram state under any
        other layout key is refused, never silently dropped."""
        from avenir_tpu_torch.ops import hist

        f, b, c = self.f, self.b, self.c
        if self.needs_counts:
            foreign = [k for k in acc.names()
                       if k.startswith("g:") and k != self.gk]
            if foreign:
                raise ScanError(
                    f"accumulator holds gram state under {foreign} but "
                    f"this fold reads {self.gk!r} — the kernel layout or "
                    f"mesh topology (shard.devices / shard.data.axis) "
                    f"changed since that state was written; a resharded "
                    f"run must either redistribute the snapshot through "
                    f"checkpoint/reshard (shard.reshard.on.restore=true "
                    f"on the restore path) or start from a clean "
                    f"accumulator, never fold stale counts")
        fbc = pcc = None
        if self.needs_counts and self.gk in acc:
            fbc, pcc = hist.counts_from_cooc(
                acc.get(self.gk), f, b, c,
                self.pair_index[:, 0], self.pair_index[:, 1])
        elif self.needs_counts:
            fbc = (acc.get("fc") if "fc" in acc
                   else np.zeros((f, b, c), np.int64))
            pcc = (np.concatenate(
                [acc.get(f"pcc{s}") if f"pcc{s}" in acc
                 else np.zeros((min(self.pair_chunk,
                                    len(self.pair_index) - s), b, b, c),
                               np.int64)
                 for s in range(0, len(self.pair_index), self.pair_chunk)])
                if len(self.pair_index) else np.zeros((0, b, b, c), np.int64))
        moments = None
        if self.needs_moments:
            fc = self.meta.num_cont
            moments = ((acc.get("cont_count"), acc.get("cont_sum"),
                        acc.get("cont_sumsq")) if "cont_count" in acc
                       else (np.zeros(c, np.float64),
                             np.zeros((c, fc), np.float64),
                             np.zeros((c, fc), np.float64)))
        return ScanTables(
            meta=self.meta, rows=rows,
            class_counts=(acc.get("class") if "class" in acc
                          else np.zeros(c, np.int64)),
            fbc=fbc, pair_index=self.pair_index, pcc=pcc, moments=moments)

    def finalize(self, acc: agg.Accumulator, rows: int) -> Dict[str, Any]:
        """``{consumer.name: result}`` from an accumulator this folder
        filled."""
        tables = self.tables(acc, rows)
        return {cons.name: cons.finalize(tables) for cons in self.consumers}


class SharedScan:
    """Consumer registry and one-pass dispatch over an encoded chunk
    stream on ``device`` (``cuda`` unless the caller asks for the CPU).

    ``run(data)`` streams the chunks once, folds each through one
    :class:`ChunkFolder`, and returns ``{consumer.name: result}``.  With a
    ``shard`` plan the chunks fold over its mesh and ``counters`` receives
    the ``Shard`` group; without one, over the data ``mesh`` when given
    (:class:`ChunkFolder`)."""

    def __init__(self, device=None, pair_chunk: int = 256,
                 pack_on: bool = True,
                 pack_max_width: Optional[int] = None, shard=None,
                 counters: Optional[Counters] = None, mesh=None):
        from avenir_tpu_torch.device import resolve_device

        self.device = resolve_device(device)
        self.shard = shard                # parallel/shard.ShardSpec or None
        self.mesh = mesh
        self.mesh = shard.mesh if shard is not None else mesh
        self.counters = counters
        self.pair_chunk = pair_chunk
        self.pack_on = pack_on                 # scan.pack.on
        self.pack_max_width = pack_max_width   # scan.pack.max.width
        self.chunks_seen = 0              # set by run(); fused stages report it
        self.count_path = None            # routing tag of the last run()
        self._consumers: List[ScanConsumer] = []

    def register(self, consumer: ScanConsumer) -> ScanConsumer:
        if any(c.name == consumer.name for c in self._consumers):
            raise ScanError(f"duplicate consumer name {consumer.name!r}")
        self._consumers.append(consumer)
        return consumer

    @property
    def consumers(self) -> List[ScanConsumer]:
        return list(self._consumers)

    def run(self, data: Union[EncodedDataset, Iterable[EncodedDataset]]
            ) -> Dict[str, Any]:
        if not self._consumers:
            raise ScanError("no consumers registered")
        meta, chunks = peek_chunks(data)
        if meta.labels is None:
            raise ScanError(
                "SharedScan requires labels: every shared table is "
                "class-conditioned (see the row-validity contract)")
        folder = ChunkFolder(self._consumers, meta, self.device,
                             pair_chunk=self.pair_chunk, pack_on=self.pack_on,
                             pack_max_width=self.pack_max_width,
                             shard=self.shard, counters=self.counters,
                             mesh=self.mesh)
        import time

        from avenir_tpu_torch.telemetry import profile as _profile

        tracer = tel.tracer()
        prof = _profile.profiler()
        acc = agg.Accumulator()
        rows = 0
        self.chunks_seen = 0
        self.count_path = folder.program_tag or "moments"
        attrs = {"consumers": [x.name for x in self._consumers],
                 "path": self.count_path}
        devices = [self.device]
        if self.shard is not None:
            attrs["shard.devices"] = self.shard.num_devices
            attrs["shard.axis"] = self.shard.data_axis
            devices = list(self.shard.mesh.axis_devices(self.shard.data_axis))
        elif self.mesh is not None:
            devices = list(self.mesh.axis_devices("data"))
        chunks = iter(chunks)
        with tracer.span("scan", attrs=attrs) as scan_span:
            while True:
                # the input side: in a CSV job the reader and the encoder
                with tracer.span("scan.read"):
                    ds = next(chunks, None)
                if ds is None:
                    break
                # a chunk the sharded feeder staged arrives padded; its
                # valid_rows is the true count
                true_rows = (ds.valid_rows if ds.valid_rows is not None
                             else ds.num_rows)
                chunk_attrs = {"chunk": self.chunks_seen, "rows": true_rows}
                pkey = None
                if prof.enabled:
                    # the fold program: the chunk's shapes and routing,
                    # with the kernel's analytic cost on the kernel route
                    pkey = tel.CompileKeyMonitor.shape_key(
                        ds.codes, ds.labels, ds.cont) + (self.count_path,)
                    chunk_attrs["program"] = prof.observe(
                        pkey, site="scan.chunk", cost=folder.cost(ds))
                with tracer.span("scan.chunk", attrs=chunk_attrs):
                    # the host accumulation inside waits for the device,
                    # so the chunk span and the sample are synced
                    t0 = time.perf_counter()
                    folder.fold(ds, acc)
                    if pkey is not None:
                        prof.sample(pkey, "scan.chunk",
                                    time.perf_counter() - t0)
                if prof.enabled:
                    prof.sample_device_memory("scan", devices)
                rows += true_rows
                self.chunks_seen += 1
            scan_span.set("chunks", self.chunks_seen)
            scan_span.set("rows", rows)
        with tracer.span("scan.finalize"):
            return folder.finalize(acc, rows)


# ---------------------------------------------------------------------------
# driver-level stage fusion — the jobs a SharedScan can stand in for
# ---------------------------------------------------------------------------

FUSABLE_JOBS = ("BayesianDistribution", "MutualInformation",
                "CramerCorrelation", "HeterogeneityReductionCorrelation")

# conf keys that must agree across fused stages: they shape the shared
# encode (schema, delimiters) and the shared stream (chunking, prefetch,
# the device-mesh policy and the pack choice the one scan makes)
_COMPAT_KEYS = ("feature.schema.file.path", "field.delim.regex",
                "field.delim", "stream.chunk.rows", "stream.prefetch.depth",
                "data.parallel.auto", "shard.devices", "shard.data.axis",
                "shard.allreduce.quantized", "shard.proc.axis",
                "scan.pack.on", "scan.pack.max.width")


def fuse_refusal(job, conf) -> Optional[str]:
    """Why this (job name, stage conf) cannot ride a SharedScan, or None
    when it can: anything the fused path does not reproduce byte for byte
    (a per-stage opt-out, text-mode NB, a checkpointed stream) keeps the
    stage on its own scan.  The JAX package's reasons, word for word: in
    a fleet only an explicit ``shard.*`` topology fuses (the global fold
    splits each chunk across processes); without one, each job's round
    robin chunk ownership and end-of-stream merge is the contract."""
    if not isinstance(job, str) or job not in FUSABLE_JOBS:
        return "not a fusable count job"
    if not conf.get_bool("scan.fuse", True):
        return "scan.fuse=false opt-out"
    if conf.get("stream.checkpoint.dir"):
        return "checkpointed stream (stream.checkpoint.dir)"
    if job == "BayesianDistribution" and not conf.get_bool("tabular.input", True):
        return "text-mode NB (tabular.input=false)"
    if not conf.get("feature.schema.file.path"):
        return "no schema (feature.schema.file.path unset)"
    from avenir_tpu_torch.parallel.mesh import process_grid
    from avenir_tpu_torch.parallel.shard import ShardSpec

    if process_grid()[1] > 1 and not ShardSpec.requested(conf):
        return "multi-process without a shard.* topology"
    return None


def stage_fusable(job, conf) -> bool:
    """Can this (job name, stage conf) ride a SharedScan?  See
    :func:`fuse_refusal`."""
    return fuse_refusal(job, conf) is None


def stages_compatible(confs) -> bool:
    """Do these stage confs describe ONE scan?  Encoding and stream keys
    must agree, and the shared schema must declare a class attribute."""
    first = confs[0]
    for conf in confs[1:]:
        if any(conf.get(k) != first.get(k) for k in _COMPAT_KEYS):
            return False
    try:
        from avenir_tpu_torch.core.schema import FeatureSchema
        schema = FeatureSchema.from_file(first.get("feature.schema.file.path"))
    except Exception:
        return False
    return schema.class_field is not None


def stage_consumer(name, job, conf, out_path, schema, enc,
                   counters: Optional[Counters] = None,
                   keep: Optional[Sequence[int]] = None):
    """``(consumer, writer)`` for one fusable stage (NB, MI, or a
    correlation job); the writer publishes the finalized result byte for
    byte as the standalone job writes it and returns its line count, and
    ``counters`` receives NB's model-row count.  The planner builds
    consumers here without data.  ``keep`` (the sorted binned positions
    the planner's prune keeps) remaps a correlation stage's attribute
    selection into the pruned space; NB and MI read every column and
    refuse it."""
    from avenir_tpu_torch.jobs import get_job
    from avenir_tpu_torch.jobs.base import write_output
    from avenir_tpu_torch.jobs.explore import correlation_plan, mi_output_lines
    from avenir_tpu_torch.models import naive_bayes as nb

    if job == "BayesianDistribution":
        if keep is not None:
            raise ScanError("NB reads every binned column; cannot prune")
        consumer = NaiveBayesConsumer(
            laplace=conf.get_float("laplace.smoothing", 1.0), name=name)

        def write_nb(model):
            lines = nb.model_to_lines(model, enc, delim=conf.field_delim)
            write_output(out_path, lines)
            if counters is not None:
                counters.set("Model", "Rows", len(lines))
            return len(lines)

        return consumer, write_nb
    if job == "MutualInformation":
        if keep is not None:
            raise ScanError("MI aggregates every pair; cannot prune")
        names_ = [schema.field_by_ordinal(fld.ordinal).name
                  for fld in enc.binned_fields]
        consumer = MutualInfoConsumer(feature_names=names_, name=name)

        def write_mi(result):
            lines = mi_output_lines(conf, result, names_)
            write_output(out_path, lines)
            return len(lines)

        return consumer, write_mi
    # CramerCorrelation / HeterogeneityReductionCorrelation
    src_idx, dst_idx, against_class, names_ = correlation_plan(
        conf, schema, enc)
    if keep is not None:
        # the full-space selection remapped into the pruned space; a None
        # selection means every column, which the planner never prunes
        pos = {int(c): k for k, c in enumerate(keep)}
        src_idx = None if src_idx is None else [pos[i] for i in src_idx]
        dst_idx = None if dst_idx is None else [pos[i] for i in dst_idx]
        names_ = [names_[int(c)] for c in keep]
    consumer = CorrelationConsumer(
        algorithm=get_job(job)._algorithm(conf), src=src_idx, dst=dst_idx,
        against_class=against_class, feature_names=names_, name=name)

    def write_corr(result):
        lines = result.to_lines(delim=conf.field_delim)
        write_output(out_path, lines)
        return len(lines)

    return consumer, write_corr


def consumer_columns(consumer, num_binned: int) -> Optional[set]:
    """The binned columns a consumer reads, or None for all of them — the
    planner's dead-column rewrite.  NB and MI cover every column; a
    correlation stage restricted to explicit source and dest attributes
    touches only their union (each pair's statistic is sliced to its true
    ``n_bins`` support, so a narrower gram gives the same bytes)."""
    if not isinstance(consumer, CorrelationConsumer):
        return None
    if consumer.against_class:
        return None if consumer.src is None else set(int(i)
                                                     for i in consumer.src)
    if consumer.src is None or consumer.dst is None:
        return None
    cols: set = set()
    for i, j in consumer.required_pairs(num_binned):
        cols.add(int(i))
        cols.add(int(j))
    return cols


# conf keys that shape the encoded bytes of a whole-input read: the
# planner's encode-once cache key
_ENCODE_KEYS = ("feature.schema.file.path", "field.delim.regex",
                "field.delim")


def pruned_view(ds: EncodedDataset, keep: np.ndarray) -> EncodedDataset:
    """The dead-column rewrite on one chunk: the kept binned columns'
    codes, cardinalities and ordinals, everything else as it is (a host
    gather; the fold then builds the narrower gram)."""
    return EncodedDataset(
        codes=ds.codes[:, keep], cont=ds.cont, labels=ds.labels, ids=ds.ids,
        n_bins=np.asarray(ds.n_bins)[keep],
        class_values=ds.class_values,
        binned_ordinals=[ds.binned_ordinals[int(k)] for k in keep],
        cont_ordinals=ds.cont_ordinals, valid_rows=ds.valid_rows)


def run_fused_stages(stages, device=None,
                     prune: Optional[Sequence[int]] = None,
                     pack_on: Optional[bool] = None,
                     pack_max_width: Optional[int] = None,
                     encode_cache: Optional[dict] = None
                     ) -> Dict[str, Counters]:
    """Run a group of fusable pipeline stages as ONE SharedScan on
    ``device``.

    ``stages``: ``(name, job, input_path, output_path, conf)`` tuples with
    one input and compatible confs (the driver checks both).  Builds one
    chunk source through the jobs' ``encoded_data_source``, registers one
    consumer per stage, runs the scan and writes each stage's output as
    its standalone job does, each write (its lines made and its part file
    written) an ``output.write`` span (``stage``, ``lines``).  Returns
    per-stage Counters, each with a ``SharedScan`` group; the first
    stage's also carries the stream's ``Task`` and ``Telemetry``
    counters.

    The planner (``pipeline/plan.py``) passes its decisions: ``prune``
    folds only the listed binned columns (consumers remapped into the
    pruned space), ``pack_on`` / ``pack_max_width`` replace the runtime
    pack heuristic (the conf's ``scan.pack.on=false`` still wins), and
    ``encode_cache`` shares one whole-input encode among the units that
    read the same artifact under the same encode keys (only without
    ``stream.chunk.rows`` or a ``shard.*`` plan).

    The first stage's ``shard.*`` keys resolve to one plan
    (``ShardSpec.from_conf``) that decides the feeder's staging, the fold
    over the mesh and the mesh-qualified gram key; the plan's topology is
    journaled once (``shard.topology``), and the first stage's Counters
    carry the ``Shard`` group.  Without a plan the stages' data mesh
    (``Job.auto_mesh`` of the first stage's conf) decides the staging and
    the fold, as in the JAX package."""
    from avenir_tpu_torch.device import resolve_device
    from avenir_tpu_torch.jobs.base import Job
    from avenir_tpu_torch.parallel.shard import ShardSpec

    first_conf = stages[0][4]
    in_path = stages[0][2]
    job_obj = Job()
    job_obj.device = resolve_device(device)
    schema = Job.load_schema(first_conf)
    spec = ShardSpec.from_conf(first_conf, job_obj.device)
    # an explicit shard.* topology supersedes the implicit auto-mesh
    mesh = spec.mesh if spec is not None else job_obj.auto_mesh(first_conf)
    counters = {name: Counters() for name, *_ in stages}
    if spec is not None:
        spec.announce()
    ckey = None
    if (encode_cache is not None and spec is None
            and not first_conf.get("stream.chunk.rows")):
        ckey = (in_path,) + tuple(first_conf.get(k) for k in _ENCODE_KEYS)
    if ckey is not None and ckey in encode_cache:
        enc, data = encode_cache[ckey]
        rows_fn = (lambda d=data: d.num_rows)
    else:
        enc, data, rows_fn = job_obj.encoded_data_source(
            first_conf, in_path, counters[stages[0][0]], shard=spec,
            mesh=mesh)
        if ckey is not None and isinstance(data, EncodedDataset):
            encode_cache[ckey] = (enc, data)
    keep = None
    if prune is not None:
        keep = np.asarray(sorted(int(c) for c in prune), np.int64)
        if keep.size == len(enc.binned_fields):
            keep = None            # nothing dead: fold the full width
    conf_pack = first_conf.get_bool("scan.pack.on", True)
    engine = SharedScan(
        device=job_obj.device, shard=spec, mesh=mesh,
        counters=counters[stages[0][0]],
        pack_on=conf_pack if pack_on is None else pack_on and conf_pack,
        pack_max_width=(first_conf.get_int("scan.pack.max.width", 0) or None
                        if pack_max_width is None else pack_max_width))
    writers = {}
    for name, job, _inp, out_path, conf in stages:
        consumer, writers[name] = stage_consumer(
            name, job, conf, out_path, schema, enc, counters=counters[name],
            keep=None if keep is None else [int(k) for k in keep])
        engine.register(consumer)
    if keep is not None:
        data = (pruned_view(data, keep) if isinstance(data, EncodedDataset)
                else (pruned_view(ds, keep) for ds in data))
    results = engine.run(data)
    rows = rows_fn()
    tracer = tel.tracer()
    for name, _job, _inp, _out, _conf in stages:
        # under a global plan every process finalizes the same totals and
        # process 0 writes, as the streamed jobs do
        if Job.is_output_writer():
            with tracer.span("output.write") as sp:
                sp.set("lines", writers[name](results[name]))
                sp.set("stage", name)
        counters[name].set("Records", "Processed", rows)
        counters[name].set("SharedScan", "FusedStages", len(stages))
        counters[name].set("SharedScan", "Scans", 1)
        counters[name].set("SharedScan", "Chunks", engine.chunks_seen)
        if keep is not None:
            counters[name].set("SharedScan", "PrunedCols",
                               len(enc.binned_fields) - int(keep.size))
    return counters
