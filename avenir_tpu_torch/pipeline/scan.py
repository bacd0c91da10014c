"""SharedScan — one encode and one gram pass serving every count job of a
pipeline; port of ``avenir_tpu/pipeline/scan.py`` (the NB, MI, correlation,
Fisher and moments consumers, without the mesh routes, the planner's
pruning and the stream windows' restore).

The reference runs one MapReduce Tool per statistic, each rescanning the
dataset.  Here the stages that read one artifact share:

- ONE chunk stream (native parse → encode → ``DeviceFeeder`` staging, via
  the jobs' ``encoded_data_source``);
- ONE device pass per chunk (:class:`ChunkFolder`): the co-occurrence gram
  G (``ops/hist.py``: B1, or B2/B3 in the per-class plan modes) and the
  class moments of the same resident chunk (``hist.gram_moments``) when a
  consumer wants them;
- 64-bit host accumulation keyed by the layout-qualified ``g_key``.

At the end each consumer is finalized from the shared tables through the
models' data-free constructors: NB's [F, B, C] table is G's diagonal block,
MI's pair tensors are ``counts_from_cooc``, a correlation stage's
contingency tables are the class-summed pair tensors (feature pairs) or the
[F, B, C] block (against the class), and Fisher reads the class moments.  The results equal each
model's own ``fit`` over the same chunks (tests/test_torch_scan.py).

Row-validity: rows whose label is out of range drop out of every table
(the NB/MI drop-invalid contract).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from avenir_tpu_torch.core.encoding import EncodedDataset, peek_chunks
from avenir_tpu_torch.device import to_device
from avenir_tpu_torch.ops import agg
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

    - ``kernel``: ``hist.use_kernel(f, b, c, device)`` — the data is on
      CUDA and some plan mode takes the shape — one gram launch per chunk
      (B1, B2 or B3), with the class moments beside it;
    - ``packed``: elsewhere, where ``hist.pack_tables`` finds that one
      one-hot product (``hist.gram_counts``) beats the per-table counts;
    - ``einsum``: else the ``agg`` counts per table, as
      ``MutualInformation.fit`` runs them.

    All three give equal counts: the read-out ``counts_from_cooc`` reads
    the same cells of either gram."""

    def __init__(self, consumers: Sequence[ScanConsumer],
                 meta: EncodedDataset, device, pair_chunk: int = 256,
                 pack_on: bool = True,
                 pack_max_width: Optional[int] = None):
        from avenir_tpu_torch.ops import hist

        if not consumers:
            raise ScanError("no consumers registered")
        self.consumers = list(consumers)
        self.meta = meta
        self.device = torch.device(device)
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
            self.step = ("kernel" if hist.use_kernel(f, b, c, self.device)
                         else "einsum")
        if self.step == "einsum" and pack_on:
            self.pack = hist.pack_tables(f, b, c, len(self.pair_index),
                                         max_width=pack_max_width)
            if self.pack is not None:
                self.step = "packed"
        self.gk = (self.pack.g_key if self.step == "packed"
                   else hist.g_key(f, b, c))

    @property
    def program_tag(self) -> Optional[str]:
        """Routing label; a packed routing carries its pack signature."""
        if self.step == "packed":
            return f"packed:{self.pack.signature}"
        return self.step

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
        ``blackbox.watchdog.sec`` is unset).  The JAX package also takes
        a tenancy slot here; the port has no arbiter (ROADMAP.md, Queue 1
        item 7f)."""
        from avenir_tpu_torch.telemetry import blackbox

        with blackbox.watchdog_guard("fold"):
            self._fold(ds, acc)

    def _fold(self, ds: EncodedDataset, acc: agg.Accumulator) -> None:
        from avenir_tpu_torch.ops import hist

        labels = to_device(ds.labels, self.device)
        codes = to_device(ds.codes, self.device)
        cont = to_device(ds.cont, self.device) if self.needs_moments else None
        acc.add("class", agg.class_counts(labels, self.c))
        moments = None
        if self.step == "kernel":
            if self.needs_moments:
                g, *moments = hist.gram_moments(codes, labels, cont,
                                                self.b, self.c)
            else:
                g = hist.cooc_counts(codes, labels, self.b, self.c)
            acc.add(self.gk, g)
        elif self.step == "packed":
            if self.needs_moments:
                g, *moments = hist.gram_counts_moments(codes, labels, cont,
                                                       self.b, self.c)
            else:
                g = hist.gram_counts(codes, labels, self.b, self.c)
            acc.add(self.gk, g)
        elif self.step == "einsum":
            acc.add("fc", agg.feature_class_counts(codes, labels,
                                                   self.c, self.b))
            for s in range(0, len(self.pair_index), self.pair_chunk):
                sl = torch.from_numpy(
                    self.pair_index[s:s + self.pair_chunk]).to(self.device,
                                                              torch.long)
                acc.add(f"pcc{s}", agg.pair_class_counts(
                    codes[:, sl[:, 0]], codes[:, sl[:, 1]], labels,
                    self.c, self.b))
        if self.needs_moments and moments is None:
            moments = agg.class_moments(cont, labels, self.c)
        if moments is not None:
            acc.add("cont_count", moments[0])
            acc.add("cont_sum", moments[1])
            acc.add("cont_sumsq", moments[2])

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
                    f"accumulator holds gram state under {foreign} but this "
                    f"fold reads {self.gk!r}: the layout changed since that "
                    f"state was written")
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
    :class:`ChunkFolder`, and returns ``{consumer.name: result}``."""

    def __init__(self, device=None, pair_chunk: int = 256,
                 pack_on: bool = True,
                 pack_max_width: Optional[int] = None):
        from avenir_tpu_torch.device import resolve_device

        self.device = resolve_device(device)
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
                             pack_max_width=self.pack_max_width)
        import time

        from avenir_tpu_torch.telemetry import profile as _profile
        from avenir_tpu_torch.telemetry import spans as tel
        from avenir_tpu_torch.utils import profiling

        tracer = tel.tracer()
        prof = _profile.profiler()
        acc = agg.Accumulator()
        rows = 0
        self.chunks_seen = 0
        self.count_path = folder.program_tag or "moments"
        attrs = {"consumers": [x.name for x in self._consumers],
                 "path": self.count_path}
        # the scan is a range of its own in a trace.xla.dir device trace
        with tracer.span("scan", attrs=attrs) as scan_span, \
                profiling.region("scan"):
            for ds in chunks:
                chunk_attrs = {"chunk": self.chunks_seen, "rows": ds.num_rows}
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
                    prof.sample_device_memory("scan", [self.device])
                rows += ds.num_rows
                self.chunks_seen += 1
            scan_span.set("chunks", self.chunks_seen)
            scan_span.set("rows", rows)
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
    stage on its own scan.  The JAX package's reasons, word for word."""
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
                   counters: Optional[Counters] = None):
    """``(consumer, writer)`` for one fusable stage (NB, MI, or a
    correlation job); the writer publishes the finalized result byte for
    byte as the standalone job writes it, and ``counters`` receives NB's
    model-row count."""
    from avenir_tpu_torch.jobs import get_job
    from avenir_tpu_torch.jobs.base import write_output
    from avenir_tpu_torch.jobs.explore import correlation_plan, mi_output_lines
    from avenir_tpu_torch.models import naive_bayes as nb

    if job == "BayesianDistribution":
        consumer = NaiveBayesConsumer(
            laplace=conf.get_float("laplace.smoothing", 1.0), name=name)

        def write_nb(model):
            lines = nb.model_to_lines(model, enc, delim=conf.field_delim)
            write_output(out_path, lines)
            if counters is not None:
                counters.set("Model", "Rows", len(lines))

        return consumer, write_nb
    if job == "MutualInformation":
        names_ = [schema.field_by_ordinal(fld.ordinal).name
                  for fld in enc.binned_fields]
        consumer = MutualInfoConsumer(feature_names=names_, name=name)

        def write_mi(result):
            write_output(out_path, mi_output_lines(conf, result, names_))

        return consumer, write_mi
    # CramerCorrelation / HeterogeneityReductionCorrelation
    src_idx, dst_idx, against_class, names_ = correlation_plan(
        conf, schema, enc)
    consumer = CorrelationConsumer(
        algorithm=get_job(job)._algorithm(conf), src=src_idx, dst=dst_idx,
        against_class=against_class, feature_names=names_, name=name)

    def write_corr(result):
        write_output(out_path, result.to_lines(delim=conf.field_delim))

    return consumer, write_corr


def run_fused_stages(stages, device=None) -> Dict[str, Counters]:
    """Run a group of fusable pipeline stages as ONE SharedScan on
    ``device``.

    ``stages``: ``(name, job, input_path, output_path, conf)`` tuples with
    one input and compatible confs (the driver checks both).  Builds one
    chunk source through the jobs' ``encoded_data_source``, registers one
    consumer per stage, runs the scan and writes each stage's output as
    its standalone job does.  Returns per-stage Counters, each with a
    ``SharedScan`` group; the first stage's also carries the stream's
    ``Task`` and ``Telemetry`` counters."""
    from avenir_tpu_torch.device import resolve_device
    from avenir_tpu_torch.jobs.base import Job

    first_conf = stages[0][4]
    in_path = stages[0][2]
    job_obj = Job()
    job_obj.device = resolve_device(device)
    schema = Job.load_schema(first_conf)
    counters = {name: Counters() for name, *_ in stages}
    enc, data, rows_fn = job_obj.encoded_data_source(
        first_conf, in_path, counters[stages[0][0]])
    engine = SharedScan(
        device=job_obj.device,
        pack_on=first_conf.get_bool("scan.pack.on", True),
        pack_max_width=first_conf.get_int("scan.pack.max.width", 0) or None)
    writers = {}
    for name, job, _inp, out_path, conf in stages:
        consumer, writers[name] = stage_consumer(
            name, job, conf, out_path, schema, enc, counters=counters[name])
        engine.register(consumer)
    results = engine.run(data)
    rows = rows_fn()
    for name, _job, _inp, _out, _conf in stages:
        writers[name](results[name])
        counters[name].set("Records", "Processed", rows)
        counters[name].set("SharedScan", "FusedStages", len(stages))
        counters[name].set("SharedScan", "Scans", 1)
        counters[name].set("SharedScan", "Chunks", engine.chunks_seen)
    return counters
