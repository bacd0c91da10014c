"""The planner — port of ``avenir_tpu/pipeline/plan.py``: the
conf-declared pipeline DAG lowered into plan units.

:func:`plan_pipeline` turns a pipeline's stages into an ordered unit list
in which every fusable count stage over one artifact, adjacent or not,
rides ONE scan unit (one parse, encode and gram pass).  Per unit these
rewrites fire:

- **fuse** — non-adjacent fusable stages over the same input collapse
  into one scan unit (the staged loop's ``_scan_group`` stops at the first
  non-fusable stage; the planner hoists past it where dependencies allow);
- **share-gram** — a stage whose ``uses`` edge names another member's
  output joins the unit and reads the same gram (the edge only orders: a
  fusable consumer is built from conf and schema, never from a data
  artifact).  An ``@artifact`` property is a value dependency and keeps
  the stage staged;
- **prune** — binned columns no member reads are dropped from the fold;
  a correlation statistic slices each pair to its true ``n_bins``
  support, so the narrower gram gives the same bytes;
- **pack** — the packed-against-einsum choice is made at plan time, by
  timing one dispatch of each candidate over a peeked sample chunk;
- **encode-once** — scan units reading the same artifact under the same
  encode keys share one whole-input encode (``scan.run_fused_stages``'s
  ``encode_cache``).

Checkpointed, text-mode and opted-out stages stay staged
(:class:`StageUnit`, the reason shown by ``plan explain``); under a resume
the satisfied stages become :class:`SkipUnit`.  A planned run writes the
staged run's bytes.

Where the port differs from the JAX package:

- **Costs.** The JAX package reads XLA's ahead-of-time cost analysis of
  each candidate program.  The port has no lowered program: the kernel
  route's cost is ``telemetry.profile.kernel_cost`` (the analytic bytes
  and operations of B1–B3, ``ops/hist.py::gram_work``), and the packed
  and einsum families get the analytic counts of :func:`_packed_cost`
  and :func:`_einsum_cost`.  ``pack_source`` keeps the JAX package's
  vocabulary; its ``"aot"`` value here names those analytic counts.
- **Timing.** A candidate is timed after ``torch.cuda.synchronize`` on
  ``cuda`` and by ``time.perf_counter`` on both devices; an error is
  never turned into a missing time.
- **The kernel route.** Wherever ``hist.use_kernel`` takes the shape on
  ``cuda`` the unit is one kernel program (B1, B2 or B3) with no pack
  question, so the planner never routes such a unit to a plain program.
- **The shard branch.** A unit under a ``shard.*`` topology is
  ``program = "shard"`` with no pack question, as in the JAX package, and
  a singleton count stage stays a scan unit there (the sharded fold lives
  only in the SharedScan).
- **The auto-mesh branch.** Where ``Job.auto_mesh`` gives a data mesh
  (``data.parallel.auto``, two or more local devices: the host slots of
  ``XLA_FLAGS`` on the CPU, the cards on ``cuda``) the unit is
  ``program = "sharded"`` with the einsum family's cost and no pack
  question, as in the JAX package; one H100 has no such mesh.

``python -m avenir_tpu_torch.pipeline plan <conf>`` prints
:meth:`PipelinePlan.explain`; ``plan.on=true`` routes ``Pipeline.run``
through :func:`run_plan`.
"""

from __future__ import annotations

import os
import re
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from avenir_tpu_torch.core.config import JobConfig
from avenir_tpu_torch.pipeline.driver import Pipeline, Stage

REWRITES = ("fuse", "share-gram", "prune", "encode-once", "pack")


@dataclass
class SkipUnit:
    """A resume-satisfied stage: journaled as ``stage.skipped`` at
    execution, its counters untouched."""

    stage: Stage


@dataclass
class StageUnit:
    """A stage the planner keeps on the staged path, and why."""

    stage: Stage
    conf: JobConfig
    reason: str


@dataclass
class ScanUnit:
    """One planned SharedScan serving one or more stages."""

    stages: List[Stage]
    confs: List[JobConfig]
    input: str                              # artifact name
    in_path: str
    rewrites: List[str] = field(default_factory=list)
    keep: Optional[List[int]] = None        # pruned binned positions
    pruned_from: int = 0                    # full binned width
    pack_on: Optional[bool] = None          # None = runtime heuristic
    pack_max_width: Optional[int] = None
    pack_source: str = ""                   # "measured" | "aot" | "model" | ""
    cost: Optional[dict] = None             # analytic cost over the sample
    cost_rows: int = 0                      # sample rows the cost covers
    wall_ms: Optional[float] = None         # measured sample-chunk dispatch
    program: str = ""                       # predicted routing tag
    staged_scans: int = 1                   # scans the staged path would pay


class PipelinePlan:
    """The ordered unit list :func:`plan_pipeline` produced, with the
    explain rendering and the ``plan.compiled`` journal summary."""

    def __init__(self, pipeline: Pipeline, units: List[object],
                 resume: bool):
        self.pipeline = pipeline
        self.units = units
        self.resume = resume

    @property
    def scan_units(self) -> List[ScanUnit]:
        return [u for u in self.units if isinstance(u, ScanUnit)]

    def _num_stages(self) -> int:
        return sum(len(u.stages) for u in self.scan_units) + sum(
            1 for u in self.units if not isinstance(u, ScanUnit))

    def summary(self) -> dict:
        """The ``plan.compiled`` event payload: unit and stage counts, the
        rewrites that fired anywhere, and the summed cost (null where no
        unit has one)."""
        scans = self.scan_units
        rewrites = sorted({r for u in scans for r in u.rewrites})

        def total(key: str) -> Optional[float]:
            vals = [u.cost.get(key) for u in scans if u.cost]
            vals = [v for v in vals if v is not None]
            return float(sum(vals)) if vals else None

        ranks = {"measured": 3, "aot": 2, "model": 1}
        best = max((ranks.get(u.pack_source, 0) for u in scans), default=0)
        source = {3: "measured", 2: "aot", 1: "model", 0: "none"}[best]
        return {"units": len(self.units), "stages": self._num_stages(),
                "fused": sum(len(u.stages) for u in scans),
                "rewrites": rewrites, "source": source,
                "est_flops": total("flops"),
                "est_bytes": total("bytes_accessed")}

    def explain(self) -> str:
        """The plan tree: one node per unit, member stages beneath, each
        scan unit's cost and the rewrites that fired — the JAX package's
        text, line for line."""
        lines = [f"PlanGraft: {self._num_stages()} stage(s) -> "
                 f"{len(self.units)} unit(s)"
                 + (" [resume]" if self.resume else "")]
        last = len(self.units) - 1
        for k, unit in enumerate(self.units):
            head = "`-" if k == last else "|-"
            bar = "  " if k == last else "| "
            if isinstance(unit, SkipUnit):
                lines.append(f"{head} skip {unit.stage.name}: output exists"
                             f" (resume)")
                continue
            if isinstance(unit, StageUnit):
                job = (unit.stage.job if isinstance(unit.stage.job, str)
                       else getattr(unit.stage.job, "__name__", "callable"))
                lines.append(f"{head} stage {unit.stage.name}: job={job} -- "
                             f"{unit.reason}")
                continue
            lines.append(
                f"{head} scan unit: input={unit.input} serves "
                f"{len(unit.stages)} stage(s) in 1 scan"
                + (f" (staged path ~ {unit.staged_scans} scans)"
                   if len(unit.stages) > 1 else ""))
            if unit.rewrites:
                lines.append(f"{bar}   rewrites: "
                             + ", ".join(unit.rewrites))
            if unit.keep is not None:
                lines.append(f"{bar}   prune: {unit.pruned_from} -> "
                             f"{len(unit.keep)} binned columns")
            detail = f"{bar}   program: {unit.program or '?'}"
            if unit.cost is not None:
                detail += " -- est " + _fmt_cost(unit.cost, unit.cost_rows)
                if unit.wall_ms is not None:
                    detail += f", predicted {unit.wall_ms:.2f} ms/chunk"
                detail += f" ({unit.pack_source or 'aot'})"
            elif unit.pack_source:
                detail += f" -- est unavailable ({unit.pack_source})"
            lines.append(detail)
            for m, s in enumerate(unit.stages):
                sub = "`-" if m == len(unit.stages) - 1 else "|-"
                lines.append(f"{bar}   {sub} {s.name} ({s.job}) -> "
                             f"{s.output}")
        return "\n".join(lines)


def _fmt_cost(cost: dict, rows: int) -> str:
    parts = []
    if cost.get("flops") is not None:
        parts.append(f"{cost['flops'] / 1e6:.3f} MFLOP")
    if cost.get("bytes_accessed") is not None:
        parts.append(f"{cost['bytes_accessed'] / 1e6:.3f} MB")
    body = " / ".join(parts) if parts else "n/a"
    return f"{body} per {rows}-row sample chunk"


# ---------------------------------------------------------------------------
# planning
# ---------------------------------------------------------------------------

def _join_shares(pipeline: Pipeline, cand: Stage, producers: Dict[str, Stage],
                 taken: set, member_names: set, member_outs: set,
                 stages: List[Stage], i: int, j: int, in_path: str
                 ) -> Optional[List[str]]:
    """Can ``cand`` (position ``j``) join the unit anchored at ``i``?
    The member outputs it reaches through ``uses`` (share-gram edges), or
    None when joining would reorder a real dependency:

    - an ``@artifact`` property naming a member output is a value
      dependency: the file does not exist until the unit finalizes;
    - a dependency produced by a stage not yet scheduled (it would run
      after this unit) refuses the hoist;
    - an unclaimed stage between the anchor and the candidate that
      rewrites the shared input, or the candidate's own output, would see
      another file under the hoisted order."""
    shares: List[str] = []
    prop_arts = [v[1:] for v in cand.props.values()
                 if isinstance(v, str) and v.startswith("@")]
    for art in prop_arts:
        if art in member_outs:
            return None
        prod = producers.get(art)
        if prod is not None and prod.name not in taken \
                and prod.name not in member_names:
            return None
    for art in cand.uses:
        if art in member_outs:
            shares.append(art)
            continue
        prod = producers.get(art)
        if prod is not None and prod.name not in taken \
                and prod.name not in member_names:
            return None
    for k in range(i + 1, j):
        mid = stages[k]
        if mid.name in taken or mid.name in member_names:
            continue
        if pipeline.path(mid.output) == in_path \
                or mid.output == cand.output:
            return None
    return shares


def _peek_sample(conf: JobConfig, in_path: str, rows: int):
    """``(EncodedDataset, estimated total rows)`` from the head of
    ``in_path``: shape-true metadata to cost and time the candidates
    over, and a bytes-per-row estimate of the file's rows (the wall model
    evaluates the candidates at the run's chunk size).  None when the
    input does not exist yet (a prior stage will write it) or its head
    does not parse; the plan then records model estimates only."""
    from avenir_tpu_torch.jobs.base import Job

    if rows <= 0 or not in_path or not os.path.isfile(in_path):
        return None
    enc = Job.encoder_for(conf)
    delim = conf.field_delim_regex
    parsed: List[List[str]] = []
    consumed = 0
    with open(in_path, "r", errors="replace") as fh:
        for line in fh:
            consumed += len(line)
            line = line.rstrip("\n")
            if not line.strip():
                continue
            parsed.append(re.split(delim, line))
            if len(parsed) >= rows:
                break
    ncols = enc.max_ordinal()
    parsed = [r for r in parsed if len(r) > ncols]
    if not parsed:
        return None
    est_rows = max(
        int(os.path.getsize(in_path) * len(parsed) / max(consumed, 1)),
        len(parsed))
    width = min(len(r) for r in parsed)
    try:
        ds = enc.fit_transform(
            np.asarray([r[:width] for r in parsed], dtype=object))
    except (ValueError, KeyError, IndexError):
        return None
    return ds, est_rows


def _cost(nbytes: float, ops: float, out_bytes: float) -> dict:
    return {"flops": float(ops), "bytes_accessed": float(nbytes),
            "output_bytes": float(out_bytes), "temp_bytes": None}


def _moments_work(n: int, num_cont: int, c: int):
    """(bytes, operations, output bytes) of ``agg.class_moments``: the
    float32 values and int32 labels read once, float64 (count, Σx, Σx²)
    written once, a multiply and add for each of Σx and Σx² per value."""
    out = 8 * c * (1 + 2 * num_cont)
    return 4 * n * num_cont + 4 * n + out, 4 * n * num_cont, out


def _einsum_cost(folder, ds) -> dict:
    """The analytic cost of the per-table family one chunk dispatches:
    class counts, the [F, B, C] table, every [B, B, C] pair table and the
    moments.  Each count table reads its int32 codes and labels once,
    writes int64 cells once, and adds one per row it counts."""
    n, f, b, c = ds.num_rows, folder.f, folder.b, folder.c
    nbytes, ops, out = 4 * n + 8 * c, n, 8 * c
    if folder.needs_counts:
        p = len(folder.pair_index)
        nbytes += 4 * n * f + 4 * n + 8 * f * b * c
        ops += n * f
        nbytes += p * (8 * n + 4 * n) + 8 * p * b * b * c
        ops += n * p
        out += 8 * f * b * c + 8 * p * b * b * c
    if folder.needs_moments:
        mb, mo, mout = _moments_work(n, ds.num_cont, c)
        nbytes, ops, out = nbytes + mb, ops + mo, out + mout
    return _cost(nbytes, ops, out)


def _packed_cost(folder, ds) -> dict:
    """The analytic cost of the packed fold's one product
    (``hist.gram_counts``): the int32 codes and labels read once, the
    int32 gram written once, and the dense float32 product of the
    one-hots — a multiply and add per row for every cell of the used
    lanes — plus the moments beside it."""
    from avenir_tpu_torch.ops import hist

    n = ds.num_rows
    g_cells, used = hist.gram_cells(folder.f, folder.b, folder.c)
    nbytes = 4 * folder.f * n + 4 * n + 4 * g_cells
    ops, out = 2 * used * used * n, 4 * g_cells
    if folder.needs_moments:
        mb, mo, mout = _moments_work(n, ds.num_cont, folder.c)
        nbytes, ops, out = nbytes + mb, ops + mo, out + mout
    return _cost(nbytes, ops, out)


def _probe_cost(folder, ds, site: str) -> Optional[dict]:
    """The cost of a one-program routing (the kernel's analytic
    ``kernel_cost``, or the packed product's), registered as a
    ``program.compiled`` record when profiling is on."""
    from avenir_tpu_torch.telemetry import profile as _profile
    from avenir_tpu_torch.telemetry import spans as tel

    if folder.step == "kernel":
        cost = folder.cost(ds)
    elif folder.step == "packed":
        cost = _packed_cost(folder, ds)
    else:
        return None
    prof = _profile.profiler()
    if prof.enabled:
        key = tel.CompileKeyMonitor.shape_key(ds.codes, ds.labels, ds.cont
                                              ) + (folder.program_tag,)
        prof.observe(key, site=site, cost=cost)
    return cost


# Measured sample-chunk walls, keyed by program and operand shapes.  A
# cost count cannot rank packed against einsum: the packed gram is one
# dense product (many operations, near peak), the einsum family many
# small scatter-shaped dispatches (few operations, dispatch-bound), so
# the selection times one dispatch of each over the peeked sample.
_WALL_CACHE: Dict[tuple, float] = {}


def _shape_sig(args, kwargs) -> tuple:
    sig = []
    for a in args:
        if isinstance(a, torch.Tensor):
            sig.append((tuple(a.shape), str(a.dtype), str(a.device)))
        else:
            sig.append(repr(a))
    return (tuple(sig), tuple(sorted((kwargs or {}).items())))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _measured_ms(tag: str, fn, args, device: torch.device,
                 kwargs=None) -> float:
    """The best of two timed dispatches after a warm one, in ms.  Every
    operand is on ``device``; on ``cuda`` each dispatch is drained before
    the clock reads.  An error propagates: a candidate is only built where
    its route takes the shape."""
    key = (tag, _shape_sig(args, kwargs))
    if key in _WALL_CACHE:
        return _WALL_CACHE[key]
    kw = kwargs or {}
    fn(*args, **kw)
    _sync(device)
    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        fn(*args, **kw)
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    _WALL_CACHE[key] = best * 1000.0
    return _WALL_CACHE[key]


def _einsum_wall_ms(folder, ds) -> float:
    """Measured wall of the per-table family over the sample: the same
    programs :func:`_einsum_cost` counts, on the folder's device."""
    from avenir_tpu_torch.device import to_device
    from avenir_tpu_torch.ops import agg

    dev = folder.device
    labels = to_device(ds.labels, dev)
    walls = [_measured_ms("class_counts", agg.class_counts,
                          (labels, folder.c), dev)]
    if folder.needs_counts:
        codes = to_device(ds.codes, dev)
        walls.append(_measured_ms(
            "feature_class_counts", agg.feature_class_counts,
            (codes, labels, folder.c, folder.b), dev))
        npairs = len(folder.pair_index)
        if npairs:
            sl = folder.pair_index[:min(folder.pair_chunk, npairs)]
            sl_t = torch.from_numpy(sl).to(dev, torch.long)
            one = _measured_ms(
                "pair_class_counts", agg.pair_class_counts,
                (codes[:, sl_t[:, 0]], codes[:, sl_t[:, 1]], labels,
                 folder.c, folder.b), dev)
            walls.append(one * (npairs / len(sl)))
    if folder.needs_moments:
        walls.append(_measured_ms("class_moments", agg.class_moments,
                                  (to_device(ds.cont, dev), labels,
                                   folder.c), dev))
    return float(sum(walls))


def _probe_wall_ms(folder, ds) -> float:
    fn, args = folder.cost_probe(ds)
    return _measured_ms(folder.program_tag, fn, args, folder.device)


def _estimate(unit: ScanUnit, schema, enc, peek, device) -> None:
    """Fill the unit's predicted routing and cost, and make the pack
    choice at plan time: time one dispatch of the packed gram and of the
    einsum family over the peeked sample and pick the faster, each cost
    riding the plan as its record.  Without a sample the runtime width
    heuristic decides (``pack_on=None``, source "model").

    A unit under a ``shard.*`` topology is the ``shard`` program, with
    no pack question (the packed gram is one unsharded program).  Under
    the conf's data mesh (``Job.auto_mesh`` on ``device``) it is the
    ``sharded`` program: the per-device work is the einsum family, whose
    cost is recorded, and the pack question goes to nobody."""
    from avenir_tpu_torch.jobs.base import auto_mesh
    from avenir_tpu_torch.parallel.shard import ShardSpec
    from avenir_tpu_torch.pipeline import scan

    conf = unit.confs[0]
    if ShardSpec.requested(conf):
        unit.program = "shard"
        return
    mesh = auto_mesh(conf, device)
    if peek is None:
        unit.program = "sharded" if mesh is not None else unit.program
        unit.pack_source = "model"
        return
    sample, est_rows = peek
    chunk_rows = conf.get_int("stream.chunk.rows", 0) or est_rows
    view = (sample if unit.keep is None
            else scan.pruned_view(sample, np.asarray(unit.keep, np.int64)))
    consumers = [scan.stage_consumer(s.name, s.job, c, "", schema, enc,
                                     keep=unit.keep)[0]
                 for s, c in zip(unit.stages, unit.confs)]
    pmw = conf.get_int("scan.pack.max.width", 0) or None
    base = scan.ChunkFolder(consumers, view, device, pack_on=False,
                            pack_max_width=pmw)
    unit.cost_rows = view.num_rows
    if mesh is not None:
        unit.program = "sharded"
        unit.cost = _einsum_cost(base, view)
        unit.pack_source = "aot" if unit.cost is not None else "model"
        return
    if base.step != "einsum":
        # the kernel route (B1–B3 on cuda) or moments only: one program
        # with no pack question
        unit.cost = _probe_cost(base, view, "plan.candidate")
        unit.program = base.program_tag or "moments"
        unit.pack_source = "aot" if unit.cost is not None else "model"
        return
    packed = None
    if conf.get_bool("scan.pack.on", True):
        packed = scan.ChunkFolder(consumers, view, device, pack_on=True,
                                  pack_max_width=pmw)
        if packed.step != "packed":
            packed = None           # the pack planner found no viable pack
    cost_e = _einsum_cost(base, view)
    if packed is None:
        # no pack candidate (opt-out, or no viable pack plan): the einsum
        # family is the program
        unit.pack_source = "aot"
        unit.cost = cost_e
        unit.program = base.program_tag
        return
    cost_p = _probe_cost(packed, view, "plan.candidate")
    # measured dispatches at two sample sizes fit wall(N) = a + b·N per
    # candidate, evaluated at the run's chunk size: the packed gram has a
    # large fixed cost per dispatch, the einsum family many small ones,
    # so the ranking can flip with N
    n = view.num_rows
    n_small = max(min(n // 8, n - 1), 1)
    small = view.slice(0, n_small) if n_small < n else None

    def predicted(wall_fn, folder):
        w1 = wall_fn(folder, view)
        if small is None or chunk_rows <= n:
            return w1
        w0 = wall_fn(folder, small)
        b = (w1 - w0) / (n - n_small)
        a = max(w1 - b * n, 0.0)
        return a + max(b, 0.0) * chunk_rows

    wall_e = predicted(_einsum_wall_ms, base)
    wall_p = predicted(_probe_wall_ms, packed)
    choose_packed = wall_p <= wall_e
    unit.pack_source = "measured"
    unit.pack_on = choose_packed
    unit.cost = cost_p if choose_packed else cost_e
    unit.wall_ms = wall_p if choose_packed else wall_e
    unit.program = packed.program_tag if choose_packed else base.program_tag
    if choose_packed:
        unit.rewrites.append("pack")


def plan_pipeline(pipeline: Pipeline,
                  todo: Optional[Sequence[Stage]] = None,
                  resume: bool = False) -> PipelinePlan:
    """Lower a pipeline's declared stages into an ordered unit list.

    Greedy over the declared order: each unclaimed fusable stage anchors
    a scan unit and pulls in every later fusable stage over the same
    input that :func:`_join_shares` allows; a non-fusable stage becomes a
    staged unit with its reason; under ``resume`` a satisfied stage
    becomes a skip unit.  Per scan unit the planner then computes the
    dead columns, the encode-once key and the pack choice over a peeked
    sample (``plan.peek.rows``, default 2048) on the pipeline's device."""
    from avenir_tpu_torch.device import resolve_device
    from avenir_tpu_torch.jobs.base import Job
    from avenir_tpu_torch.parallel.shard import ShardSpec
    from avenir_tpu_torch.pipeline import scan

    stages = list(todo) if todo is not None else list(pipeline.stages)
    device = resolve_device(pipeline.device)
    confs = {s.name: pipeline._stage_conf(s) for s in stages}
    producers = {s.output: s for s in stages}
    pos = {s.name: k for k, s in enumerate(stages)}
    units: List[object] = []
    taken: set = set()
    encode_seen: set = set()
    samples: Dict[str, object] = {}
    for i, s in enumerate(stages):
        if s.name in taken:
            continue
        conf = confs[s.name]
        if resume and os.path.exists(pipeline.path(s.output)):
            units.append(SkipUnit(stage=s))
            taken.add(s.name)
            continue
        reason = scan.fuse_refusal(s.job, conf)
        if reason is not None:
            units.append(StageUnit(stage=s, conf=conf, reason=reason))
            taken.add(s.name)
            continue
        in_path = pipeline.path(s.input)
        members, mconfs = [s], [conf]
        member_names, member_outs = {s.name}, {s.output}
        shares: List[str] = []
        for j in range(i + 1, len(stages)):
            c = stages[j]
            if c.name in taken or c.name in member_names:
                continue
            if resume and os.path.exists(pipeline.path(c.output)):
                continue           # becomes a SkipUnit at its own slot
            if pipeline.path(c.input) != in_path:
                continue
            cconf = confs[c.name]
            if scan.fuse_refusal(c.job, cconf) is not None:
                continue
            if not scan.stages_compatible([mconfs[0], cconf]):
                continue
            share = _join_shares(pipeline, c, producers, taken,
                                 member_names, member_outs, stages, i, j,
                                 in_path)
            if share is None:
                continue
            members.append(c)
            mconfs.append(cconf)
            member_names.add(c.name)
            member_outs.add(c.output)
            shares.extend(share)
        if not scan.stages_compatible(mconfs[:1]):
            # schema unloadable or no class attribute: a SharedScan cannot
            # serve even a singleton
            units.append(StageUnit(stage=s, conf=conf,
                                   reason="scan-incompatible conf "
                                          "(schema/class attribute)"))
            taken.add(s.name)
            continue
        unit = ScanUnit(stages=members, confs=mconfs, input=s.input,
                        in_path=in_path)
        if len(members) > 1:
            unit.rewrites.append("fuse")
        if shares:
            unit.rewrites.append("share-gram")
        # dead columns: the union of binned columns any member's output
        # depends on; None (NB, MI: every column) blocks the rewrite
        schema = Job.load_schema(mconfs[0])
        enc = Job.encoder_for(mconfs[0])
        f = len(enc.binned_fields)
        needed: Optional[set] = set()
        for m, mc in zip(members, mconfs):
            cons, _w = scan.stage_consumer(m.name, m.job, mc, "", schema,
                                           enc)
            cols = scan.consumer_columns(cons, f)
            if cols is None:
                needed = None
                break
            needed |= cols
        if needed is not None and needed and len(needed) < f:
            unit.keep = sorted(needed)
            unit.pruned_from = f
            unit.rewrites.append("prune")
        # a singleton with no prune win and no shard topology runs its
        # standalone job byte for byte: keep the staged path (the staged
        # loop's singleton rule)
        if len(members) == 1 and unit.keep is None \
                and not ShardSpec.requested(conf):
            units.append(StageUnit(stage=s, conf=conf,
                                   reason="singleton scan -- staged path "
                                          "is identical"))
            taken.add(s.name)
            continue
        mconf = mconfs[0]
        if not mconf.get("stream.chunk.rows") \
                and not ShardSpec.requested(mconf):
            ekey = ((in_path,)
                    + tuple(mconf.get(k) for k in scan._ENCODE_KEYS))
            if ekey in encode_seen:
                unit.rewrites.append("encode-once")
            encode_seen.add(ekey)
        ps = sorted(pos[m.name] for m in members)
        unit.staged_scans = 1 + sum(1 for a, b in zip(ps, ps[1:])
                                    if b != a + 1)
        if in_path not in samples:
            samples[in_path] = _peek_sample(
                mconf, in_path, mconf.get_int("plan.peek.rows", 2048))
        _estimate(unit, schema, enc, samples[in_path], device)
        units.append(unit)
        taken.update(member_names)
    return PipelinePlan(pipeline, units, resume)


# ---------------------------------------------------------------------------
# execution and journal
# ---------------------------------------------------------------------------

def journal_plan(summary: dict, tracer=None) -> None:
    """One ``plan.compiled`` event per planned run: the journal's record
    of what the planner decided before anything ran."""
    from avenir_tpu_torch.telemetry import spans as tel

    (tracer or tel.tracer()).event("plan.compiled", **summary)


def run_plan(pipeline: Pipeline, plan: PipelinePlan, tracer) -> None:
    """Run a plan in unit order: skip units journal ``stage.skipped``
    (their counters marked in place), staged units run the per-stage
    path, and scan units run through ``scan.run_fused_stages`` with the
    plan's prune and pack decisions, sharing one encode cache across
    units (encode-once) and carrying the plan node's attrs on each
    ``scan.fused`` span."""
    cache: dict = {}
    for k, unit in enumerate(plan.units):
        if isinstance(unit, SkipUnit):
            pipeline._mark_skipped(unit.stage, tracer)
        elif isinstance(unit, StageUnit):
            pipeline._run_single(unit.stage, unit.conf, tracer)
        else:
            extra = {"planned": True, "unit": k,
                     "rewrites": list(unit.rewrites)}
            if unit.program:
                extra["plan.program"] = unit.program
            pipeline._run_fused(
                unit.stages, unit.confs, tracer, extra_attrs=extra,
                prune=unit.keep, pack_on=unit.pack_on,
                pack_max_width=unit.pack_max_width, encode_cache=cache)
