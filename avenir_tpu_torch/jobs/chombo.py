"""The chombo MR jobs the reference's runbooks call between avenir jobs
(SURVEY.md §2.11); port of ``avenir_tpu/jobs/chombo.py``.

The price-optimization bandit loop calls ``org.chombo.mr.RunningAggregator``
to fold each round's reward measurements into the running
(group, item, count, sum, avg) state (resource/price_optimize_tutorial.txt:
44-78, config keys ``incremental.file.prefix`` / ``quantity.attr`` at :88-90),
and the email-marketing Markov runbook calls ``org.chombo.mr.Projection`` to
turn transaction rows into per-customer field sequences
(resource/tutorial_opt_email_marketing.txt:19-42).  Both are host string
work.  ``NumericalAttrStats`` takes its class moments on the job's device.

``NumericalAttrStats`` splits its rows over the job's data mesh
(``Job.auto_mesh``) as the JAX package does, the moments taken per shard
and summed in shard order; in a fleet its streamed path owns chunks round
robin (``Job.distributed_plan``) and merges the per-chunk snapshots in one
collective, as the JAX package does.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Tuple

import numpy as np

from avenir_tpu_torch.core.config import ConfigError, JobConfig
from avenir_tpu_torch.core.csv_io import read_csv
from avenir_tpu_torch.jobs.base import Job, input_files, read_input, write_output
from avenir_tpu_torch.ops import agg
from avenir_tpu_torch.parallel.collectives import shard_sum
from avenir_tpu_torch.parallel.mesh import place_batch
from avenir_tpu_torch.utils.metrics import Counters


def _fmt(x: float, precision: int = 6) -> str:
    """Compact numeric formatting: ints stay ints, floats keep ``precision``
    sig figs; non-finite values print as-is (nan/inf/-inf)."""
    if math.isfinite(x) and x == int(x):
        return str(int(x))
    return f"{x:.{precision}g}"


def _fmt_full(x: float) -> str:
    """Full-precision formatting for accumulated moments: 6 sig figs would
    throw away exactly the digits the f64 accumulation preserves (e.g. a
    mean of 1e7 + 0.0118)."""
    return _fmt(x, precision=15)


class RunningAggregator(Job):
    """org.chombo.mr.RunningAggregator — merge incremental measurement files
    into running per-(group, item) aggregates.

    Input dir layout (the tutorial's contract): the current aggregate rows
    ``group,item,count,sum,avg`` plus incremental files whose basename starts
    with ``incremental.file.prefix`` (default ``inc``) carrying one new
    measurement per row at column ``quantity.attr``. Output rows are the
    updated ``group,item,count,sum,avg`` — which feed the next bandit round
    with ``count.ordinal=2`` / ``reward.ordinal=4``
    (resource/price_optimize_tutorial.txt:70-90).
    """

    name = "RunningAggregator"

    def execute(self, conf: JobConfig, input_path: str, output_path: str,
                counters: Counters) -> None:
        delim = conf.field_delim_regex
        prefix = conf.get("incremental.file.prefix", "inc")
        qattr = conf.get_int("quantity.attr", 2)

        agg_rows: Dict[Tuple[str, str], List[float]] = {}   # insertion-ordered
        n_inc = 0
        for f in input_files(input_path):
            incremental = os.path.basename(f).startswith(prefix)
            for r in read_csv(f, delim=delim):
                cell = agg_rows.setdefault((str(r[0]), str(r[1])), [0.0, 0.0])
                if incremental:
                    cell[0] += 1.0
                    cell[1] += float(r[qattr])
                    n_inc += 1
                else:
                    cell[0] += float(r[2])
                    cell[1] += float(r[3])

        d = conf.field_delim
        lines = []
        for (g, item), (cnt, tot) in agg_rows.items():
            avg = tot / cnt if cnt > 0 else 0.0
            lines.append(d.join([g, item, _fmt(cnt), _fmt(tot), _fmt(avg)]))
        write_output(output_path, lines)
        counters.set("Aggregate", "Keys", len(agg_rows))
        counters.set("Aggregate", "IncrementalRows", n_inc)


class Projection(Job):
    """org.chombo.mr.Projection (group-by mode) — group rows by a key field,
    order within the group, and emit the projected fields flattened:
    ``key,fA(r1),fB(r1),fA(r2),fB(r2),...``.

    Config: ``projection.key.field`` (default 0),
    ``projection.field.ordinals`` (comma list; default all non-key columns),
    ``projection.sort.field`` (optional ordinal; lexicographic, so ISO dates
    order correctly).
    """

    name = "Projection"

    def execute(self, conf: JobConfig, input_path: str, output_path: str,
                counters: Counters) -> None:
        delim = conf.field_delim_regex
        key_ord = conf.get_int("projection.key.field", 0)
        field_ords = conf.get_int_list("projection.field.ordinals", None)
        sort_ord = conf.get_int("projection.sort.field")

        groups: Dict[str, List[Tuple[str, List[str]]]] = {}   # insertion-ordered
        n_rows = 0
        for f in input_files(input_path):
            rows = read_csv(f, delim=delim)
            if not rows.size:
                continue
            ords = field_ords if field_ords is not None else [
                i for i in range(rows.shape[1]) if i != key_ord]
            for r in rows:
                row = [str(v) for v in r]
                sort_key = row[sort_ord] if sort_ord is not None else ""
                groups.setdefault(row[key_ord], []).append(
                    (sort_key, [row[i] for i in ords]))
                n_rows += 1

        d = conf.field_delim
        lines = []
        for key, grp in groups.items():
            if sort_ord is not None:
                grp = sorted(grp, key=lambda kv: kv[0])
            flat: List[str] = [key]
            for _, vals in grp:
                flat.extend(vals)
            lines.append(d.join(flat))
        write_output(output_path, lines)
        counters.set("Projection", "Groups", len(groups))
        counters.set("Projection", "Rows", n_rows)


def _groups(rows: np.ndarray, cond_ord) -> Tuple[List[str], np.ndarray]:
    """(sorted conditioning values, int32 label per row); one group ``""``
    when the stats are not conditioned."""
    if cond_ord is None:
        return [""], np.zeros(len(rows), np.int32)
    cond_vals = [str(v) for v in rows[:, cond_ord]]
    uniq = sorted(set(cond_vals))
    cmap = {v: i for i, v in enumerate(uniq)}
    return uniq, np.asarray([cmap[v] for v in cond_vals], np.int32)


def _finite_mean_shift(vals64: np.ndarray, labels: np.ndarray,
                       num_groups: int) -> np.ndarray:
    """[groups, A] float64 mean of each group's finite values (0 where a
    column has none).  Shifting by it before the float32 cast keeps the
    E[x²]−E[x]² form from cancelling when |mean| >> std, per group (the
    reference chombo job accumulates in double); an inf stays inf."""
    shift = np.zeros((num_groups, vals64.shape[1]))
    for ci in range(num_groups):
        sel = vals64[labels == ci]
        fin = np.isfinite(sel)
        n_fin = fin.sum(axis=0)
        shift[ci] = np.where(
            n_fin > 0,
            np.where(fin, sel, 0.0).sum(axis=0) / np.maximum(n_fin, 1),
            0.0)
    return shift


def _stats_fields(n, s1, s2, m, lo, hi) -> List[str]:
    """count, sum, sumSq, mean, var, std, min, max from shifted-space sums
    (stable mean/var) and the shift ``m`` (raw sum/sumSq rebuilt in f64)."""
    mean_s = s1 / n
    var = max(s2 / n - mean_s * mean_s, 0.0)
    raw_sum = s1 + n * m
    raw_sumsq = s2 + 2.0 * m * s1 + n * m * m
    return [_fmt(float(n)), _fmt_full(float(raw_sum)),
            _fmt_full(float(raw_sumsq)), _fmt_full(float(mean_s + m)),
            _fmt_full(float(var)), _fmt_full(float(np.sqrt(var))),
            _fmt_full(float(lo)), _fmt_full(float(hi))]


class NumericalAttrStats(Job):
    """org.chombo.mr.NumericalAttrStats — per-(attr [, conditioning value])
    count / sum / sumSq / mean / variance / stdDev / min / max over numeric
    columns.

    Numeric attrs come from ``attr.list`` or default to every numeric
    schema feature; an optional ``cond.attr.ord`` partitions the stats.
    The moments are ``agg.class_moments`` on the job's device, summed in
    float64 where the JAX package sums in float32: the fields equal the
    JAX package's where its float32 sums are exact, and are the more exact
    elsewhere (ROADMAP.md "Port contracts: Float moments").
    """

    name = "NumericalAttrStats"

    def _moments(self, vals: np.ndarray, labels: np.ndarray, num_groups: int,
                 mesh):
        vals_b, labels_b = place_batch(mesh, self.device, vals, labels)
        cnt, s1, s2 = shard_sum(agg.class_moments, vals_b, labels_b,
                                num_groups)
        return tuple(t.cpu().numpy().astype(np.float64) for t in (cnt, s1, s2))

    def execute(self, conf: JobConfig, input_path: str, output_path: str,
                counters: Counters) -> None:
        if conf.get("stream.chunk.rows"):
            self._execute_streaming(conf, input_path, output_path, counters)
            return
        delim = conf.field_delim_regex
        rows = read_input(input_path, delim=delim)
        attr_ords = conf.get_int_list("attr.list", None)
        if attr_ords is None:
            try:
                schema = self.load_schema(conf)
                attr_ords = [f.ordinal for f in schema.feature_fields
                             if f.is_numeric]
            except ValueError:
                attr_ords = list(range(rows.shape[1] if rows.size else 0))
        cond_ord = conf.get_int("cond.attr.ord")

        if not rows.size or not attr_ords:
            write_output(output_path, [])
            return
        vals64 = rows[:, attr_ords].astype(np.float64)
        uniq, labels = _groups(rows, cond_ord)
        shift = _finite_mean_shift(vals64, labels, len(uniq))
        vals = (vals64 - shift[labels]).astype(np.float32)
        cnt, s1, s2 = self._moments(vals, labels, len(uniq),
                                    self.auto_mesh(conf))

        d = conf.field_delim
        lines: List[str] = []
        for ai, aord in enumerate(attr_ords):
            col = vals64[:, ai]
            for ci, cval in enumerate(uniq):
                n = cnt[ci]
                if not n:
                    continue
                sub = col[labels == ci]
                fields = [str(aord)] + ([cval] if cond_ord is not None else [])
                fields += _stats_fields(n, s1[ci, ai], s2[ci, ai],
                                        float(shift[ci, ai]), sub.min(),
                                        sub.max())
                lines.append(d.join(fields))
        write_output(output_path, lines)
        counters.set("Records", "Processed", len(rows))

    # -- streaming path --------------------------------------------------------
    def _execute_streaming(self, conf: JobConfig, input_path: str,
                           output_path: str, counters: Counters) -> None:
        """``stream.chunk.rows`` path: the chunked raw-line stream with
        per-chunk retry, one moment snapshot per (chunk, group), finalized
        in chunk order.

        Each chunk's snapshot is shifted by the chunk's own per-group finite
        mean, and finalization translates every snapshot to the group's
        lowest-chunk anchor shift and folds in ascending chunk index, as
        the JAX package does, so the float64 addition sequence is its.

        State grows as O(chunks × groups) × 6·A·8 bytes;
        ``stream.stats.max.state.mb`` (default 1024) bounds it loudly.
        Chunk keys are zero-padded to 12 digits so the ascending-key
        finalize fold stays ordered; the index is checked below that
        width."""
        if conf.get("stream.checkpoint.dir"):
            raise ConfigError(
                "stream.checkpoint.dir is not supported on the "
                "NumericalAttrStats streaming path (per-chunk snapshots are "
                "merge keys, not a resumable cursor) — configuring it must "
                "fail loudly rather than silently run without durability")
        delim = conf.field_delim_regex
        attr_ords = conf.get_int_list("attr.list", None)
        if attr_ords is None:
            try:
                schema = self.load_schema(conf)
                attr_ords = [f.ordinal for f in schema.feature_fields
                             if f.is_numeric]
            except ValueError:
                raise ConfigError(
                    "streaming NumericalAttrStats needs attr.list or "
                    "feature.schema.file.path (column count is unknown "
                    "before the first chunk)")
        cond_ord = conf.get_int("cond.attr.ord")
        owner, _acc, distributed = self.distributed_plan(conf, None)
        mesh = self.auto_mesh(conf)
        a = len(attr_ords)
        max_state_bytes = conf.get_int("stream.stats.max.state.mb", 1024) << 20
        state_bytes = 0
        overflow = None            # the cap tripped: raise after the merge
        state: dict = {}
        nrows = 0
        for idx, lines in self.iter_line_chunks_retrying(
                conf, input_path, counters, owner=owner, emit_index=True):
            if idx >= 10 ** 12:
                raise ConfigError(
                    f"chunk index {idx} exceeds the 12-digit snapshot-key "
                    f"width; raise stream.chunk.rows (keys past the width "
                    f"would silently mis-order the finalize fold)")
            rows = np.array([ln.split(delim) for ln in lines], dtype=object)
            nrows += len(rows)
            vals64 = rows[:, attr_ords].astype(np.float64)
            uniq, labels = _groups(rows, cond_ord)
            shift = _finite_mean_shift(vals64, labels, len(uniq))
            vals = (vals64 - shift[labels]).astype(np.float32)
            cnt, s1, s2 = self._moments(vals, labels, len(uniq), mesh)
            for ci, g in enumerate(uniq):
                if not cnt[ci]:
                    continue
                sel = vals64[labels == ci]
                snap = np.stack([
                    np.full(a, cnt[ci]), s1[ci], s2[ci], shift[ci],
                    sel.min(axis=0), sel.max(axis=0)])
                state[f"c{idx:012d}:{g}"] = snap
                state_bytes += snap.nbytes
                if state_bytes > max_state_bytes:
                    overflow = (
                        f"NumericalAttrStats snapshot state exceeds "
                        f"stream.stats.max.state.mb="
                        f"{max_state_bytes >> 20} after {len(state)} "
                        f"(chunk, group) snapshots — state grows as "
                        f"O(chunks × groups); raise stream.chunk.rows, "
                        f"reduce cond.attr.ord cardinality, or lift the cap")
                    break
            if overflow:
                break
        merged_rows = nrows
        if distributed:
            # every process enters the one end-of-stream collective, the
            # overflow flag riding the same gather, and all raise together
            from avenir_tpu_torch.parallel.mesh import all_process_sum_state

            state["__rows__"] = np.array([nrows], np.int64)
            state["__overflow__"] = np.array([1 if overflow else 0], np.int64)
            state = all_process_sum_state(state)
            merged_rows = int(state.pop("__rows__")[0])
            if int(state.pop("__overflow__")[0]):
                raise ConfigError(overflow or (
                    "a peer process exceeded stream.stats.max.state.mb "
                    "(O(chunks × groups) snapshot growth); raise "
                    "stream.chunk.rows, reduce cond.attr.ord cardinality, "
                    "or lift the cap"))
        if overflow:
            raise ConfigError(overflow)

        # finalize: group → snapshots in ascending chunk order (keys are
        # zero-padded to a fixed 12-digit width, so lexicographic == numeric)
        by_group: dict = {}
        for k in sorted(state):
            by_group.setdefault(k.split(":", 1)[1], []).append(state[k])
        totals = {}
        for g, snaps in by_group.items():
            anchor = snaps[0][3]                             # [A] m*
            n_tot = np.zeros(a)
            s1_tot = np.zeros(a)
            s2_tot = np.zeros(a)
            mn = np.full(a, np.inf)
            mx = np.full(a, -np.inf)
            for snap in snaps:
                n_c, s1_c, s2_c, m_c, mn_c, mx_c = snap
                dm = m_c - anchor
                n_tot = n_tot + n_c
                s1_tot = s1_tot + (s1_c + n_c * dm)
                s2_tot = s2_tot + (s2_c + 2.0 * dm * s1_c + n_c * dm * dm)
                mn = np.minimum(mn, mn_c)
                mx = np.maximum(mx, mx_c)
            totals[g] = (anchor, n_tot, s1_tot, s2_tot, mn, mx)
        d = conf.field_delim
        out: List[str] = []
        for ai, aord in enumerate(attr_ords):
            for g in sorted(totals):
                anchor, n_tot, s1_tot, s2_tot, mn, mx = totals[g]
                n = n_tot[ai]
                if not n:
                    continue
                fields = [str(aord)] + ([g] if cond_ord is not None else [])
                fields += _stats_fields(n, s1_tot[ai], s2_tot[ai],
                                        float(anchor[ai]), mn[ai], mx[ai])
                out.append(d.join(fields))
        if self.is_output_writer():
            write_output(output_path, out)
        counters.set("Records", "Processed", merged_rows)
