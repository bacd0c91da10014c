"""StreamGraft windows — constant-memory sliding-window analytics over the
SharedScan fold; port of ``avenir_tpu/stream/windows.py`` in one process.

A :class:`WindowedScan` pulls micro-batches of raw CSV rows from a queue
transport (``pipeline/streaming.py``'s ``InProcQueue``), encodes each
*pane* through the Python encoder (``read_csv_string`` +
``DatasetEncoder.transform``, as the JAX package does) and folds it through
:class:`~avenir_tpu_torch.pipeline.scan.ChunkFolder` — the same per-chunk
pass every batch SharedScan runs, so on ``cuda`` each pane is one B1 launch
(``ops/hist.py``) — into a ring of per-pane accumulator states.

Windows are pane-composed:

- a **pane** is ``pane_rows`` consecutive rows, folded once on arrival into
  its own count state (int64/float64 host totals);
- a **tumbling** window is ``window_panes`` panes with
  ``slide_panes == window_panes``;
- a **sliding** window overlaps: every ``slide_panes`` panes, the last
  ``window_panes`` pane states are merged by host adds of totals already
  folded, so each row is encoded and dispatched once however many windows
  hold it.

A window finalizes through the consumers' data-free constructors, so its
result equals a batch SharedScan over the same rows: exactly for every
count table; for continuous moments when the partial sums are exact (the
float64 pane totals merge in float64).

Shape discipline: panes are padded to power-of-two row buckets
(``stream.pane.pad.pow2``) with rows whose label is −1, which the
drop-invalid contract removes from every table on every route.
``warm()`` folds a blank pane at every bucket (on ``cuda``, one B1 launch
each, all labels −1, so nothing counts) and primes a
:class:`~avenir_tpu_torch.telemetry.spans.CompileKeyMonitor`, so a stream
of full panes and a ragged tail shows zero ``Stream::recompiles``.

Under a ``shard.*`` plan (``shard=``) each pane folds over the mesh
through the same ``ChunkFolder`` (padded on to its shard target, one B1
launch per shard on ``cuda``), so windows inherit sharding with no
stream-side code, and a pane snapshot records the mesh qualifier it was
folded under.  A snapshot written under this run's topology resumes; one
keyed for another routing or topology is redistributed onto this run's
(``ChunkFolder.adopt_state``, journaled ``checkpoint.reshard``) under
``shard.reshard.on.restore``, and refused without it, never folded.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from avenir_tpu_torch.core.config import ConfigError, JobConfig
from avenir_tpu_torch.core.csv_io import read_csv_string
from avenir_tpu_torch.core.encoding import (DatasetEncoder, EncodedDataset,
                                            pad_ballast)
from avenir_tpu_torch.ops import agg
from avenir_tpu_torch.pipeline import scan
from avenir_tpu_torch.telemetry import spans as tel
from avenir_tpu_torch.utils.metrics import Counters


class ClassDistributionConsumer(scan.ScanConsumer):
    """The lightest windowed read-out: (class value → count, fraction) of
    the window — the summary the drift detector reasons over, exposed as a
    consumer so jobs can publish it per window without carrying a model."""

    needs_bin = False

    def finalize(self, t: scan.ScanTables):
        counts = np.asarray(t.class_counts, np.int64)
        total = int(counts.sum())
        return {
            "classes": list(t.meta.class_values),
            "counts": counts,
            "fractions": (counts / total if total else
                          np.zeros_like(counts, np.float64)),
            "rows": t.rows,
        }


class WindowResult:
    """One emitted window: identity, the shared tables, and every
    consumer's finalized result (``results[name]``).  ``lines`` carries the
    window's raw rows when the scan retains them (the retrain corpus);
    None otherwise — including, with ``retained`` still True, for windows
    containing panes restored from a checkpoint, whose raw rows were
    deliberately not persisted (consumers use the flag to tell "retention
    off" from "rows lost to a resume")."""

    __slots__ = ("index", "first_pane", "last_pane", "rows", "tables",
                 "results", "lines", "retained")

    def __init__(self, index: int, first_pane: int, last_pane: int,
                 rows: int, tables: scan.ScanTables,
                 results: Dict[str, Any], lines: Optional[List[str]],
                 retained: bool = False):
        self.index = index
        self.first_pane = first_pane
        self.last_pane = last_pane
        self.rows = rows
        self.tables = tables
        self.results = results
        self.lines = lines
        self.retained = retained


def _meta_ds(enc: DatasetEncoder) -> EncodedDataset:
    """Zero-row shape metadata in ``enc``'s code space — what ChunkFolder
    needs to pick its routing before any pane arrives (labels present, the
    scan contract)."""
    nb = len(enc.binned_fields)
    return EncodedDataset(
        codes=np.zeros((0, nb), np.int32),
        cont=np.zeros((0, len(enc.cont_fields)), np.float32),
        labels=np.zeros(0, np.int32), ids=None,
        n_bins=np.array([enc.n_bins[f.ordinal] for f in enc.binned_fields],
                        np.int32),
        class_values=list(enc.class_values),
        binned_ordinals=[f.ordinal for f in enc.binned_fields],
        cont_ordinals=[f.ordinal for f in enc.cont_fields])


def _pow2_buckets(pane_rows: int) -> List[int]:
    out = [1]
    while out[-1] < pane_rows:
        out.append(out[-1] * 2)
    return out


class WindowedScan:
    """Sliding/tumbling-window SharedScan consumer over a row stream on
    ``device`` (``cuda`` unless the caller asks for the CPU), over the mesh
    of a ``shard`` plan when given, else over a data ``mesh`` when given
    (the job's ``auto_mesh``; :class:`~avenir_tpu_torch.pipeline.scan.
    ChunkFolder` routes both).

    ``feed(lines)`` (or ``pump(queue)``) ingests raw CSV rows; every
    ``pane_rows`` rows close a pane (encode → pad → fold); every window
    boundary merges the ring's pane states and finalizes the registered
    consumers.  Returns the :class:`WindowResult` list each call emitted.

    ``close_pane()`` force-closes the current pane regardless of fill —
    the seam for time-driven panes (a wall-clock ticker calls it on the
    period), which is also how EMPTY panes and empty windows arise.
    ``flush()`` closes a non-empty ragged tail pane at end of stream.
    """

    def __init__(self, encoder: DatasetEncoder,
                 consumers: Sequence[scan.ScanConsumer],
                 pane_rows: int, window_panes: int = 1,
                 slide_panes: Optional[int] = None, delim: str = ",",
                 device=None, pad_pow2: bool = True,
                 retain_rows: bool = False,
                 counters: Optional[Counters] = None,
                 checkpointer: Optional["WindowCheckpointer"] = None,
                 crash_after_panes: int = 0, on_window=None,
                 fault=None, pack_on: bool = True,
                 pack_max_width: Optional[int] = None, shard=None,
                 mesh=None):
        from avenir_tpu_torch.device import resolve_device

        if not encoder.schema_complete(with_labels=True) or \
                not encoder.class_values:
            raise ConfigError(
                "windowed streaming requires a schema-complete encoder "
                "(closed vocabularies, numeric ranges, class cardinality) — "
                "a single-pass stream cannot fit a vocabulary")
        if pane_rows < 1:
            raise ConfigError(f"stream.pane.rows must be >= 1, got {pane_rows}")
        if window_panes < 1:
            raise ConfigError(
                f"stream.window.panes must be >= 1, got {window_panes}")
        slide = window_panes if slide_panes is None else int(slide_panes)
        if not 1 <= slide <= window_panes:
            raise ConfigError(
                f"stream.slide.panes must be in [1, window.panes="
                f"{window_panes}], got {slide}")
        self.enc = encoder
        self.pane_rows = int(pane_rows)
        self.window_panes = int(window_panes)
        self.slide_panes = slide
        self.delim = delim
        self.pad_pow2 = bool(pad_pow2)
        self.retain_rows = bool(retain_rows)
        self.counters = counters if counters is not None else Counters()
        self.checkpointer = checkpointer
        self.crash_after = int(crash_after_panes)
        # conf-driven fault plan (utils/retry.FaultPlan): the "fold" site
        # fires at non-empty pane fold boundaries — the mid-fold kill
        self.fault = fault
        # invoked per window AT EMISSION — i.e. BEFORE the pane's
        # checkpoint snapshot is written, so state the callback mutates
        # (a drift detector attached to the checkpointer) rides the SAME
        # snapshot and a resume replays neither side twice
        self.on_window = on_window
        self.meta = _meta_ds(encoder)
        self.folder = scan.ChunkFolder(consumers, self.meta,
                                       resolve_device(device),
                                       pack_on=pack_on,
                                       pack_max_width=pack_max_width,
                                       shard=shard, counters=self.counters,
                                       mesh=mesh)
        self.buckets = _pow2_buckets(self.pane_rows)
        self._monitor = tel.CompileKeyMonitor(self.counters, group="Stream",
                                              scope="stream.pane")
        # the ring: the last window_panes pane records — the ONLY per-row
        # state the scan retains, so memory is O(window), never O(stream)
        self._ring: deque = deque(maxlen=self.window_panes)
        self._pane_buf: List[str] = []
        self.panes_closed = 0
        self.windows_emitted = 0
        self.rows_consumed = 0            # rows in CLOSED panes (resume seam)

    # -- warmup ---------------------------------------------------------------
    def warm(self) -> int:
        """Fold a blank pane (labels −1, so nothing counts) at every pane
        bucket and prime the recompile monitor; after this, steady-state
        panes — ragged tails included — register no fresh shape.  Returns
        the number of shapes warmed."""
        from avenir_tpu_torch.telemetry import profile as _profile

        prof = _profile.profiler()
        throwaway = agg.Accumulator()
        for bucket in self.buckets:
            ds = self._blank_pane(bucket)
            key = self._pane_key(ds)
            if prof.enabled:
                # the cost first: the profiler keeps the FIRST (site, key)
                # observation, and the prime registers shapes only
                prof.observe(key, site=self._monitor.scope,
                             cost=self.folder.cost(ds))
            self._monitor.prime([key])
            self.folder.fold(ds, throwaway)
        return len(self.buckets)

    def _pane_key(self, ds: EncodedDataset):
        """The pane's program key: dispatch shapes + the folder's routing
        tag (a packed pane carries its pack signature)."""
        return tel.CompileKeyMonitor.shape_key(
            ds.codes, ds.labels, ds.cont) + (
            self.folder.program_tag or "moments",)

    def _blank_pane(self, n: int) -> EncodedDataset:
        m = self.meta
        return EncodedDataset(
            codes=np.zeros((n, m.num_binned), np.int32),
            cont=np.zeros((n, m.num_cont), np.float32),
            labels=np.full(n, -1, np.int32), ids=None,
            n_bins=m.n_bins, class_values=m.class_values,
            binned_ordinals=m.binned_ordinals, cont_ordinals=m.cont_ordinals)

    # -- ingest ---------------------------------------------------------------
    def feed(self, lines: Sequence[str]) -> List[WindowResult]:
        """Ingest raw CSV rows; returns the windows this call completed."""
        out: List[WindowResult] = []
        for line in lines:
            self._pane_buf.append(line)
            if len(self._pane_buf) >= self.pane_rows:
                out.extend(self.close_pane())
        return out

    def pump(self, queue, max_rows: Optional[int] = None
             ) -> List[WindowResult]:
        """Drain a queue transport (the ``InProcQueue`` pop surface) into
        the scan; stops at queue-empty or ``max_rows``.  Rows are drained
        first and fed as ONE batch."""
        drained: List[str] = []
        while max_rows is None or len(drained) < max_rows:
            msg = queue.pop()
            if msg is None:
                break
            drained.append(msg)
        return self.feed(drained) if drained else []

    def flush(self) -> List[WindowResult]:
        """Close a non-empty ragged tail pane (end of stream)."""
        if not self._pane_buf:
            return []
        return self.close_pane()

    def close_pane(self) -> List[WindowResult]:
        """Close the current pane (even empty — the time-driven tick),
        fold it, and emit any window ending here, inside a
        ``blackbox.watchdog_guard`` (a pane close that wedges past
        ``blackbox.watchdog.sec`` journals ``hang.detected``)."""
        from avenir_tpu_torch.telemetry import blackbox

        with blackbox.watchdog_guard("pane"):
            return self._close_pane()

    def _close_pane(self) -> List[WindowResult]:
        from avenir_tpu_torch.telemetry import profile as _profile

        lines = self._pane_buf
        self._pane_buf = []
        acc = agg.Accumulator()
        prof = _profile.profiler()
        if lines:
            if self.fault is not None:
                # mid-fold kill: the popped pane's rows are past the
                # cursor (rows_consumed counts CLOSED panes only), so a
                # resume re-feeds them — nothing is lost or double-counted
                self.fault.hit("fold")
            ds = self._pad(self._encode(lines))
            key = self._pane_key(ds)
            if prof.enabled:
                prof.observe(key, site=self._monitor.scope,
                             cost=self.folder.cost(ds))
            self._monitor.observe([key])
            t0 = time.perf_counter()
            self.folder.fold(ds, acc)
            if prof.enabled:
                prof.sample(key, self._monitor.scope,
                            time.perf_counter() - t0)
        if prof.enabled:
            # pane boundary: where a device-memory leak across windows
            # (ring growth, hot-swap debris) shows up
            prof.sample_device_memory("pane", [self.folder.device])
        self._ring.append({"pane": self.panes_closed, "rows": len(lines),
                           "state": acc.state(),
                           "lines": list(lines) if self.retain_rows else None})
        self.panes_closed += 1
        self.rows_consumed += len(lines)
        self.counters.increment("Stream", "panes")
        self.counters.increment("Stream", "rows", len(lines))
        out = self._emit_windows()
        if self.checkpointer is not None:
            self.checkpointer.maybe_save(self)
        # stream.fault.crash.after.panes fires AFTER the pane reached the
        # ring and its snapshot was saved (kill after durability), while
        # the FaultPlan's fault.fold.crash.after fires BEFORE the fold
        # (mid-fold preemption) and journals fault.injected
        if self.crash_after and self.panes_closed >= self.crash_after:
            # fault-injection drill: the raise is the simulated pane-boundary
            # crash the checkpoint/restore path recovers from; a ConfigError
            # would break its retry classification
            # graftlint: disable=GL010
            raise RuntimeError(
                f"stream.fault.crash.after.panes={self.crash_after}: "
                f"injected crash after pane {self.panes_closed - 1}")
        return out

    def _encode(self, lines: List[str]) -> EncodedDataset:
        rows = read_csv_string("\n".join(lines), delim=self.delim)
        return self.enc.transform(rows, with_labels=True)

    def _pad(self, ds: EncodedDataset) -> EncodedDataset:
        """Pad the pane to its power-of-two row bucket with ballast rows
        (label −1, ``core.encoding.pad_ballast``): they drop out of every
        count table, so the pad is pure shape ballast."""
        if not self.pad_pow2:
            return ds
        return pad_ballast(ds,
                           next(b for b in self.buckets if b >= ds.num_rows))

    # -- window emission ------------------------------------------------------
    def _emit_windows(self) -> List[WindowResult]:
        if self.panes_closed < self.window_panes or \
                (self.panes_closed - self.window_panes) % self.slide_panes:
            return []
        merged = agg.Accumulator()
        rows = 0
        lines: Optional[List[str]] = [] if self.retain_rows else None
        for rec in self._ring:
            for key, val in rec["state"].items():
                merged.add(key, val)
            rows += rec["rows"]
            if lines is not None:
                if rec["lines"] is None:
                    lines = None          # restored pane: rows not retained
                else:
                    lines.extend(rec["lines"])
        tables = self.folder.tables(merged, rows)
        results = {c.name: c.finalize(tables) for c in self.folder.consumers}
        window = WindowResult(
            index=self.windows_emitted,
            first_pane=self.panes_closed - self.window_panes,
            last_pane=self.panes_closed - 1,
            rows=rows, tables=tables, results=results, lines=lines,
            retained=self.retain_rows)
        self.windows_emitted += 1
        self.counters.increment("Stream", "windows")
        if self.on_window is not None:
            self.on_window(window)
        return [window]

    # -- checkpointable state -------------------------------------------------
    def state(self) -> dict:
        """The windowed accumulator ring + progress cursors — everything a
        resumed scan needs to reproduce the remaining windows byte-for-byte
        when re-fed from row ``rows_consumed``.  Raw retained lines and
        the open pane's buffered rows are NOT persisted: the cursor points
        at the last closed pane boundary, so a resume re-feeds them.
        ``"shard"`` records the topology the panes were folded under
        (``""``: unsharded), the JAX package's snapshot field."""
        return {
            "pane": self.panes_closed,
            "windows": self.windows_emitted,
            "rows_consumed": self.rows_consumed,
            "shard": self.folder.g_suffix,
            "ring": [{"pane": rec["pane"], "rows": rec["rows"],
                      "state": dict(rec["state"])} for rec in self._ring],
        }

    def load(self, state: dict) -> None:
        self.panes_closed = int(state["pane"])
        self.windows_emitted = int(state["windows"])
        self.rows_consumed = int(state["rows_consumed"])
        self._ring.clear()
        for rec in state["ring"]:
            self._ring.append({"pane": int(rec["pane"]),
                               "rows": int(rec["rows"]),
                               "state": {k: np.asarray(v)
                                         for k, v in rec["state"].items()},
                               "lines": None})
        self._pane_buf = []


class WindowCheckpointer:
    """Mid-stream durability for the windowed ring — the StreamCheckpointer
    discipline applied to pane-granular state, in the JAX package's
    on-disk format (each package resumes the other's snapshot where the
    two fold under the same key family).

    Snapshots (every ``stream.checkpoint.interval.panes`` closed panes) hold
    the ring + cursors under the conf-derived run fingerprint the streamed
    jobs use (``StreamCheckpointer.run_id_from_conf``); restore refuses a
    snapshot written by another configuration, and one folded under
    another routing or topology, loudly, unless ``reshard`` (the
    ``shard.reshard.on.restore`` key) redistributes it.  A resumed scan
    re-fed from row ``rows_consumed`` reproduces the remaining windows
    byte for byte.  In a run of several processes each snapshots its own
    (identical) ring under ``proc-NNN-of-NNN/``."""

    def __init__(self, directory: str, run_id: str = "",
                 interval_panes: int = 8, resume: bool = False,
                 reshard: bool = False, fault=None):
        from avenir_tpu_torch.utils.checkpoint import CheckpointManager

        self.directory = directory
        self.run_id = run_id
        self.reshard = reshard
        self.interval = max(int(interval_panes), 1)
        self.fault = fault               # utils/retry.FaultPlan or None
        self.mgr = CheckpointManager(directory, keep=2)
        self._components: Dict[str, Any] = {}
        self.restored: Optional[dict] = None
        if resume:
            if self.fault is not None:
                self.fault.hit("checkpoint.restore")
            state = self.mgr.restore()
            if state is not None:
                snap_run = str(state.get("run", ""))
                if snap_run and run_id and snap_run != run_id:
                    raise ConfigError(
                        f"stream snapshot in {directory!r} was written by "
                        f"run {snap_run!r}, not this run {run_id!r} — the "
                        f"configuration changed since the checkpoint; clear "
                        f"the directory and restart the stream")
                self.restored = state

    @classmethod
    def from_conf(cls, conf: JobConfig,
                  fault=None) -> Optional["WindowCheckpointer"]:
        from avenir_tpu_torch.checkpoint.procdir import proc_subdir
        from avenir_tpu_torch.jobs.base import StreamCheckpointer

        directory = conf.get("stream.checkpoint.dir")
        if not directory:
            return None
        # several processes: each snapshots its own (replicated) ring under
        # a process subdirectory, which pins the process count — a
        # relaunch at another count finds no snapshot and starts from
        # zero; a deliberate N → M restore points stream.checkpoint.dir at
        # the subdirectory itself and reshards
        return cls(
            proc_subdir(directory),
            run_id=StreamCheckpointer.run_id_from_conf(conf),
            interval_panes=conf.get_int("stream.checkpoint.interval.panes", 8),
            resume=conf.get_bool("stream.resume", False),
            reshard=conf.get_bool("shard.reshard.on.restore", False),
            fault=fault)

    def attach(self, key: str, component) -> None:
        """Register a sidecar whose ``state()``/``load()`` rides the ring
        snapshot (the drift detector: its reference window and streak must
        resume WITH the windows).  Attach before :meth:`restore_into`."""
        self._components[key] = component

    def restore_into(self, ws: WindowedScan) -> int:
        """Load the restored snapshot (if any) into ``ws`` and every
        attached component; returns the row cursor the caller must re-feed
        from (0 on a fresh start).

        A snapshot whose pane states use another key family than
        ``ws``'s folder — another mesh topology, gram state written on
        ``cuda`` (``g:…``) read by the CPU's einsum routing, a packed gram
        under another key — is redistributed through
        ``ChunkFolder.adopt_state`` under ``shard.reshard.on.restore``
        (journaled ``checkpoint.reshard``) and refused with ConfigError
        without it, never folded: loading it would silently drop counts
        from the merged window tables.  Einsum ``fc``/``pcc<off>`` counts
        read by a gram routing are refused either way, and state
        ``adopt_state`` cannot move raises its ``ReshardError``."""
        from avenir_tpu_torch.checkpoint import reshard

        if self.restored is None:
            return 0
        state = self.restored
        try:
            snap_sfx = reshard.snapshot_suffix(state)
        except reshard.ReshardError as e:
            raise ConfigError(str(e)) from e
        cur_sfx = ws.folder.g_suffix
        ring = state.get("ring") or []
        mismatch = any(
            not ws.folder.state_matches_routing(rec.get("state") or {})
            for rec in ring)
        if mismatch:
            snap_einsum = any("fc" in (rec.get("state") or {})
                              for rec in ring)
            if snap_einsum and ws.folder.step != "einsum":
                raise ConfigError(
                    f"stream snapshot in {self.directory!r} was written "
                    f"under the chunked-einsum count routing ('fc'/"
                    f"'pcc<off>' keys) but this run folds the fused "
                    f"gram — einsum counts cannot be promoted onto a "
                    f"gram routing; resume on a matching routing (e.g. "
                    f"the unsharded CPU path), or clear the directory "
                    f"and restart the stream")
            if not self.reshard:
                if snap_sfx is not None and snap_sfx != cur_sfx:
                    written, reads = (reshard.describe(snap_sfx),
                                      reshard.describe(cur_sfx))
                else:
                    written = "the fused gram routing"
                    reads = ("the chunked-einsum count routing"
                             if ws.folder.step == "einsum"
                             else "a differently-keyed gram routing")
                raise ConfigError(
                    f"stream snapshot in {self.directory!r} was written "
                    f"under {written!r} but this run folds under "
                    f"{reads!r} — set shard.reshard.on.restore=true to "
                    f"redistribute the snapshot onto the new layout "
                    f"(ElasticGraft, "
                    f"docs/runbooks/preemption_recovery.md), or clear "
                    f"the directory and restart the stream")
            rekeyed: List[str] = []
            for rec in ring:
                rec["state"], moved = ws.folder.adopt_state(rec["state"])
                rekeyed.extend(moved)
            state["shard"] = cur_sfx
            reshard.journal_reshard(
                snap_sfx if snap_sfx is not None else "", cur_sfx,
                len(rekeyed), directory=self.directory, run=self.run_id)
        ws.load(state)
        extras = state.get("extras") or {}
        for key, component in self._components.items():
            if key in extras:
                component.load(extras[key])
        tel.tracer().event("checkpoint.restore", dir=self.directory,
                           run=self.run_id, rows=ws.rows_consumed,
                           chunk=ws.panes_closed)
        return ws.rows_consumed

    def maybe_save(self, ws: WindowedScan) -> None:
        if ws.panes_closed and ws.panes_closed % self.interval == 0:
            self.save(ws)

    def save(self, ws: WindowedScan) -> None:
        if self.fault is not None:
            # BEFORE any write: an injected save-crash must leave the
            # previous snapshot whole
            self.fault.hit("checkpoint.save")
        # "run" fingerprints the writing configuration: restore rejects a
        # snapshot whose run id differs
        state = ws.state()
        state["run"] = self.run_id
        if self._components:
            state["extras"] = {key: component.state()
                               for key, component in self._components.items()}
        self.mgr.save(ws.panes_closed, state)
        tel.tracer().event("checkpoint.save", dir=self.directory,
                           run=self.run_id, rows=ws.rows_consumed,
                           chunk=ws.panes_closed)

    def finish(self) -> None:
        """Remove the snapshots after a cleanly completed stream (the
        manager also removes the then-empty directory)."""
        self.mgr.clear()
