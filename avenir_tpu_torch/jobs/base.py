"""Job layer — the reference's ``hadoop jar <ToolClass> -Dconf.path=p in out``
contract; port of the single-process subset of ``avenir_tpu/jobs/base.py``.

A job is a plain object with ``run(conf, input_path, output_path, device)``:
input is a CSV file or a directory of part files, output is written as
``<out>/part-00000``, and the properties and JSON feature schema keep their
reference key names (``feature.schema.file.path``, ``field.delim.regex``,
``stream.chunk.rows``, ...).  ``device`` is ``cuda`` unless the caller asks
for ``cpu``.

Inputs are parsed by the native encoder (``runtime/native.py``) wherever
the JAX package parses them natively, and streamed chunk by chunk with
per-chunk retry (``utils/retry.py``) through the device feeder
(``runtime/feeder.py``).  A streamed count job checkpoints its totals and
cursor with :class:`StreamCheckpointer` (``stream.checkpoint.dir``) and
resumes from them (``stream.resume``, the CLI's ``--resume``).
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Sequence

import numpy as np

from avenir_tpu_torch.core.config import ConfigError, JobConfig
from avenir_tpu_torch.core.csv_io import iter_csv_chunks, read_csv
from avenir_tpu_torch.core.encoding import DatasetEncoder, EncodedDataset
from avenir_tpu_torch.core.schema import FeatureSchema
from avenir_tpu_torch.device import resolve_device
from avenir_tpu_torch.utils.metrics import Counters

PART_FILE = "part-00000"


def refused_tenant_key(conf: JobConfig) -> Optional[str]:
    """Why the port cannot run this conf's tenancy, or None.  ``tenant.id``
    alone is a label (the JAX package's arbiter is a no-op without a
    contract); any other ``tenant.*`` key — a ``tenant.<id>.*`` contract,
    ``tenant.pool.concurrency``, ``tenant.queue.*``, bare or under the
    conf's prefix — asks for the arbiter, which is not ported."""
    pref = conf.prefix + "."
    bare = {k: k[len(pref):] if k.startswith(pref) else k for k in conf.props}
    keys = sorted(k for k, b in bare.items()
                  if b.startswith("tenant.") and b != "tenant.id")
    if not keys:
        return None
    return (f"{keys[0]} is not ported yet (the tenancy arbiter, tenancy/: "
            f"ROADMAP.md, Queue 1 item 7f)")


def input_files(path: str) -> List[str]:
    """Resolve a job input path (file, or dir of part files) to a file list;
    directory reads skip hidden files and ``_SUCCESS`` markers."""
    if os.path.isdir(path):
        names = sorted(
            n for n in os.listdir(path)
            if not n.startswith(".") and not n.startswith("_")
        )
        return [os.path.join(path, n) for n in names]
    return [path]


def read_input(path: str, delim: str = ",") -> np.ndarray:
    """All input rows as one [N, ncols] object array of strings."""
    chunks = [read_csv(f, delim=delim) for f in input_files(path)]
    chunks = [c for c in chunks if c.size]
    if not chunks:
        return np.empty((0, 0), dtype=object)
    return np.concatenate(chunks, axis=0) if len(chunks) > 1 else chunks[0]


def iter_input_chunks(path: str, chunk_rows: int = 1_000_000,
                      delim: str = ",") -> Iterator[np.ndarray]:
    for f in input_files(path):
        yield from iter_csv_chunks(f, chunk_rows=chunk_rows, delim=delim)


def output_target(path: str, part: str = PART_FILE) -> str:
    """``<path>/<part>`` for the MR directory layout, or ``path`` itself when
    it names a plain file (has an extension); creates parent dirs."""
    if path.endswith(os.sep) or not os.path.splitext(path)[1]:
        os.makedirs(path, exist_ok=True)
        return os.path.join(path, part)
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    return path


def write_output(path: str, lines: Sequence[str], part: str = PART_FILE) -> str:
    """Write job output lines under ``<path>/<part>``; returns the file path."""
    target = output_target(path, part)
    with open(target, "w") as fh:
        for line in lines:
            fh.write(line)
            fh.write("\n")
    return target


def read_lines(path: str) -> List[str]:
    out: List[str] = []
    for f in input_files(path):
        with open(f) as fh:
            out.extend(line.rstrip("\r\n") for line in fh if line.strip())
    return out


class Job:
    """Base: subclasses set ``name`` (the reference Tool class simple name)
    and implement :meth:`execute`, reading ``self.device``."""

    name: str = ""
    device = None

    def run(self, conf: JobConfig, input_path: str, output_path: str,
            device=None) -> Counters:
        """Run the job under the conf's telemetry, as the JAX package's
        ``Job.run``: ``trace.*`` / ``profile.*`` / ``blackbox.*``
        configure the tracer, the profiler and the flight recorder;
        ``tenant.id`` labels every event and names the journal shard.  A
        ``tenant.*`` contract key is refused before anything is written
        (:func:`refused_tenant_key`)."""
        from avenir_tpu_torch.telemetry import blackbox
        from avenir_tpu_torch.telemetry import profile as _profile
        from avenir_tpu_torch.telemetry import spans as tel

        why = refused_tenant_key(conf)
        if why is not None:
            raise NotImplementedError(f"{self.name or type(self).__name__}: "
                                      f"{why}")
        self.device = resolve_device(device)
        tracer = tel.configure(conf)
        counters = Counters()
        name = self.name or type(self).__name__
        # the conf fingerprint ties the span to the configuration that
        # ran, the identity checkpoint snapshots carry; built only when
        # tracing is on (it sorts and hashes every property)
        attrs = None
        if tracer.enabled:
            attrs = {"conf": StreamCheckpointer.run_id_from_conf(conf),
                     "input": input_path, "output": output_path}
        tenant = conf.get("tenant.id")
        with tel.label_scope(tenant=tenant), \
                tracer.span(f"job.{name}", attrs=attrs), \
                blackbox.watchdog_guard(f"job.{name}"):
            self.execute(conf, input_path, output_path, counters)
        # the final counter snapshot, only when this job is the outermost
        # traced unit: nested in a pipeline stage, the driver snapshots
        # the stage, and a second series would double the CLI's deltas
        if tracer.enabled and tracer.current() is None:
            with tel.label_scope(tenant=tenant):
                tracer.counters(name, counters)
        # a one-shot CLI run never reaches Tracer.disable: flush program
        # totals here (a no-op when profiling is off)
        _profile.profiler().flush()
        return counters

    def execute(self, conf: JobConfig, input_path: str, output_path: str,
                counters: Counters) -> None:
        raise NotImplementedError

    # -- shared plumbing -----------------------------------------------------
    @staticmethod
    def load_schema(conf: JobConfig) -> FeatureSchema:
        path = conf.get("feature.schema.file.path")
        if not path:
            raise ConfigError("feature.schema.file.path not set")
        return FeatureSchema.from_file(path)

    @staticmethod
    def encoder_for(conf: JobConfig) -> DatasetEncoder:
        return DatasetEncoder(Job.load_schema(conf))

    @staticmethod
    def encode_input(conf: JobConfig, input_path: str,
                     with_labels: bool = True,
                     encoder: Optional[DatasetEncoder] = None,
                     need_rows: bool = True):
        """(encoder, encoded dataset, raw rows) for whole-input jobs.

        ``need_rows=False`` (jobs that never echo the raw fields) takes the
        native encoder when the schema is complete and the delimiter is one
        character; ``rows`` then comes back as None.  The codes are the same
        either way."""
        delim = conf.field_delim_regex
        enc = encoder or Job.encoder_for(conf)
        if not need_rows and len(delim) == 1:
            ds = Job._encode_input_native(input_path, enc, delim, with_labels)
            if ds is not None:
                return enc, ds, None
        rows = read_input(input_path, delim=delim)
        ds = enc.fit_transform(rows, with_labels=with_labels) if not enc._fitted \
            else enc.transform(rows, with_labels=with_labels)
        return enc, ds, rows

    @staticmethod
    def encode_input_with_lines(conf: JobConfig, input_path: str,
                                with_labels: bool = True,
                                encoder: Optional[DatasetEncoder] = None):
        """(encoder, encoded dataset, input lines) for scoring jobs that echo
        each input line into their output (line ``i`` is row ``i``; blank
        lines are skipped on both sides).  The native path echoes the raw
        lines it parsed, under the conditions of ``encode_input(need_rows=
        False)`` and when the input and output delimiters agree; the Python
        path rejoins the parsed fields with the output delimiter."""
        delim = conf.field_delim_regex
        enc = encoder or Job.encoder_for(conf)
        if len(delim) == 1 and delim == conf.field_delim:
            got = Job._encode_input_native(input_path, enc, delim,
                                           with_labels, want_lines=True)
            if got is not None:
                ds, lines = got
                if lines is not None and len(lines) == ds.num_rows:
                    return enc, ds, lines
        enc2, ds, rows = Job.encode_input(conf, input_path,
                                          with_labels=with_labels, encoder=enc)
        return enc2, ds, [conf.field_delim.join(str(v) for v in row)
                          for row in rows]

    @staticmethod
    def _sniff_ncols(path: str, delim: str, block: int = 1 << 16) -> int:
        """Field count of the first non-blank line of ``path``, read in
        bounded blocks; 0 when the file has no non-blank line.  A
        one-byte delimiter is counted block by block as the line streams
        by, so a very long first line costs O(L) time and O(block)
        memory."""
        d = delim.encode()
        # single-byte delimiters never straddle a block boundary, so the
        # count accumulates per block; multi-byte ones keep the line
        # buffered, the newline search resuming where the last block ended
        streaming = len(d) == 1 and d != b"\r"
        count = -1                     # -1: still skipping blank lines
        tail = b""                     # carried bytes (1 on streaming path)
        scan0 = 0                      # newline-search resume offset
        with open(path, "rb") as fh:
            while True:
                chunk = fh.read(block)
                data = tail + chunk
                tail = b""
                at_eof = not chunk
                while count < 0:
                    nl = data.find(b"\n")
                    if nl < 0:
                        if data.strip():
                            count = 0          # first line starts here
                        elif at_eof:
                            return 0
                        break
                    if data[:nl].strip():      # whole first line in hand
                        return data[:nl].rstrip(b"\r").count(d) + 1
                    data = data[nl + 1:]       # blank line: skip
                if count < 0:
                    tail = data
                    continue
                nl = data.find(b"\n", scan0)
                if nl >= 0:
                    return count + data[:nl].rstrip(b"\r").count(d) + 1
                if at_eof:
                    return count + data.rstrip(b"\r").count(d) + 1
                if streaming:
                    # keep one byte so a final \r\n still strips correctly
                    body, tail = data[:-1], data[-1:]
                    count += body.count(d)
                    scan0 = 0
                else:
                    tail = data
                    scan0 = len(data)

    @staticmethod
    def _encode_input_native(input_path: str, enc: DatasetEncoder,
                             delim: str, with_labels: bool,
                             want_lines: bool = False):
        """EncodedDataset through the native encoder, or None where the
        input asks for the Python one: a schema that is not complete, a
        file narrower than the schema, or an empty input.

        With ``want_lines`` returns ``(dataset, lines)``, the lines being the
        non-blank input lines of the same bytes the encoder parsed, or
        ``lines=None`` when they do not decode as UTF-8 (the Python path
        reads with the locale's encoding)."""
        from avenir_tpu_torch.runtime import native

        if not (enc._fitted or enc.schema_complete(with_labels)):
            return None
        # every part file's width first (bounded reads): one narrow part
        # sends the whole input to the Python path, which degrades there
        # (e.g. labels=None when the class column is absent)
        files = []
        for f in input_files(input_path):
            ncols = Job._sniff_ncols(f, delim)
            if ncols == 0:
                continue                       # empty/blank file: skip
            if ncols <= enc.max_ordinal(with_labels):
                return None
            files.append((f, ncols))
        parts = []
        lines: Optional[List[str]] = [] if want_lines else None
        for f, ncols in files:
            with open(f, "rb") as fh:
                data = fh.read()
            parts.append(native.encode_bytes(data, enc, ncols=ncols,
                                             delim=delim,
                                             with_labels=with_labels))
            if lines is not None:
                try:
                    lines.extend(ln.decode().rstrip("\r")
                                 for ln in data.split(b"\n") if ln.strip())
                except UnicodeDecodeError:
                    lines = None
        if not parts:
            return None                      # empty input: python path decides
        if len(parts) == 1:
            ds = parts[0]
        else:
            first = parts[0]
            cat = lambda key: (None if getattr(first, key) is None else  # noqa: E731
                               np.concatenate([getattr(p, key) for p in parts]))
            ds = EncodedDataset(
                codes=cat("codes"), cont=cat("cont"), labels=cat("labels"),
                ids=cat("ids"), n_bins=first.n_bins,
                class_values=first.class_values,
                binned_ordinals=first.binned_ordinals,
                cont_ordinals=first.cont_ordinals)
        return (ds, lines) if want_lines else ds

    def encoded_data_source(self, conf: JobConfig, input_path: str,
                            counters: Counters, with_labels: bool = True,
                            checkpointer: Optional["StreamCheckpointer"] = None):
        """(encoder, data, rows_fn) for count jobs whose model ``fit`` takes
        one EncodedDataset or a chunk iterable.

        With ``stream.chunk.rows`` set, ``data`` is the lazy retried chunk
        stream (:meth:`iter_encoded_retrying`; the schema must declare every
        vocabulary and bin range, as the reference's mappers require),
        pulled through a :class:`DeviceFeeder` (``stream.prefetch.depth``
        items, default 2; 0 disables), so chunk i+1 is read, encoded and
        copied to ``self.device`` while chunk i is counted.  Otherwise it is
        the whole encoded input.  ``rows_fn()`` reports the rows processed,
        read from the cursor of the last chunk consumed: call it only after
        ``fit`` has consumed the stream.

        With a ``checkpointer`` the stream starts at its restored cursor,
        ``rows_fn()`` adds its restored rows, and it is told of every chunk
        the model has counted.  The cursor travels with its chunk through
        the feeder, so a snapshot describes exactly the chunks counted,
        never the feeder's read-ahead."""
        if conf.get("stream.chunk.rows"):
            enc = self.encoder_for(conf)
            ckpt = checkpointer
            base_rows = ckpt.base_rows if ckpt else 0
            box = {"n": base_rows}
            pairs = self.iter_encoded_retrying(
                conf, input_path, enc, counters, with_labels=with_labels,
                start=ckpt.start if ckpt else None, emit_cursor=True)
            depth = conf.get_int("stream.prefetch.depth", 2)
            if depth > 0:
                from avenir_tpu_torch.runtime.feeder import DeviceFeeder

                pairs = DeviceFeeder(pairs, depth=depth, device=self.device)

            def consume():
                if ckpt is None:
                    # no lookahead: it would hold one more staged chunk on
                    # the device than the prefetch depth, for nothing
                    for ds, cur in pairs:
                        box["n"] = base_rows + cur["rows"]
                        yield ds
                    return
                # one-pair lookahead: the snapshot for chunk k is written
                # only once chunk k+1 exists, so a persisted cursor never
                # points at the end of the stream (a resume always has a
                # chunk to read, which the models' first-chunk peek needs)
                it = iter(pairs)
                prev = next(it, None)
                while prev is not None:
                    ds, cur = prev
                    box["n"] = base_rows + cur["rows"]
                    yield ds
                    nxt = next(it, None)
                    ckpt.chunk_done(cur, last=nxt is None)
                    prev = nxt

            return enc, Job._chunk_telemetry(consume(), counters,
                                             device=self.device), \
                lambda: box["n"]
        enc, ds, _rows = self.encode_input(conf, input_path,
                                           with_labels=with_labels,
                                           need_rows=False)
        return enc, ds, lambda: ds.num_rows

    @staticmethod
    def stream_checkpointer(conf: JobConfig) -> Optional["StreamCheckpointer"]:
        """The job's :class:`StreamCheckpointer`, or None when not
        configured."""
        return StreamCheckpointer.from_conf(conf)

    @staticmethod
    def _chunk_telemetry(chunks, counters: Counters, device=None):
        """Per-chunk telemetry around a streamed chunk source, as the JAX
        package's: ``Telemetry::recompiles`` counts the chunks whose
        (codes, labels, cont) shapes differ from every shape seen before,
        after the first (a steady stream counts at most one, for its
        ragged tail); with tracing on, a retroactive ``chunk`` span covers
        the consumer's work on each chunk, parented to the span current
        when the stream starts; under ``profile.on`` each chunk shape is a
        ``stream`` program, the consumer's wall is sampled against it and
        ``device``'s memory at the chunk boundary."""
        import time

        from avenir_tpu_torch.telemetry import profile as _profile
        from avenir_tpu_torch.telemetry import spans as tel

        tracer = tel.tracer()
        prof = _profile.profiler()
        monitor = tel.CompileKeyMonitor(counters, scope="stream",
                                        auto_prime=True)
        parent = tracer.current()
        for k, ds in enumerate(chunks):
            key = tel.CompileKeyMonitor.shape_key(ds.codes, ds.labels, ds.cont)
            monitor.observe([key])
            if not (tracer.enabled or prof.enabled):
                yield ds
                continue
            attrs = {"chunk": k, "rows": ds.num_rows}
            if prof.enabled:
                attrs["program"] = _profile.program_id("stream", key)
            t0 = time.perf_counter()
            yield ds
            dur_s = time.perf_counter() - t0
            if prof.enabled:
                prof.sample(key, "stream", dur_s)
                prof.sample_device_memory(
                    "chunk", None if device is None else [device])
            tracer.emit_span("chunk", dur_s, parent=parent, attrs=attrs)

    @staticmethod
    def _iter_chunks_retrying(conf: JobConfig, input_path: str,
                              counters: Counters, decode, owner=None,
                              start: Optional[dict] = None):
        """The chunk-scan and retry engine behind both streaming readers.

        Scans each input file by (byte offset, global chunk index); the
        retried task re-opens, re-seeks, re-reads and re-decodes one chunk
        (``decode(raw_lines, path)`` runs inside the task, so a decode fault
        is retried with the read; policy from ``mapred.map.max.attempts``).
        The end of each file is found by one more task that reads nothing,
        as in the JAX package, so ``Task::attempts`` counts it too.
        ``owner(chunk_index)`` assigns chunks: chunks it refuses are scanned
        for their boundaries but never decoded or yielded.  ``start``
        resumes from a persisted cursor (``{"file", "offset", "chunk"}``,
        the position after the last chunk counted).  Yields
        ``(file, offset_after, chunk_index_after, payload)``."""
        from avenir_tpu_torch.utils.retry import RetryPolicy, run_with_retry

        policy = RetryPolicy.from_conf(conf)
        chunk_rows = conf.get_int("stream.chunk.rows", 1_000_000)
        i = int(start["chunk"]) if start else 0
        files = input_files(input_path)
        if start:
            if start["file"] not in files:
                raise ConfigError(
                    f"resume cursor names {start['file']!r}, which is not "
                    f"among the input files — the input changed since the "
                    f"checkpoint was written")
            files = files[files.index(start["file"]):]
        for fi, f in enumerate(files):
            offset = int(start["offset"]) if start and fi == 0 else 0
            while True:
                def task(path=f, off=offset, idx=i):
                    mine = owner is None or owner(idx)
                    with open(path, "rb") as fh:
                        fh.seek(off)
                        raw: List[bytes] = []
                        nraw = 0
                        while nraw < chunk_rows:
                            ln = fh.readline()
                            if not ln:
                                break
                            if ln.strip():
                                nraw += 1
                                if mine:
                                    raw.append(ln)
                        end = fh.tell()
                    if not nraw:
                        return end, None
                    if not mine:
                        return end, Job._SKIP
                    return end, decode(raw, path)

                offset, payload = run_with_retry(
                    task, policy=policy, counters=counters, task=f"chunk[{i}]")
                if payload is None:
                    break
                i += 1
                if payload is Job._SKIP:
                    continue
                yield f, offset, i, payload

    _SKIP = object()                     # a chunk owner() refused

    @staticmethod
    def iter_line_chunks_retrying(conf: JobConfig, input_path: str,
                                  counters: Counters, owner=None,
                                  emit_index: bool = False):
        """Raw non-blank lines in ``stream.chunk.rows``-line chunks with
        per-chunk retry, for records that are not rectangular CSV.  Yields
        ``list[str]`` (newlines stripped), or ``(chunk_index, list[str])``
        with ``emit_index``."""
        decode = lambda raw, path: [ln.decode().rstrip("\r\n") for ln in raw]  # noqa: E731
        for _f, _off, idx, lines in Job._iter_chunks_retrying(
                conf, input_path, counters, decode, owner=owner):
            yield (idx - 1, lines) if emit_index else lines

    @staticmethod
    def iter_encoded_retrying(conf: JobConfig, input_path: str,
                              encoder: DatasetEncoder, counters: Counters,
                              with_labels: bool = True,
                              start: Optional[dict] = None,
                              emit_cursor: bool = False, owner=None):
        """Encoded chunks of ``stream.chunk.rows`` rows with per-chunk retry:
        the retried task is the read, parse and encode of one chunk,
        addressed by (file, byte offset) as a Hadoop map task is by its
        split.  The native encoder parses a chunk where the schema is
        complete, the delimiter one character and the chunk's rows wide
        enough; else the Python one does (which raises ConfigError, not
        retried, on an incomplete schema).

        ``start`` resumes after a persisted cursor; ``emit_cursor`` yields
        ``(chunk, cursor)`` pairs, the cursor ``{"file", "offset", "chunk",
        "rows"}`` being the position after the chunk and the rows yielded
        since ``start``."""
        from avenir_tpu_torch.core.csv_io import read_csv_string
        from avenir_tpu_torch.runtime import native

        delim = conf.field_delim_regex
        use_native = len(delim) == 1 and (
            encoder._fitted or encoder.schema_complete(with_labels))

        def decode(raw, path):
            ncols = raw[0].rstrip(b"\r\n").count(delim.encode()) + 1
            if use_native and ncols > encoder.max_ordinal(with_labels):
                return native.encode_bytes(
                    b"".join(raw), encoder, ncols=ncols, delim=delim,
                    with_labels=with_labels)
            rows = read_csv_string(b"".join(raw).decode(), delim=delim)
            return encoder.transform(rows, with_labels=with_labels)

        rows_out = 0
        for f, offset, i, ds in Job._iter_chunks_retrying(
                conf, input_path, counters, decode, owner=owner, start=start):
            if emit_cursor:
                rows_out += ds.num_rows
                yield ds, {"file": f, "offset": offset, "chunk": i,
                           "rows": rows_out}
            else:
                yield ds


class StreamCheckpointer:
    """Mid-stream durability for the streamed count jobs, in one process;
    port of the JAX package's ``StreamCheckpointer`` with its on-disk
    snapshots, so each package resumes the other's.

    The jobs accumulate count totals in memory across the whole input, so
    without this a crash at chunk N restarts from zero.  Configured by:

    - ``stream.checkpoint.dir``: the snapshot directory (enables it, with
      ``stream.chunk.rows``);
    - ``stream.checkpoint.interval.chunks``: a snapshot every N counted
      chunks (default 8);
    - ``stream.resume``: restore the latest snapshot and continue from its
      cursor (the CLI's ``--resume``);
    - ``stream.fault.crash.after.chunks``: raise after N counted chunks
      (kill-and-resume testing);
    - ``stream.run.id``: the run's identity; by default a fingerprint of
      the properties that are not relaunch switches
      (:meth:`run_id_from_conf`).

    A snapshot is {accumulator totals, cursor (file, offset, chunk), rows,
    run}.  The totals are int64 (or float64) host arrays, so a resumed
    run's part file is byte-identical to an uninterrupted one.  After a
    successful run :meth:`finish` removes the snapshots, and the directory
    once it is empty.  Each save and restore journals ``checkpoint.save``
    / ``checkpoint.restore`` (with tracing on).  The multi-process half of
    the JAX class (per-process subdirectories tagged ``RUN_TAG``, the
    error handshake) is not ported."""

    def __init__(self, directory: str, interval_chunks: int = 8,
                 resume: bool = False, crash_after_chunks: int = 0,
                 run_id: str = "", reshard: bool = False):
        from avenir_tpu_torch.ops import agg
        from avenir_tpu_torch.utils import checkpoint

        self.directory = directory
        self.run_id = run_id
        self.interval = max(int(interval_chunks), 1)
        self.crash_after = int(crash_after_chunks)
        self.accumulator = agg.Accumulator()
        self.base_rows = 0
        self.start: Optional[dict] = None      # cursor to resume from
        self._consumed = 0                     # chunks counted in this run
        try:
            self.mgr = checkpoint.CheckpointManager(directory, keep=2)
            state = self.mgr.restore() if resume else None
        except Exception as e:
            raise ConfigError(f"checkpointer construction in {directory!r} "
                              f"failed: {type(e).__name__}: {e}") from e
        if state is None:
            return
        snap_run = str(state.get("run", ""))
        if snap_run and self.run_id and snap_run != self.run_id:
            raise ConfigError(
                f"snapshot in {directory!r} was written by run "
                f"{snap_run!r}, not this run {self.run_id!r} — "
                f"the configuration changed since the "
                f"checkpoint; clear the directory and re-run")
        try:
            snap_sfx = checkpoint.snapshot_suffix(state)
        except checkpoint.ReshardError as e:
            raise ConfigError(str(e)) from e
        if snap_sfx:
            if reshard:
                raise NotImplementedError(
                    f"snapshot in {directory!r} was folded under mesh "
                    f"topology {snap_sfx!r}: redistributing it "
                    f"(shard.reshard.on.restore=true) is not ported yet "
                    f"(ROADMAP.md, Queue 1 item 7)")
            raise ConfigError(
                f"snapshot in {directory!r} was folded "
                f"under mesh topology {snap_sfx!r} but "
                f"this job folds unsharded — set "
                f"shard.reshard.on.restore=true to "
                f"redistribute it, or clear the "
                f"directory and re-run")
        try:
            self.accumulator.load(state["acc"])
            self.base_rows = int(state["rows"])
            self.start = {k: state["cursor"][k]
                          for k in ("file", "offset", "chunk")}
        except Exception as e:
            raise ConfigError(f"checkpointer construction in {directory!r} "
                              f"failed: {type(e).__name__}: {e}") from e
        from avenir_tpu_torch.telemetry import spans as tel

        tel.tracer().event("checkpoint.restore", dir=self.directory,
                           run=self.run_id, rows=self.base_rows,
                           chunk=int(self.start["chunk"]))

    # relaunch switches and operational knobs: a crashed run and its resume
    # keep one identity when these differ.  ``stream.chunk.rows`` stays in:
    # it defines the chunk boundaries a persisted cursor means.
    VOLATILE = ("stream.resume", "stream.fault.", "stream.checkpoint.",
                "stream.prefetch.", "shard.devices", "shard.data.axis",
                "shard.proc.", "shard.reshard.", "shard.skew.", "fault.")

    @classmethod
    def run_id_from_conf(cls, conf: JobConfig) -> str:
        """The run's identity: ``stream.run.id`` when set, else blake2s
        (6 bytes) over the repr of the sorted properties that are not
        :attr:`VOLATILE` — the JAX package's id for the same properties.
        ``--device`` is not a property, so a run crashed on ``cuda`` resumes
        on the CPU."""
        explicit = conf.get("stream.run.id")
        if explicit:
            return explicit
        import hashlib

        stable = sorted(
            (k, v) for k, v in conf.props.items()
            if not any(k == v0.rstrip(".") or k.startswith(v0)
                       for v0 in cls.VOLATILE))
        return hashlib.blake2s(repr(stable).encode(),
                               digest_size=6).hexdigest()

    @classmethod
    def from_conf(cls, conf: JobConfig) -> Optional["StreamCheckpointer"]:
        """A checkpointer when ``stream.checkpoint.dir`` and
        ``stream.chunk.rows`` are both set, else None (and the other
        durability keys are ignored, as the JAX package ignores them)."""
        directory = conf.get("stream.checkpoint.dir")
        if not directory or not conf.get("stream.chunk.rows"):
            return None
        return cls(directory,
                   conf.get_int("stream.checkpoint.interval.chunks", 8),
                   conf.get_bool("stream.resume", False),
                   conf.get_int("stream.fault.crash.after.chunks", 0),
                   run_id=cls.run_id_from_conf(conf),
                   reshard=conf.get_bool("shard.reshard.on.restore", False))

    def chunk_done(self, cursor: dict, last: bool) -> None:
        """Called by the stream once the model has counted the chunk
        ``cursor`` describes; snapshots on the interval, never for the last
        chunk (the job completes and :meth:`finish` removes the state).
        ``Accumulator.add`` copied the chunk's counts to the host already,
        so the snapshot waits for nothing on the device."""
        self._consumed += 1
        total_rows = self.base_rows + int(cursor["rows"])
        if not last and self._consumed % self.interval == 0:
            self.mgr.save(int(cursor["chunk"]),
                          {"acc": self.accumulator.state(),
                           "cursor": {"file": cursor["file"],
                                      "offset": int(cursor["offset"]),
                                      "chunk": int(cursor["chunk"])},
                           "rows": total_rows,
                           "run": self.run_id})
            from avenir_tpu_torch.telemetry import spans as tel

            tel.tracer().event("checkpoint.save", dir=self.directory,
                               run=self.run_id, rows=total_rows,
                               chunk=int(cursor["chunk"]))
        if self.crash_after and self._consumed >= self.crash_after:
            raise RuntimeError(
                f"stream.fault.crash.after.chunks={self.crash_after}: "
                f"injected crash after chunk {cursor['chunk']}")

    def finish(self) -> None:
        """Remove this run's snapshots after a successful run: only the
        manager's own ``step_*`` and temporary entries, never other files
        in the directory, and the directory itself once it is empty."""
        self.mgr.clear()
