"""Job layer — the reference's ``hadoop jar <ToolClass> -Dconf.path=p in out``
contract; port of ``avenir_tpu/jobs/base.py``.

A job is a plain object with ``run(conf, input_path, output_path, device)``:
input is a CSV file or a directory of part files, output is written as
``<out>/part-00000``, and the properties and JSON feature schema keep their
reference key names (``feature.schema.file.path``, ``field.delim.regex``,
``stream.chunk.rows``, ...).  ``device`` is ``cuda`` unless the caller asks
for ``cpu``.

Inputs are parsed by the native encoder (``runtime/native.py``) wherever
the JAX package parses them natively, and streamed chunk by chunk with
per-chunk retry (``utils/retry.py``) through the device feeder
(``runtime/feeder.py``); a count job's chunks on a CUDA card are parsed
there (``ops/csv.py``, :class:`BlockReader`).  A streamed count job checkpoints its totals and
cursor with :class:`StreamCheckpointer` (``stream.checkpoint.dir``) and
resumes from them (``stream.resume``, the CLI's ``--resume``).

Across processes (``python -m avenir_tpu_torch.launch``) a streamed count
job works like Hadoop's input splits: each process owns the chunks with
``idx % nprocs == pid`` (:meth:`Job.distributed_plan`), the totals are
merged in one collective at the end of the stream
(:meth:`Job.distributed_stream`), and process 0 writes the part file
(:meth:`Job.is_output_writer`).
"""

from __future__ import annotations

import dataclasses
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
# the line chunk reader's file buffer: a 1M-line chunk is ~75 MB, which the
# default 8 KB buffer reads in ~9,000 read() calls; where a call is dear,
# as on a sandboxed host (an H100 host measured them at half of a chunk's
# readline loop, and most of its spread), 4 MB makes them ~20
READ_BUFFER = 4 << 20


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


def auto_mesh(conf: JobConfig, device=None):
    """A one-axis ``data`` mesh over every local device of ``device``'s
    kind (``cuda`` unless the caller asks for the CPU), or None — the JAX
    package's ``Job.auto_mesh``.  ``data.parallel.auto`` (default true)
    shards each count job's batch over the mesh when it spans two or more
    devices: the cards of this process on ``cuda`` (one H100 gives None),
    the host slots of ``XLA_FLAGS`` on the CPU
    (``parallel/mesh.py::local_devices``).  ``data.parallel.auto=false``
    runs on one device whatever the topology, and so does a process of a
    fleet (its chunks are its own; a mesh across processes is the
    explicit ``shard.*`` plan)."""
    if not conf.get_bool("data.parallel.auto", True):
        return None
    from avenir_tpu_torch.parallel.mesh import (local_devices, make_mesh,
                                                process_grid)

    if process_grid()[1] > 1:
        return None
    devices = local_devices(device)
    if len(devices) < 2:
        return None
    return make_mesh(("data",), devices=devices)


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
        ``tenant.id`` labels every event and names the journal shard, and
        ``tenant.<id>.*`` contracts arm the tenancy arbiter
        (``tenancy.configure``; a malformed contract raises ConfigError
        before anything is written), so the job's ``ChunkFolder`` folds
        (a stream's panes) and serving dispatches draw arbitrated slots
        under its tenant."""
        from avenir_tpu_torch import tenancy
        from avenir_tpu_torch.telemetry import blackbox
        from avenir_tpu_torch.telemetry import profile as _profile
        from avenir_tpu_torch.telemetry import spans as tel

        self.device = resolve_device(device)
        tenancy.configure(conf)
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
    def auto_mesh(self, conf: JobConfig):
        """The job's data-parallel mesh (:func:`auto_mesh` on the job's
        device), or None."""
        return auto_mesh(conf, self.device)

    # -- across processes (the Hadoop N-machine analog) ---------------------
    @staticmethod
    def process_grid():
        """(process index, process count) of the joined fleet; (0, 1) in a
        plain one-process run."""
        from avenir_tpu_torch.parallel.mesh import process_grid

        return process_grid()

    @classmethod
    def is_output_writer(cls) -> bool:
        """The single-writer protocol: process 0 writes the part file (the
        merged totals are the same on every process)."""
        return cls.process_grid()[0] == 0

    @classmethod
    def distributed_plan(cls, conf: JobConfig, checkpointer):
        """(owner, accumulator, distributed) for a streamed count job.

        In a fleet with ``stream.chunk.rows`` set, chunks are owned round
        robin (``idx % nprocs == pid``, Hadoop handing each of N machines
        its input splits, ``BayesianDistribution.java:82``), each process
        accumulates its own partials, and :meth:`distributed_stream`
        merges the totals once at the end of the stream.  A checkpointer
        is process-scoped already (``proc-NNN-of-NNN/``), so each process
        snapshots and resumes its own partials and cursor over its own
        chunks."""
        pid, nprocs = cls.process_grid()
        if nprocs <= 1 or not conf.get("stream.chunk.rows"):
            return (None, checkpointer.accumulator if checkpointer else None,
                    False)
        owner = lambda idx: idx % nprocs == pid  # noqa: E731
        if checkpointer is not None:
            return owner, checkpointer.accumulator, True
        from avenir_tpu_torch.ops import agg

        return owner, agg.Accumulator(), True

    @staticmethod
    def distributed_stream(chunks, accumulator, rows_fn, merged: dict):
        """Pass the chunks through; at exhaustion, replace the
        accumulator's totals with the across-process sum
        (``all_process_sum_state``) and put the global row count in
        ``merged["rows"]``.  Every model's ``fit`` reads its totals only
        after consuming the stream, so the merge lands between the last
        local chunk and the read-out with no per-model code.  The row
        count rides the same gather, so every process — one that owned no
        chunk too — enters exactly one collective."""
        for ds in chunks:
            yield ds
        from avenir_tpu_torch.parallel.mesh import all_process_sum_state

        state = accumulator.state()
        state["__rows__"] = np.asarray(rows_fn(), np.int64)
        total = all_process_sum_state(state)
        merged["rows"] = int(total.pop("__rows__"))
        accumulator.load(total)

    @classmethod
    def distributed_fit(cls, fit, data, acc, merged: dict):
        """A model ``fit`` over the distributed stream that tolerates a
        process owning no chunk (more processes than chunks): its stream
        is empty, so ``fit`` raises ``NoDataError`` — after the merge
        collective ran, so its peers never stall.  Such a process returns
        None; it is never the writer (process 0 owns chunk 0).  An input
        empty everywhere re-raises on every process, as one process
        would."""
        from avenir_tpu_torch.core.encoding import NoDataError

        try:
            return fit(data)
        except NoDataError:
            if merged.get("rows", 0) > 0 and not cls.is_output_writer():
                return None
            raise

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
                            checkpointer: Optional["StreamCheckpointer"] = None,
                            shard=None, mesh=None, owner=None):
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

        With a ``shard`` plan (``parallel/shard.ShardSpec``) the feeder's
        stage is ``sharded_pair_stage``: each chunk padded to its shard
        target and its row blocks copied to the mesh's devices.  Without
        one, a data ``mesh`` (``auto_mesh``) makes it ``mesh_pair_stage``:
        each chunk split over the mesh as the model's fit would split it.

        With a ``checkpointer`` the stream starts at its restored cursor,
        ``rows_fn()`` adds its restored rows, and it is told of every chunk
        the model has counted.  The cursor travels with its chunk through
        the feeder, so a snapshot describes exactly the chunks counted,
        never the feeder's read-ahead.  ``owner(chunk_index)`` (a fleet's
        :meth:`distributed_plan`) keeps the chunks this process owns."""
        if conf.get("stream.chunk.rows"):
            enc = self.encoder_for(conf)
            ckpt = checkpointer
            base_rows = ckpt.base_rows if ckpt else 0
            box = {"n": base_rows}
            depth = conf.get_int("stream.prefetch.depth", 2)
            staged = depth > 0 and shard is None and mesh is None
            # the consumers (the models' fit, ChunkFolder) read no ids
            pairs = self.iter_encoded_retrying(
                conf, input_path, enc, counters, with_labels=with_labels,
                start=ckpt.start if ckpt else None, emit_cursor=True,
                owner=owner, with_ids=False,
                device=self._decode_device(self.device, staged))
            if depth > 0:
                from avenir_tpu_torch.runtime.feeder import (
                    DeviceFeeder, mesh_pair_stage, sharded_pair_stage)

                stage = (sharded_pair_stage(shard) if shard is not None
                         else None if mesh is None else mesh_pair_stage(mesh))
                pairs = DeviceFeeder(pairs, depth=depth, device=self.device,
                                     stage=stage)

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
    def _decode_device(device, staged: bool):
        """The device a count job's chunk stream is encoded on
        (:meth:`iter_encoded_retrying`'s ``device``), or None for the host:
        a CUDA device whose chunks the feeder's plain stage hands over
        (``staged``: a prefetching feeder with no shard plan or data mesh,
        whose stages pad and split host arrays), since the consumer's
        ``record_stream`` then covers tensors made on the input layer's
        stream."""
        if staged and device is not None and device.type == "cuda":
            return device
        return None

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
                              start: Optional[dict] = None, parent=None,
                              read=None):
        """The chunk-scan and retry engine behind both streaming readers.

        Scans each input file by (byte offset, global chunk index); the
        retried task re-opens, re-seeks, re-reads and re-decodes one chunk
        (``read(path, offset, chunk_rows, mine)`` → (raw, non-blank lines,
        end offset), by default :func:`_read_line_chunk`; then
        ``decode(raw, path)`` inside the task, so a decode fault is retried
        with the read; policy from ``mapred.map.max.attempts``).  The end
        of each file is found by one more task that reads nothing, as in
        the JAX package, so ``Task::attempts`` counts it too.
        ``owner(chunk_index)`` assigns chunks: chunks it refuses are scanned
        for their boundaries but never decoded or yielded.  ``start``
        resumes from a persisted cursor (``{"file", "offset", "chunk"}``,
        the position after the last chunk counted).  Each task's read is
        an ``input.read`` span (``bytes``, ``lines``), a child of
        ``parent`` (the span open where the stream was built, for a
        stream pulled on another thread), else of the pulling thread's
        current span.  Yields ``(file, offset_after, chunk_index_after,
        payload)``."""
        from avenir_tpu_torch.telemetry import spans as tel
        from avenir_tpu_torch.utils.retry import RetryPolicy, run_with_retry

        tracer = tel.tracer()
        policy = RetryPolicy.from_conf(conf)
        read = read or _read_line_chunk
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
                    with tracer.span("input.read", parent=parent) as sp:
                        raw, nraw, end = read(path, off, chunk_rows, mine)
                        sp.set("bytes", end - off)
                        sp.set("lines", nraw)
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
                              emit_cursor: bool = False, owner=None,
                              with_ids: bool = True, device=None):
        """Encoded chunks of ``stream.chunk.rows`` rows with per-chunk retry:
        the retried task is the read, parse and encode of one chunk,
        addressed by (file, byte offset) as a Hadoop map task is by its
        split.  A chunk is read as one byte block (:class:`BlockReader`:
        the lines :func:`_read_lines` reads, at the same boundaries).  The
        native encoder parses a chunk where the schema is complete, the
        delimiter one character and the chunk's rows wide enough; else the
        Python one does (which raises ConfigError, not retried, on an
        incomplete schema).  With a ``device`` and ``with_ids=False`` the
        native route's chunks are encoded there instead
        (``ops/csv.py::encode_csv``: on CUDA from a pinned block, by
        ``csrc/csv_encode.cu``; a chunk it refuses is encoded natively);
        a stream that reads ids stays on the host.  :func:`encode_chunk`
        counts the rows of each route.  ``with_ids=False`` leaves the id
        column unread.

        ``start`` resumes after a persisted cursor; ``emit_cursor`` yields
        ``(chunk, cursor)`` pairs, the cursor ``{"file", "offset", "chunk",
        "rows"}`` being the position after the chunk and the rows yielded
        since ``start``.

        The stream is pulled lazily, usually on the feeder's worker
        thread, so the span open here, where it is built, parents its
        ``input.read`` and ``input.encode`` spans (``route``, ``rows``)."""
        from avenir_tpu_torch.telemetry import spans as tel

        return Job._encoded_chunks(conf, input_path, encoder, counters,
                                   with_labels, start, emit_cursor, owner,
                                   tel.tracer().current(), with_ids, device)

    @staticmethod
    def _encoded_chunks(conf, input_path, encoder, counters, with_labels,
                        start, emit_cursor, owner, parent, with_ids, device):
        from avenir_tpu_torch.telemetry import spans as tel

        tracer = tel.tracer()
        delim = conf.field_delim_regex
        use_native = len(delim) == 1 and (
            encoder._fitted or encoder.schema_complete(with_labels))
        decoder = None
        if device is not None and use_native and not with_ids:
            from avenir_tpu_torch.ops.csv import CsvDecoder

            decoder = CsvDecoder(encoder, with_labels, device)
        reader = BlockReader(
            pinned=decoder is not None and decoder.device.type == "cuda")

        def decode(block, path):
            ncols = block.first_line().rstrip(b"\r\n").count(delim.encode()) + 1
            route = "python"
            if use_native and ncols > encoder.max_ordinal(with_labels):
                route = "native" if decoder is None else "device"
            with tracer.span("input.encode", parent=parent) as sp:
                ds, route = encode_chunk(route, block, encoder, ncols, delim,
                                         with_labels, with_ids, decoder)
                sp.set("route", route)
                sp.set("rows", ds.num_rows)
            return ds

        rows_out = 0
        for f, offset, i, ds in Job._iter_chunks_retrying(
                conf, input_path, counters, decode, owner=owner, start=start,
                parent=parent, read=reader.read):
            if emit_cursor:
                rows_out += ds.num_rows
                yield ds, {"file": f, "offset": offset, "chunk": i,
                           "rows": rows_out}
            else:
                yield ds


def _read_lines(fh, chunk_rows: int, mine: bool):
    """Up to ``chunk_rows`` non-blank lines from ``fh``'s position: (the
    lines, kept only when ``mine``; how many were read)."""
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
    return raw, nraw


def _read_line_chunk(path: str, off: int, chunk_rows: int, mine: bool):
    """A chunk task's read as lines (:func:`_read_lines`): (the non-blank
    lines, kept only when ``mine``; how many; the offset after them)."""
    with open(path, "rb", buffering=READ_BUFFER) as fh:
        fh.seek(off)
        raw, nraw = _read_lines(fh, chunk_rows, mine)
        return raw, nraw, fh.tell()


class Block:
    """One chunk as :class:`BlockReader` read it: ``rows`` non-blank lines
    in ``nbytes`` bytes.  ``packed`` (uint8) holds ``starts``, each row's
    offset and after them the offset just past the last row's line (int64,
    ``rows + 1``), from byte 0, and the bytes from ``data_off``; ``tensor``
    is the same memory as a torch tensor (pinned where the reader is).
    Valid until the reader's next read."""

    def __init__(self, packed: np.ndarray, tensor, data_off: int, rows: int,
                 nbytes: int):
        self.packed, self.tensor = packed, tensor
        self.data_off, self.rows, self.nbytes = data_off, rows, nbytes

    @property
    def data(self) -> np.ndarray:
        return self.packed[self.data_off:self.data_off + self.nbytes]

    @property
    def starts(self) -> np.ndarray:
        return self.packed[:8 * (self.rows + 1)].view(np.int64)

    def first_line(self) -> bytes:
        """The first row's line with its newline, as :func:`_read_lines`
        reads it."""
        s, e = int(self.starts[0]), int(self.starts[1])
        nl = np.flatnonzero(self.data[s:e] == 10)
        return self.data[s:s + int(nl[0]) + 1 if nl.size else e].tobytes()

    def lines(self) -> List[bytes]:
        """Every row's line, :func:`_read_lines`' list for the chunk."""
        text = self.data.tobytes()
        starts = self.starts[:-1].tolist()
        out = []
        for s in starts:
            e = text.find(b"\n", s)
            out.append(text[s:e + 1 if e >= 0 else len(text)])
        return out


class BlockReader:
    """The encoded stream's chunk read: a task's bytes from its offset, in
    large reads (``readinto``) into one buffer that the stream reuses and
    grows, walked for the offsets of their non-blank lines
    (``runtime/native.py::walk``, without the interpreter lock) up to
    ``stream.chunk.rows`` of them: the lines :func:`_read_lines` reads, at
    the same boundaries.  Bytes read past the chunk's last line are dropped
    (the next task reads from its own offset).  The buffer is a
    :class:`Block`'s layout, pinned with ``pinned`` so that one copy takes
    a block to a card."""

    FIRST_READ = 1 << 20                 # bytes, before a row's size is known

    def __init__(self, pinned: bool = False):
        self.pinned = pinned
        self._packed = np.zeros(0, np.uint8)
        self._tensor = None
        self._rows_cap = 0                # row offsets the buffer holds
        self._bytes_cap = 0
        self._row_bytes = 0.0             # a row's mean bytes, last chunk

    @property
    def _data_off(self) -> int:
        return -(-8 * self._rows_cap // 16) * 16

    def _reserve(self, rows_cap: int, bytes_cap: int, rows: int,
                 fill: int) -> None:
        """Room for ``rows_cap`` offsets and ``bytes_cap`` bytes, keeping
        the first ``rows`` offsets and ``fill`` bytes."""
        if rows_cap <= self._rows_cap and bytes_cap <= self._bytes_cap:
            return
        new_rows = max(rows_cap, self._rows_cap)
        new_bytes = max(bytes_cap, self._bytes_cap)
        if new_bytes > self._bytes_cap:
            new_bytes = max(new_bytes, self._bytes_cap * 5 // 4)
        off = -(-8 * new_rows // 16) * 16
        if self.pinned:
            import torch

            tensor = torch.empty(off + new_bytes, dtype=torch.uint8,
                                 pin_memory=True)
            packed = tensor.numpy()
        else:
            tensor, packed = None, np.empty(off + new_bytes, np.uint8)
        packed[:8 * rows] = self._packed[:8 * rows]
        packed[off:off + fill] = self._packed[
            self._data_off:self._data_off + fill]
        self._packed, self._tensor = packed, tensor
        self._rows_cap, self._bytes_cap = new_rows, new_bytes

    def read(self, path: str, off: int, chunk_rows: int, mine: bool):
        """(the chunk's :class:`Block`, kept only when ``mine``; its rows;
        the offset after its last line) from ``path`` at ``off``."""
        from avenir_tpu_torch.runtime import native

        fill = pos = rows = 0
        eof = False
        with open(path, "rb", buffering=0) as fh:
            size = os.fstat(fh.fileno()).st_size
            fh.seek(off)
            while True:
                if fill > pos or eof:
                    # at most one offset a byte walked: never past the room
                    self._reserve(min(chunk_rows, rows + fill - pos) + 1, 0,
                                  rows, fill)
                    data_off = self._data_off
                    rows, pos = native.walk(
                        self._packed[data_off:], fill, pos, rows,
                        min(chunk_rows, self._rows_cap - 1),
                        eof, self._packed[:8 * self._rows_cap].view(np.int64))
                if rows == chunk_rows or eof:
                    break
                row_bytes = pos / rows if rows else self._row_bytes
                want = (int(row_bytes * (chunk_rows - rows) * 1.02)
                        + (1 << 16) if row_bytes else self.FIRST_READ)
                # no room for bytes the file does not hold
                want = min(want, max(size - off - fill, 1 << 16))
                self._reserve(0, fill + want, rows, fill)
                data_off = self._data_off
                got = fh.readinto(memoryview(self._packed)[
                    data_off + fill:data_off + fill + want])
                eof = not got
                fill += got or 0
        if rows:
            self._row_bytes = pos / rows
        self._reserve(rows + 1, 0, rows, fill)
        self._packed[:8 * (rows + 1)].view(np.int64)[rows] = pos
        if not (rows and mine):
            return None, rows, off + pos
        return Block(self._packed, self._tensor, self._data_off, rows,
                     pos), rows, off + pos


def encode_chunk(route: str, block: Block, encoder: DatasetEncoder,
                 ncols: int, delim: str, with_labels: bool,
                 with_ids: bool = True, decoder=None):
    """One chunk's block encoded by ``route`` → (dataset, the route that
    encoded it): ``device`` (``decoder``, an ``ops/csv.py::CsvDecoder``:
    the codes, labels and continuous values made on its device; a chunk it
    refuses is encoded natively), ``native``
    (``runtime/native.py::encode_bytes`` over the block where it lies) or
    ``python`` (the CSV parse of the block's lines and
    ``DatasetEncoder.transform``).  ``encode_chunk.rows_device``,
    ``rows_native`` and ``rows_python`` count the rows each route has
    encoded in this process, ``encode_chunk.chunks_refused`` the chunks the
    device route refused."""
    from avenir_tpu_torch.core.csv_io import read_csv_string
    from avenir_tpu_torch.runtime import native

    if route == "device":
        import torch

        got = decoder(block.tensor if block.tensor is not None
                      else torch.from_numpy(block.packed), block.rows,
                      block.data_off, block.nbytes, ncols, delim)
        if got is not None:
            codes, labels, cont = got
            encode_chunk.rows_device += block.rows
            return EncodedDataset(
                codes=codes, cont=cont, labels=labels, ids=None,
                n_bins=np.array([encoder.n_bins[f.ordinal]
                                 for f in encoder.binned_fields], np.int32),
                class_values=list(encoder.class_values),
                binned_ordinals=[f.ordinal for f in encoder.binned_fields],
                cont_ordinals=[f.ordinal for f in encoder.cont_fields]), \
                route
        encode_chunk.chunks_refused += 1
        route = "native"
    if route == "native":
        ds = native.encode_bytes(block.data, encoder, ncols=ncols,
                                 delim=delim, with_labels=with_labels,
                                 with_ids=with_ids)
        encode_chunk.rows_native += ds.num_rows
        return ds, route
    rows = read_csv_string(b"".join(block.lines()).decode(), delim=delim)
    ds = encoder.transform(rows, with_labels=with_labels)
    if not with_ids:
        ds = dataclasses.replace(ds, ids=None)
    encode_chunk.rows_python += ds.num_rows
    return ds, route


encode_chunk.rows_device = 0
encode_chunk.rows_native = 0
encode_chunk.rows_python = 0
encode_chunk.chunks_refused = 0


class StreamCheckpointer:
    """Mid-stream durability for the streamed count jobs; port of the JAX
    package's ``StreamCheckpointer`` with its on-disk snapshots, so each
    package resumes the other's.

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
      (:meth:`run_id_from_conf`);
    - ``shard.reshard.on.restore``: a snapshot folded under a mesh
      topology (a sharded seam sharing the directory) is re-keyed for this
      unsharded fold (``checkpoint/reshard.py``, journaled
      ``checkpoint.reshard``) instead of refused.

    A snapshot is {accumulator totals, cursor (file, offset, chunk), rows,
    run}.  The totals are int64 (or float64) host arrays, so a resumed
    run's part file is byte-identical to an uninterrupted one.  After a
    successful run :meth:`finish` removes the snapshots, and the directory
    once it is empty.  Each save and restore journals ``checkpoint.save``
    / ``checkpoint.restore`` (with tracing on).

    In a fleet each process snapshots its own partials and cursor under
    ``<dir>/proc-NNN-of-NNN/`` (``parent_dir`` is the shared root), tagged
    with the run id (``RUN_TAG``); a subdirectory tagged by another run is
    refused.  Construction errors are held (``defer_errors``) and pass
    through one collective (:meth:`_handshake_errors`), so a failure on
    any process raises on all of them and no peer stalls; the end-of-run
    sweep removes only subdirectories of the same run."""

    def __init__(self, directory: str, interval_chunks: int = 8,
                 resume: bool = False, crash_after_chunks: int = 0,
                 parent_dir: Optional[str] = None, run_id: str = "",
                 defer_errors: bool = False, reshard: bool = False):
        from avenir_tpu_torch.ops import agg
        from avenir_tpu_torch.utils.checkpoint import CheckpointManager

        self.directory = directory
        self.parent_dir = parent_dir         # a fleet's shared root
        self.run_id = run_id
        self.interval = max(int(interval_chunks), 1)
        self.crash_after = int(crash_after_chunks)
        self.accumulator = agg.Accumulator()
        self.base_rows = 0
        self.start: Optional[dict] = None      # cursor to resume from
        self._consumed = 0                     # chunks counted in this run
        self.error: Optional[str] = None
        self.mgr = None
        try:
            if parent_dir is not None and run_id:
                # a subdirectory tagged by another run is refused before
                # CheckpointManager's recovery touches it
                os.makedirs(directory, exist_ok=True)
                prior = self._read_tag(directory)
                if prior is not None and prior != run_id:
                    self.error = (
                        f"checkpoint subdirectory {directory!r} is tagged "
                        f"with run id {prior!r}, not this run's {run_id!r} "
                        f"— a checkpoint root is exclusive to one run "
                        f"identity; clear the directory or point "
                        f"stream.checkpoint.dir elsewhere")
                else:
                    with open(os.path.join(directory, "RUN_TAG"), "w") as fh:
                        fh.write(run_id)
            if self.error is None:
                self.mgr = CheckpointManager(directory, keep=2)
            if resume and self.error is None:
                self._restore(reshard)
        except Exception as e:
            # any construction failure is deferrable: a process raising
            # before the handshake would strand its peers
            self.error = (f"checkpointer construction in {directory!r} "
                          f"failed: {type(e).__name__}: {e}")
        if self.error and not defer_errors:
            raise ConfigError(self.error)

    def _restore(self, reshard: bool) -> None:
        """Load the latest snapshot, or set :attr:`error`: a snapshot of
        another run, or one folded under a mesh topology without the
        ``shard.reshard.on.restore`` gate, is refused, never folded."""
        from avenir_tpu_torch.checkpoint import reshard as _reshard

        try:
            state = self.mgr.restore()
        except Exception as e:
            self.error = (f"checkpoint restore from {self.directory!r} "
                          f"failed: {type(e).__name__}: {e}")
            return
        if state is None:
            return
        snap_run = str(state.get("run", ""))
        if snap_run and self.run_id and snap_run != self.run_id:
            self.error = (
                f"snapshot in {self.directory!r} was written by run "
                f"{snap_run!r}, not this run {self.run_id!r} — "
                f"the configuration changed since the "
                f"checkpoint; clear the directory and re-run")
            return
        try:
            snap_sfx = _reshard.snapshot_suffix(state)
        except _reshard.ReshardError as e:
            self.error = str(e)
            return
        if snap_sfx:
            if not reshard:
                self.error = (
                    f"snapshot in {self.directory!r} was folded "
                    f"under mesh topology {snap_sfx!r} but "
                    f"this job folds unsharded — set "
                    f"shard.reshard.on.restore=true to "
                    f"redistribute it, or clear the "
                    f"directory and re-run")
                return
            state, moved = _reshard.reshard_state_tree(state, "")
            _reshard.journal_reshard(snap_sfx, "", len(moved),
                                     directory=self.directory,
                                     run=self.run_id)
        self.accumulator.load(state["acc"])
        self.base_rows = int(state["rows"])
        self.start = {k: state["cursor"][k]
                      for k in ("file", "offset", "chunk")}
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
        durability keys are ignored, as the JAX package ignores them).  In
        a fleet the snapshots are process-scoped: each process owns its
        slice of the chunk stream, so its cursor and partials live in
        ``proc-NNN-of-NNN/``, whose name pins the process count (a
        relaunch at another count finds no snapshot and starts from
        zero, never double-counting)."""
        directory = conf.get("stream.checkpoint.dir")
        if not directory or not conf.get("stream.chunk.rows"):
            return None
        from avenir_tpu_torch.checkpoint.procdir import proc_subdir

        pid, nprocs = Job.process_grid()
        ckpt = cls(proc_subdir(directory),
                   conf.get_int("stream.checkpoint.interval.chunks", 8),
                   conf.get_bool("stream.resume", False),
                   conf.get_int("stream.fault.crash.after.chunks", 0),
                   parent_dir=directory if nprocs > 1 else None,
                   run_id=cls.run_id_from_conf(conf),
                   defer_errors=nprocs > 1,
                   reshard=conf.get_bool("shard.reshard.on.restore", False))
        if nprocs > 1:
            ckpt._handshake_errors(pid)
        return ckpt

    def _handshake_errors(self, pid: int) -> None:
        """Every process enters one collective carrying its construction
        error (or nothing), so a tag conflict or a bad snapshot on any
        process raises on all of them instead of stranding the others in
        the end-of-stream merge."""
        from avenir_tpu_torch.parallel.mesh import all_process_sum_state

        assert pid < 10 ** 3          # proc_subdir bounds the process count
        state = {}
        if self.error:
            state[f"ckpt_err_p{pid:03d}"] = np.frombuffer(
                self.error.encode(), np.uint8).copy()
        folded = all_process_sum_state(state)
        errs = sorted(k for k in folded if k.startswith("ckpt_err_p"))
        if errs:
            peers = ", ".join(k[len("ckpt_err_p"):] for k in errs)
            raise ConfigError(
                f"checkpointer construction failed on process(es) {peers}: "
                + folded[errs[0]].tobytes().decode(errors="replace"))

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
            # fault-injection drill, not a misread key: the RuntimeError is the
            # injected crash itself; a ConfigError would make recovery treat the
            # drill as non-retryable bad configuration
            # graftlint: disable=GL010
            raise RuntimeError(
                f"stream.fault.crash.after.chunks={self.crash_after}: "
                f"injected crash after chunk {cursor['chunk']}")

    @staticmethod
    def _read_tag(directory: str) -> Optional[str]:
        try:
            with open(os.path.join(directory, "RUN_TAG")) as fh:
                return fh.read().strip()
        except OSError:
            return None

    def finish(self) -> None:
        """Remove this run's snapshots after a successful run: only the
        manager's own ``step_*`` and temporary entries, never other files
        in the directory, and the directory itself once it is empty.  In a
        fleet each process clears its own ``proc-*`` subdirectory and
        sweeps those a crashed run of the same run id left at other
        process counts; a subdirectory of another run id (a concurrent
        job sharing the root), or with no tag, is left alone."""
        from avenir_tpu_torch.checkpoint.procdir import is_proc_subdir
        from avenir_tpu_torch.utils.checkpoint import CheckpointManager

        self._remove_tag(self.directory)
        self.mgr.clear()
        root = self.parent_dir or self.directory
        try:
            names = os.listdir(root)
        except FileNotFoundError:
            return
        for name in names:
            sub = os.path.join(root, name)
            if is_proc_subdir(name) and \
                    self.run_id and self._read_tag(sub) == self.run_id:
                # a peer of this run clears its own subdirectory at the
                # same moment: one that vanishes under the sweep is gone
                try:
                    self._remove_tag(sub)
                    CheckpointManager(sub, keep=2).clear()
                except FileNotFoundError:
                    pass
        try:
            os.rmdir(root)                   # only succeeds when empty
        except OSError:
            pass

    @staticmethod
    def _remove_tag(directory: str) -> None:
        try:
            os.remove(os.path.join(directory, "RUN_TAG"))
        except OSError:
            pass
