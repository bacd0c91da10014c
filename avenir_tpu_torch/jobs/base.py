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
(``runtime/feeder.py``).
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


def refuse_stream_checkpoint(conf: JobConfig, job: str) -> None:
    """Raise where the JAX package would checkpoint the chunk stream: with
    ``stream.checkpoint.dir`` and ``stream.chunk.rows`` both set (the
    condition of its ``StreamCheckpointer.from_conf``), snapshots, resume
    and the injected crash are not ported yet.  Without either key the JAX
    package ignores ``stream.resume`` and ``stream.fault.*`` too, so the
    job runs."""
    if conf.get("stream.checkpoint.dir") and conf.get("stream.chunk.rows"):
        raise NotImplementedError(
            f"{job}: stream checkpoints (stream.checkpoint.dir with "
            f"stream.chunk.rows) are not ported yet (ROADMAP.md, Queue 1 "
            f"item 5)")


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
        self.device = resolve_device(device)
        counters = Counters()
        self.execute(conf, input_path, output_path, counters)
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
                            counters: Counters, with_labels: bool = True):
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
        ``fit`` has consumed the stream."""
        if conf.get("stream.chunk.rows"):
            enc = self.encoder_for(conf)
            box = {"n": 0}
            pairs = self.iter_encoded_retrying(
                conf, input_path, enc, counters, with_labels=with_labels,
                emit_cursor=True)
            depth = conf.get_int("stream.prefetch.depth", 2)
            if depth > 0:
                from avenir_tpu_torch.runtime.feeder import DeviceFeeder

                pairs = DeviceFeeder(pairs, depth=depth, device=self.device)

            def consume():
                for ds, cur in pairs:
                    box["n"] = cur["rows"]
                    yield ds

            return enc, Job._chunk_telemetry(consume(), counters), \
                lambda: box["n"]
        enc, ds, _rows = self.encode_input(conf, input_path,
                                           with_labels=with_labels,
                                           need_rows=False)
        return enc, ds, lambda: ds.num_rows

    @staticmethod
    def _chunk_telemetry(chunks, counters: Counters):
        """Pass a streamed chunk source through, counting
        ``Telemetry::recompiles``: the chunks whose (codes, labels, cont)
        shapes differ from every shape seen before, after the first — a
        steady stream counts at most one, for its ragged tail."""
        seen = set()
        for ds in chunks:
            key = tuple((tuple(a.shape), str(a.dtype))
                        for a in (ds.codes, ds.labels, ds.cont)
                        if a is not None)
            if key not in seen:
                if seen:
                    counters.increment("Telemetry", "recompiles")
                seen.add(key)
            yield ds

    @staticmethod
    def _iter_chunks_retrying(conf: JobConfig, input_path: str,
                              counters: Counters, decode, owner=None):
        """The chunk-scan and retry engine behind both streaming readers.

        Scans each input file by (byte offset, global chunk index); the
        retried task re-opens, re-seeks, re-reads and re-decodes one chunk
        (``decode(raw_lines, path)`` runs inside the task, so a decode fault
        is retried with the read; policy from ``mapred.map.max.attempts``).
        The end of each file is found by one more task that reads nothing,
        as in the JAX package, so ``Task::attempts`` counts it too.
        ``owner(chunk_index)`` assigns chunks: chunks it refuses are scanned
        for their boundaries but never decoded or yielded.  Yields
        ``(file, offset_after, chunk_index_after, payload)``."""
        from avenir_tpu_torch.utils.retry import RetryPolicy, run_with_retry

        policy = RetryPolicy.from_conf(conf)
        chunk_rows = conf.get_int("stream.chunk.rows", 1_000_000)
        i = 0
        for f in input_files(input_path):
            offset = 0
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
                              emit_cursor: bool = False, owner=None):
        """Encoded chunks of ``stream.chunk.rows`` rows with per-chunk retry:
        the retried task is the read, parse and encode of one chunk,
        addressed by (file, byte offset) as a Hadoop map task is by its
        split.  The native encoder parses a chunk where the schema is
        complete, the delimiter one character and the chunk's rows wide
        enough; else the Python one does (which raises ConfigError, not
        retried, on an incomplete schema).

        ``emit_cursor`` yields ``(chunk, cursor)`` pairs, the cursor
        ``{"file", "offset", "chunk", "rows"}`` being the position after
        the chunk and the rows yielded so far."""
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
                conf, input_path, counters, decode, owner=owner):
            if emit_cursor:
                rows_out += ds.num_rows
                yield ds, {"file": f, "offset": offset, "chunk": i,
                           "rows": rows_out}
            else:
                yield ds
