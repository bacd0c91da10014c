"""Job layer — the reference's ``hadoop jar <ToolClass> -Dconf.path=p in out``
contract; port of the single-process subset of ``avenir_tpu/jobs/base.py``.

A job is a plain object with ``run(conf, input_path, output_path, device)``:
input is a CSV file or a directory of part files, output is written as
``<out>/part-00000``, and the properties and JSON feature schema keep their
reference key names (``feature.schema.file.path``, ``field.delim.regex``,
``stream.chunk.rows``, ...).  ``device`` is ``cuda`` unless the caller asks
for ``cpu``.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Sequence

import numpy as np

from avenir_tpu_torch.core.config import ConfigError, JobConfig
from avenir_tpu_torch.core.csv_io import iter_csv_chunks, read_csv
from avenir_tpu_torch.core.encoding import DatasetEncoder
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
                     encoder: Optional[DatasetEncoder] = None):
        """(encoder, encoded dataset, raw rows) for whole-input jobs."""
        delim = conf.field_delim_regex
        enc = encoder or Job.encoder_for(conf)
        rows = read_input(input_path, delim=delim)
        ds = enc.fit_transform(rows, with_labels=with_labels) if not enc._fitted \
            else enc.transform(rows, with_labels=with_labels)
        return enc, ds, rows

    @staticmethod
    def encode_input_with_lines(conf: JobConfig, input_path: str,
                                with_labels: bool = True,
                                encoder: Optional[DatasetEncoder] = None):
        """(encoder, encoded dataset, input lines) for scoring jobs that echo
        each input line into their output; lines are rejoined from the
        parsed fields with the output delimiter."""
        enc, ds, rows = Job.encode_input(conf, input_path,
                                         with_labels=with_labels, encoder=encoder)
        return enc, ds, [conf.field_delim.join(str(v) for v in row)
                         for row in rows]

    def encoded_data_source(self, conf: JobConfig, input_path: str,
                            counters: Counters, with_labels: bool = True):
        """(encoder, data, rows_fn) for count jobs whose model ``fit`` takes
        one EncodedDataset or a chunk iterable.

        With ``stream.chunk.rows`` set, ``data`` is a lazy stream of encoded
        chunks of that many rows (the schema must declare every vocabulary
        and bin range, as the reference's mappers require); otherwise it is
        the whole encoded input.  ``rows_fn()`` reports rows processed —
        call it only after ``fit`` has consumed the stream."""
        chunk_rows = conf.get_int("stream.chunk.rows")
        if chunk_rows:
            enc = self.encoder_for(conf)
            box = {"n": 0}

            def stream():
                for rows in iter_input_chunks(input_path, chunk_rows,
                                              delim=conf.field_delim_regex):
                    ds = enc.transform(rows, with_labels=with_labels)
                    box["n"] += ds.num_rows
                    counters.increment("Stream", "Chunks")
                    yield ds

            return enc, stream(), lambda: box["n"]
        enc, ds, _rows = self.encode_input(conf, input_path,
                                           with_labels=with_labels)
        return enc, ds, lambda: ds.num_rows
