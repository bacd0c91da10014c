"""CSV record I/O — chunked readers/writers for the CSV-in/CSV-out contract.

The reference's I/O contract is CSV text lines in, CSV text lines out, with
record semantics supplied by the JSON feature schema. This module reads CSV
into column-major numpy string arrays in bounded-size chunks (the analog of
HDFS-block-sized mapper inputs) so datasets stream through fixed-shape device
batches.

This is the portable reader; ``runtime/native.py`` parses the same bytes
natively where the schema is complete, with the same codes.
"""

from __future__ import annotations

import io
from typing import Iterator, List, Optional, Sequence, TextIO, Union

import numpy as np


def iter_csv_chunks(
    source: Union[str, TextIO],
    chunk_rows: int = 1_000_000,
    delim: str = ",",
) -> Iterator[np.ndarray]:
    """Yield 2-D object arrays of string fields, ``chunk_rows`` rows at a time.

    ``source`` is a file path or an open text handle. Rows shorter than the
    first row raise and blank lines are skipped — ragged records are a data error, as in the reference
    (mappers would throw ``ArrayIndexOutOfBounds``).
    """
    own = isinstance(source, str)
    fh: TextIO = open(source, "r") if own else source
    try:
        width: Optional[int] = None
        rows: List[List[str]] = []
        for line in fh:
            line = line.rstrip("\n").rstrip("\r")
            if not line:
                continue
            parts = line.split(delim)
            if width is None:
                width = len(parts)
            elif len(parts) != width:
                raise ValueError(f"ragged CSV record: expected {width} fields, got {len(parts)}: {line!r}")
            rows.append(parts)
            if len(rows) >= chunk_rows:
                yield np.array(rows, dtype=object)
                rows = []
        if rows:
            yield np.array(rows, dtype=object)
    finally:
        if own:
            fh.close()


def read_csv(source: Union[str, TextIO], delim: str = ",") -> np.ndarray:
    """Read an entire CSV source into one 2-D object array of strings."""
    chunks = list(iter_csv_chunks(source, chunk_rows=1 << 30, delim=delim))
    if not chunks:
        return np.empty((0, 0), dtype=object)
    return np.concatenate(chunks, axis=0) if len(chunks) > 1 else chunks[0]


def read_csv_string(text: str, delim: str = ",") -> np.ndarray:
    return read_csv(io.StringIO(text), delim=delim)


def write_csv(path_or_handle: Union[str, TextIO], rows: Sequence[Sequence], delim: str = ",") -> None:
    own = isinstance(path_or_handle, str)
    fh: TextIO = open(path_or_handle, "w") if own else path_or_handle
    try:
        for row in rows:
            fh.write(delim.join("" if v is None else str(v) for v in row))
            fh.write("\n")
    finally:
        if own:
            fh.close()
