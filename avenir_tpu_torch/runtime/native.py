"""ctypes bridge to the native CSV encoder (``runtime/native/csv_encode.cpp``)
— port of ``avenir_tpu/runtime/native.py``.

:func:`encode_bytes` turns CSV bytes into an :class:`EncodedDataset` with
the semantics of ``DatasetEncoder.transform`` (the C++ source is the JAX
package's, with one function more: :func:`walk`, the chunk reader's line
walk).  The library is built with ``g++`` on first use into
``avenir_tpu_torch/build/libavenir_native-<hash>.so``, the hash taken over
the source, so an edited source is never served from a stale build.

Unlike the JAX package, a failed build raises, with the compiler's output
in the message: no caller falls back to the Python encoder because the
library is missing.  The callers still choose the Python encoder where the
input, not the build, asks for it (an incomplete schema, a file narrower
than the schema, a delimiter longer than one character, lines that are not
UTF-8) — ``jobs/base.py`` makes those choices as the JAX package does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import List, Optional

import numpy as np

from avenir_tpu_torch.ops._build import BUILD

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native",
                   "csv_encode.cpp")
CXX = "g++"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-pthread", "-std=c++17"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_ERRORS = {
    -1: "ragged CSV record",
    -2: "unparseable numeric field",
    -3: "unknown class label",
    -4: "row buffer overflow",
}

KIND_CATEGORICAL, KIND_BINNED_NUMERIC, KIND_CONTINUOUS, KIND_LABEL, KIND_ID = \
    0, 1, 2, 3, 4


def lib_path() -> str:
    """Where the library for the current source lives."""
    with open(SRC, "rb") as fh:
        tag = hashlib.sha256(fh.read()).hexdigest()[:12]
    return os.path.join(BUILD, f"libavenir_native-{tag}.so")


def build() -> str:
    """Compile the encoder unless its library exists; returns its path.

    Processes that reach first use together take a file lock, compile to a
    temporary path, publish with an atomic rename, and re-check under the
    lock, so the one that waited loads what the first built.  A failed
    build leaves no partial library and raises with the compiler's
    output."""
    from avenir_tpu_torch.utils.locking import FileLock

    lib = lib_path()
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD, exist_ok=True)
    with FileLock(lib, timeout_s=150.0):
        if os.path.exists(lib):
            return lib
        tmp = f"{lib}.{os.getpid()}.build"
        try:
            proc = subprocess.run([CXX, *CXX_FLAGS, "-o", tmp, SRC],
                                  capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.SubprocessError) as e:
            raise RuntimeError(f"native encoder build failed: {CXX} could "
                               f"not run: {e}") from e
        if proc.returncode != 0:
            try:
                os.unlink(tmp)
            except FileNotFoundError:
                pass
            raise RuntimeError(
                f"native encoder build failed ({CXX} exit {proc.returncode}) "
                f"on {SRC}:\n{proc.stderr}")
        os.replace(tmp, lib)
    return lib


def load() -> ctypes.CDLL:
    """The encoder library with its entry points typed, built first if
    needed; raises if it cannot be built."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        # compile-once native-library build: the lock is held across
        # build() so exactly one thread compiles; the I/O under the lock is
        # the point
        # graftlint: disable=GL006
        lib = ctypes.CDLL(build())
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.avenir_csv_encode.restype = ctypes.c_long
        lib.avenir_csv_encode.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_char, ctypes.c_int32,
            i32p, i32p,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64),
            i32p, ctypes.c_int32, ctypes.c_char_p,
            i32p, ctypes.c_long,
            ctypes.POINTER(ctypes.c_float), ctypes.c_long,
            i32p,
            ctypes.POINTER(ctypes.c_int64), i32p,
            ctypes.c_long, ctypes.POINTER(ctypes.c_long),
        ]
        lib.avenir_csv_encode_mt.restype = ctypes.c_long
        lib.avenir_csv_encode_mt.argtypes = \
            lib.avenir_csv_encode.argtypes + [ctypes.c_int32]
        lib.avenir_csv_count_rows.restype = ctypes.c_long
        lib.avenir_csv_walk.restype = ctypes.c_long
        lib.avenir_csv_walk.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_long, ctypes.c_long,
            ctypes.c_long, ctypes.c_int32, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_long),
        ]
        lib.avenir_csv_count_rows.argtypes = [ctypes.c_char_p, ctypes.c_long]
        lib.avenir_gather_ids_u32.restype = ctypes.c_int32
        lib.avenir_gather_ids_u32.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            i32p, ctypes.c_long, ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_int32,
        ]
        _lib = lib
        return lib


def build_error() -> Optional[str]:
    """None once the encoder library is built and loaded (building it on
    first call), else the build failure's message.  Only a report: the
    encode path itself raises on a failed build."""
    try:
        load()
    except (RuntimeError, OSError) as e:
        return str(e)
    return None


def is_available() -> bool:
    """Whether the encoder library builds and loads."""
    return build_error() is None


def _specs_from_encoder(encoder, with_labels: bool = True,
                        with_ids: bool = True) -> tuple:
    """Flatten a fitted DatasetEncoder into the parallel spec arrays."""
    kinds: List[int] = []
    ordinals: List[int] = []
    widths: List[float] = []
    offsets: List[int] = []
    nbins: List[int] = []
    vocab_parts: List[bytes] = []
    for f in encoder.binned_fields:
        ordinals.append(f.ordinal)
        if f.is_categorical:
            kinds.append(KIND_CATEGORICAL)
            widths.append(0.0)
            offsets.append(0)
            nbins.append(encoder.n_bins[f.ordinal])
            vocab = sorted(encoder.vocab[f.ordinal].items(), key=lambda kv: kv[1])
            vocab_parts.append(
                b"".join(v.encode() + b"\x1f" for v, _ in vocab) + b"\x1e")
        else:
            kinds.append(KIND_BINNED_NUMERIC)
            widths.append(float(f.bucket_width))
            offsets.append(int(encoder.bin_offset[f.ordinal]))
            nbins.append(encoder.n_bins[f.ordinal])
    for f in encoder.cont_fields:
        kinds.append(KIND_CONTINUOUS)
        ordinals.append(f.ordinal)
        widths.append(0.0)
        offsets.append(0)
        nbins.append(0)
    if with_labels and encoder.class_field is not None and encoder.class_values:
        kinds.append(KIND_LABEL)
        ordinals.append(encoder.class_field.ordinal)
        widths.append(0.0)
        offsets.append(0)
        nbins.append(len(encoder.class_values))
        vocab_parts.append(
            b"".join(v.encode() + b"\x1f" for v in encoder.class_values) + b"\x1e")
    if with_ids and encoder.id_field is not None:
        kinds.append(KIND_ID)
        ordinals.append(encoder.id_field.ordinal)
        widths.append(0.0)
        offsets.append(0)
        nbins.append(0)
    return (np.asarray(kinds, np.int32), np.asarray(ordinals, np.int32),
            np.asarray(widths, np.float64), np.asarray(offsets, np.int64),
            np.asarray(nbins, np.int32), b"".join(vocab_parts))


def threads() -> int:
    """The encoder's default worker threads: the process's compute
    threads where ``OMP_NUM_THREADS`` states them, as it does for
    PyTorch's pool, else the CPU count; at most 8."""
    stated = os.environ.get("OMP_NUM_THREADS", "")
    n = int(stated) if stated.isdigit() and int(stated) > 0 else (
        os.cpu_count() or 1)
    return min(n, 8)


def walk(buf: np.ndarray, length: int, pos: int, rows: int, max_rows: int,
         at_eof: bool, starts: np.ndarray) -> tuple:
    """The chunk reader's line walk over ``buf[pos:length]`` (a uint8
    array): the offset of each non-blank line (one ``bytes.strip()`` does
    not empty) appended to ``starts[rows:]``, an int64 array with room for
    ``max_rows``, until ``max_rows`` are held or the bytes run out; a line
    with no newline counts only ``at_eof``.  Returns (rows, the offset just
    after the last line walked).  Runs without the interpreter lock."""
    if not (buf.dtype == np.uint8 and starts.dtype == np.int64
            and buf.flags.c_contiguous and starts.flags.c_contiguous
            and 0 <= pos <= length <= buf.size and 0 <= rows <= max_rows
            and max_rows <= starts.size):
        raise ValueError("walk: a contiguous uint8 buffer and an int64 "
                         "starts array with room for max_rows needed")
    end = ctypes.c_long(0)
    got = load().avenir_csv_walk(buf.ctypes.data, length, pos, rows,
                                 max_rows, int(at_eof), starts.ctypes.data,
                                 ctypes.byref(end))
    return int(got), end.value


def encode_bytes(data, encoder, ncols: int, delim: str = ",",
                 with_labels: bool = True, nthreads: Optional[int] = None,
                 with_ids: bool = True):
    """CSV bytes → EncodedDataset through the native encoder.

    ``data`` is ``bytes`` or a contiguous uint8 numpy array (a chunk
    reader's block, parsed where it lies).  ``encoder`` must be fitted (or
    its schema complete); raises ValueError on data errors (the Python
    path's conditions, with the absolute row) and RuntimeError if the
    library cannot be built.  Buffers over 1 MiB are parsed by
    ``nthreads`` worker threads (default: :func:`threads`), with output
    identical to one thread's.  ``with_ids=False`` leaves the id column
    unread (``ids`` None)."""
    from avenir_tpu_torch.core.encoding import EncodedDataset

    lib = load()
    if not isinstance(data, bytes):
        if not (isinstance(data, np.ndarray) and data.dtype == np.uint8
                and data.ndim == 1 and data.flags.c_contiguous):
            raise TypeError("encode_bytes takes bytes or a contiguous uint8 "
                            "array")
        keep = data                       # alive while the library reads it
        data = keep.ctypes.data_as(ctypes.c_char_p)
        nbytes = keep.size
    else:
        keep, nbytes = data, len(data)
    kinds, ordinals, widths, offsets, nbins, vocab_blob = \
        _specs_from_encoder(encoder, with_labels=with_labels,
                            with_ids=with_ids)
    n_binned = len(encoder.binned_fields)
    n_cont = len(encoder.cont_fields)
    max_rows = lib.avenir_csv_count_rows(data, nbytes)
    codes = np.zeros((max_rows, max(n_binned, 1)), np.int32)
    cont = np.zeros((max_rows, max(n_cont, 1)), np.float32)
    has_labels = with_labels and encoder.class_field is not None and \
        bool(encoder.class_values)
    labels = np.zeros(max_rows, np.int32) if has_labels else None
    has_ids = with_ids and encoder.id_field is not None
    id_off = np.zeros(max_rows, np.int64) if has_ids else None
    id_len = np.zeros(max_rows, np.int32) if has_ids else None
    err_row = ctypes.c_long(0)
    if nthreads is None:
        nthreads = threads()
    i32p = ctypes.POINTER(ctypes.c_int32)
    rows = lib.avenir_csv_encode_mt(
        data, nbytes, ctypes.c_char(delim.encode()), ncols,
        kinds.ctypes.data_as(i32p),
        ordinals.ctypes.data_as(i32p),
        widths.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        nbins.ctypes.data_as(i32p),
        len(kinds), vocab_blob,
        codes.ctypes.data_as(i32p), max(n_binned, 1),
        cont.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), max(n_cont, 1),
        labels.ctypes.data_as(i32p) if labels is not None else None,
        (id_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
         if id_off is not None else None),
        id_len.ctypes.data_as(i32p) if id_len is not None else None,
        max_rows, ctypes.byref(err_row), nthreads)
    if rows < 0:
        raise ValueError(
            f"{_ERRORS.get(rows, 'parse error')} at row {err_row.value}")
    ids = None
    if has_ids and rows:
        # the id byte ranges gathered natively and widened to UCS4 straight
        # into U-dtype memory (numpy drops the trailing nulls); elements
        # compare equal to str
        off = id_off[:rows]
        ln = id_len[:rows]
        maxlen = max(int(ln.max()), 1)
        chars = np.empty((rows, maxlen), np.uint32)
        ascii_ok = lib.avenir_gather_ids_u32(
            data, off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ln.ctypes.data_as(i32p), rows,
            chars.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), maxlen)
        if ascii_ok:
            ids = chars.view(f"<U{maxlen}")[:, 0]
        else:                            # non-ASCII ids: decode each
            ids = np.array([bytes(keep[off[i]:off[i] + ln[i]]).decode()
                            for i in range(rows)], dtype=object)
    return EncodedDataset(
        codes=codes[:rows, :n_binned] if n_binned else np.zeros((rows, 0), np.int32),
        cont=cont[:rows, :n_cont] if n_cont else np.zeros((rows, 0), np.float32),
        labels=labels[:rows] if labels is not None else None,
        ids=ids,
        n_bins=np.array([encoder.n_bins[f.ordinal] for f in encoder.binned_fields],
                        np.int32),
        class_values=list(encoder.class_values),
        binned_ordinals=[f.ordinal for f in encoder.binned_fields],
        cont_ordinals=[f.ordinal for f in encoder.cont_fields],
    )


def iter_encoded_native(path: str, encoder, ncols: int, delim: str = ",",
                        chunk_bytes: int = 64 << 20, with_labels: bool = True):
    """Stream a CSV file through the native encoder in newline-aligned byte
    chunks of about ``chunk_bytes``."""
    with open(path, "rb") as fh:
        carry = b""
        while True:
            block = fh.read(chunk_bytes)
            if not block:
                if carry.strip():
                    yield encode_bytes(carry, encoder, ncols, delim, with_labels)
                return
            block = carry + block
            cut = block.rfind(b"\n")
            if cut < 0:
                carry = block
                continue
            carry = block[cut + 1:]
            yield encode_bytes(block[:cut + 1], encoder, ncols, delim, with_labels)
