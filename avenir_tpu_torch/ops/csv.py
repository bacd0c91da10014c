"""A CSV chunk encoded on the card: the rows of one byte block split into
fields and encoded by the schema's rules, the native encoder's
(``runtime/native/csv_encode.cpp`` ``encode_range``) bit for bit.

:func:`encode_csv` is the wrapper.  On CUDA it copies the chunk reader's
block (``jobs/base.py::BlockReader``: the row offsets, then the bytes) to
the card in one copy and launches ``csrc/csv_encode.cu``, counted in
``encode_csv.launches``; on the CPU it runs the plain version,
:func:`csv_encode_ref`.  Both take each row's fields as the native encoder
does, with its fast paths only:

- categorical: the field's bytes against the vocabulary; a miss is the
  out-of-vocabulary slot ``n_bins - 1``;
- binned numeric: ``[+-]digits[.digits]``, at most 15 digits, parsed as
  ``num / 10^frac`` in float64 (both exact, so one correctly rounded
  division: ``strtod``'s value), then ``floor(v / bucket_width) -
  bin_offset`` clipped to ``[0, n_bins - 1]``;
- continuous: the same parse, rounded to float32;
- label: a vocabulary hit.

Anything else refuses the whole chunk (the result is None): a row with
another field count than the first row's, a numeric field outside the fast
path (an exponent, more than 15 digits, a space, an empty field), a floor
outside ±2^62, an unknown label, a chunk whose shared memory a block
(:func:`smem_bytes`: the schema's tables, the widest tile's bytes and a
tile's staged outputs) would exceed ``SMEM_MAX``, or a delimiter that is a
line end.  The caller encodes a refused chunk with the
native encoder, which gives its values or its error.  Nothing is built or
loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from avenir_tpu_torch.runtime import native

TILE_ROWS = 128                # rows a block of the kernel takes, one a thread
SMEM_MAX = 227 << 10           # an H100 block's shared memory, opted in
NUM_MAX_BYTES = 17             # a numeric field the fast path takes: ±, 15 digits, .
_FLOOR_MAX = 2.0 ** 62         # a bin's floor the fast path takes, either side

_COUNT_LOCK = threading.Lock()

Encoded = Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]


def _align(n: int, to: int) -> int:
    return -(-n // to) * to


class CsvSpec:
    """An encoder's columns as the kernel reads them: each consumed column's
    kind, ordinal, output slot, bucket width, bin offset, bin count and
    vocabulary, in ``runtime/native.py::_specs_from_encoder``'s order (ids
    are not read)."""

    def __init__(self, encoder, with_labels: bool = True):
        kinds, ordinals, widths, offsets, nbins, blob = \
            native._specs_from_encoder(encoder, with_labels=with_labels,
                                       with_ids=False)
        self.kinds = [int(k) for k in kinds]
        self.ordinals = [int(o) for o in ordinals]
        self.widths = [float(w) for w in widths]
        self.offsets = [int(o) for o in offsets]
        self.nbins = [int(b) for b in nbins]
        groups = blob.split(b"\x1e")[:-1]
        it = iter(groups)
        self.vocabs: List[Optional[List[bytes]]] = [
            next(it).split(b"\x1f")[:-1]
            if k in (native.KIND_CATEGORICAL, native.KIND_LABEL) else None
            for k in self.kinds]
        self.slots, nb, nc = [], 0, 0
        for k in self.kinds:
            if k in (native.KIND_CATEGORICAL, native.KIND_BINNED_NUMERIC):
                self.slots.append(nb)
                nb += 1
            elif k == native.KIND_CONTINUOUS:
                self.slots.append(nc)
                nc += 1
            else:
                self.slots.append(0)
        self.n_binned, self.n_cont = nb, nc
        self.has_labels = native.KIND_LABEL in self.kinds
        self._meta: Dict[int, np.ndarray] = {}
        self._device_meta: Dict[tuple, torch.Tensor] = {}

    def meta(self, ncols: int) -> np.ndarray:
        """The tables the kernel loads into shared memory, for rows of
        ``ncols`` fields (uint8, a multiple of 16 bytes): int32 words
        ``col[ncols]`` (the spec reading each field, -1 for none), ``spec[
        nspec][5]`` (kind, slot, first vocabulary entry, entries, bins),
        ``entry[nvocab][2]`` (byte offset, length); then, 8-aligned,
        float64 ``width[nspec]`` and int64 ``offset[nspec]``; then the
        vocabulary's bytes."""
        got = self._meta.get(ncols)
        if got is not None:
            return got
        nspec = len(self.kinds)
        entries = [v for vs in self.vocabs if vs for v in vs]
        words = ncols + 5 * nspec + 2 * len(entries)
        dbl = _align(4 * words, 8)
        vb = dbl + 16 * nspec
        size = _align(vb + sum(len(v) for v in entries), 16)
        out = np.zeros(size, np.uint8)
        w = out[:4 * words].view(np.int32)
        w[:ncols] = -1
        first = 0
        at = vb
        ents = []
        for i, k in enumerate(self.kinds):
            w[self.ordinals[i]] = i
            vs = self.vocabs[i] or []
            w[ncols + 5 * i:ncols + 5 * i + 5] = (
                k, self.slots[i], first, len(vs), self.nbins[i])
            for v in vs:
                ents.append((at, len(v)))
                out[at:at + len(v)] = np.frombuffer(v, np.uint8)
                at += len(v)
            first += len(vs)
        if ents:
            w[ncols + 5 * nspec:] = np.asarray(ents, np.int32).reshape(-1)
        out[dbl:dbl + 8 * nspec] = np.asarray(self.widths, np.float64).view(
            np.uint8)
        out[dbl + 8 * nspec:vb] = np.asarray(self.offsets, np.int64).view(
            np.uint8)
        self._meta[ncols] = out
        return out

    def device_meta(self, ncols: int, device: torch.device) -> torch.Tensor:
        """:meth:`meta` on ``device``, copied there once."""
        key = (ncols, str(device))
        got = self._device_meta.get(key)
        if got is None:
            got = self._device_meta[key] = torch.from_numpy(
                self.meta(ncols)).to(device)
        return got


def tile_span(starts: np.ndarray, rows: int) -> int:
    """The most bytes a tile of ``TILE_ROWS`` rows spans from 16-byte
    boundaries: what the kernel stages of it.  ``starts`` [rows + 1] holds
    each row's offset and the block's end."""
    if rows == 0:
        return 0
    lo = starts[0:rows:TILE_ROWS]
    hi = starts[np.minimum(np.arange(0, rows, TILE_ROWS) + TILE_ROWS, rows)]
    return int((((hi + 15) & ~15) - (lo & ~15)).max())


def smem_bytes(spec: CsvSpec, ncols: int, span: int) -> int:
    """The dynamic shared memory of a block of the kernel for tiles that
    span at most ``span`` bytes: the schema's tables, the tile's bytes and
    its staged outputs (int32 codes, float32 continuous values and int32
    labels of ``TILE_ROWS`` rows)."""
    return (spec.meta(ncols).size + span
            + 4 * TILE_ROWS * (spec.n_binned + spec.n_cont + 1))


def refuses(spec: CsvSpec, ncols: int, delim: str, starts: np.ndarray,
            rows: int) -> bool:
    """Whether :func:`encode_csv` refuses a block for its shape alone: a
    delimiter that is not one byte or is a line end, a column read twice or
    past the row's fields, or a block's shared memory past ``SMEM_MAX``."""
    return (len(delim.encode()) != 1 or delim in "\r\n"
            or len(set(spec.ordinals)) != len(spec.ordinals)
            or max(spec.ordinals, default=-1) >= ncols
            or smem_bytes(spec, ncols, tile_span(starts, rows)) > SMEM_MAX)


def csv_encode_ref(data: torch.Tensor, starts: torch.Tensor, spec: CsvSpec,
                   ncols: int, delim: str) -> Optional[Encoded]:
    """Plain version of the kernel: ``data`` uint8 [nbytes], ``starts``
    int64 [rows + 1] (each row's offset, then the end of the last row's
    line) on one device → (codes int32 [rows, n_binned], labels int32
    [rows] or None, cont float32 [rows, n_cont]), or None where the fast
    path refuses the chunk (module docstring)."""
    dev = data.device
    rows = starts.numel() - 1
    n = data.numel()
    s = starts[:-1]
    # each row's line ends at its first newline, else at the block's end
    nl = (data == 10).nonzero().squeeze(1)
    e = torch.full_like(s, n)
    if nl.numel():
        k = torch.searchsorted(nl, s)
        e = torch.where(k < nl.numel(), nl[k.clamp(max=nl.numel() - 1)], e)
    e = torch.minimum(e, starts[1:])
    e = e - ((e > s) & (data[(e - 1).clamp(min=0)] == 13)).long()
    # the bytes inside some row's line, its delimiters and their count
    mark = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    one = torch.ones(rows, dtype=torch.int32, device=dev)
    mark.index_add_(0, s, one)
    mark.index_add_(0, e, -one)
    inside = mark.cumsum(0, dtype=torch.int32)[:n] > 0
    isd = (data == ord(delim)) & inside
    before = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                        isd.cumsum(0, dtype=torch.int32)])
    if not bool(((before[e] - before[s]) == ncols - 1).all()):
        return None                                   # a ragged row
    dpos = isd.nonzero().squeeze(1).view(rows, ncols - 1)
    fstart = torch.cat([s[:, None], dpos + 1], 1)
    fend = torch.cat([dpos, e[:, None]], 1)
    codes = torch.empty((rows, spec.n_binned), dtype=torch.int32, device=dev)
    cont = torch.empty((rows, spec.n_cont), dtype=torch.float32, device=dev)
    labels = None
    pos = torch.arange(NUM_MAX_BYTES, device=dev)
    pow10 = torch.tensor([10.0 ** i for i in range(16)], dtype=torch.float64,
                         device=dev)
    for i, kind in enumerate(spec.kinds):
        a = fstart[:, spec.ordinals[i]]
        ln = fend[:, spec.ordinals[i]] - a
        if kind in (native.KIND_CATEGORICAL, native.KIND_LABEL):
            code = torch.full((rows,), -1, dtype=torch.int32, device=dev)
            for j, v in enumerate(spec.vocabs[i]):
                hit = (ln == len(v)) & (code < 0)
                for t, byte in enumerate(v):
                    hit &= data[(a + t).clamp(max=max(n - 1, 0))] == byte
                code = torch.where(hit, j, code)
            if kind == native.KIND_LABEL:
                if bool((code < 0).any()):
                    return None                       # an unknown label
                labels = code
            else:
                codes[:, spec.slots[i]] = torch.where(code < 0,
                                                      spec.nbins[i] - 1, code)
            continue
        if bool(((ln < 1) | (ln > NUM_MAX_BYTES)).any()):
            return None
        g = data[(a[:, None] + pos).clamp(max=n - 1)].long()
        valid = pos < ln[:, None]
        neg = g[:, 0] == 45
        signed = neg | (g[:, 0] == 43)
        body = valid & ~((pos == 0) & signed[:, None])
        dig = body & (g >= 48) & (g <= 57)
        dot = body & (g == 46)
        nd = dig.sum(1)
        if bool(((body & ~dig & ~dot).any(1) | (dot.sum(1) > 1)
                 | (nd < 1) | (nd > 15)).any()):
            return None                               # not the fast path
        rank = (nd[:, None] - dig.cumsum(1)).clamp(0, 15)
        num = torch.where(dig, (g - 48) * (10 ** rank), 0).sum(1)
        frac = (dig & (dot.cumsum(1) > 0)).sum(1)
        v = num.double() / pow10[frac]
        v = torch.where(neg, -v, v)
        if kind == native.KIND_CONTINUOUS:
            cont[:, spec.slots[i]] = v.float()
            continue
        fl = torch.floor(v / spec.widths[i])
        if not bool((fl.abs() <= _FLOOR_MAX).all()):
            return None
        codes[:, spec.slots[i]] = (fl.long() - spec.offsets[i]).clamp(
            0, spec.nbins[i] - 1).int()
    return codes, labels, cont


def encode_csv(packed: torch.Tensor, rows: int, data_off: int, nbytes: int,
               spec: CsvSpec, ncols: int, delim: str, device,
               stream=None) -> Optional[Encoded]:
    """A chunk reader's block encoded on ``device`` → (codes, labels,
    cont) there, or None where the chunk is refused.

    ``packed`` is a uint8 host tensor: ``rows + 1`` int64 row offsets
    (relative to ``data_off``; the last is the end of the last row's line)
    from byte 0, the block's ``nbytes`` bytes from ``data_off`` (a multiple
    of 16).  On CUDA it is pinned: ``packed[:data_off + nbytes]`` goes to
    the card in one copy and ``csrc/csv_encode.cu`` encodes it, both on
    ``stream`` (the current stream when None); the refusal flag's read
    synchronises that stream alone.  On the CPU it runs
    :func:`csv_encode_ref` over views of ``packed``."""
    device = torch.device(device)
    if packed.dtype != torch.uint8 or packed.device.type != "cpu" or \
            data_off % 16 or data_off < 8 * (rows + 1) or \
            packed.numel() < data_off + nbytes:
        raise ValueError("encode_csv: a host uint8 tensor holding the row "
                         "offsets from 0 and the bytes from a 16-aligned "
                         "data_off needed")
    starts_np = packed[:8 * (rows + 1)].numpy().view(np.int64)
    if refuses(spec, ncols, delim, starts_np, rows):
        return None
    if device.type == "cpu":
        return csv_encode_ref(packed[data_off:data_off + nbytes],
                              packed[:8 * (rows + 1)].view(torch.int64),
                              spec, ncols, delim)
    if device.type != "cuda":
        raise ValueError(f"encode_csv takes a CPU or CUDA device, got "
                         f"{device}")
    if not packed.is_pinned():
        raise ValueError("encode_csv on CUDA needs a pinned block")
    meta = spec.device_meta(ncols, device)
    lib = _kernel()
    if stream is None:
        stream = torch.cuda.current_stream(device)
    with torch.cuda.stream(stream):
        # the bytes padded to whole 16-byte words: the tile loads read them
        buf = torch.empty(data_off + _align(nbytes, 16) + 16,
                          dtype=torch.uint8, device=device)
        buf[:data_off + nbytes].copy_(packed[:data_off + nbytes],
                                      non_blocking=True)
        codes = torch.empty((rows, spec.n_binned), dtype=torch.int32,
                            device=device)
        cont = torch.empty((rows, spec.n_cont), dtype=torch.float32,
                           device=device)
        labels = (torch.empty(rows, dtype=torch.int32, device=device)
                  if spec.has_labels else None)
        flag = torch.zeros(1, dtype=torch.int32, device=device)
        err = lib.csv_encode(
            buf.data_ptr(), data_off, rows, meta.data_ptr(), meta.numel(),
            ncols, len(spec.kinds), sum(len(v) for v in spec.vocabs if v),
            ord(delim), spec.n_binned, spec.n_cont,
            tile_span(starts_np, rows), codes.data_ptr(),
            labels.data_ptr() if labels is not None else None,
            cont.data_ptr(), flag.data_ptr(), stream.cuda_stream)
        if err:
            raise RuntimeError(f"csv_encode launch failed with CUDA error "
                               f"{err}")
        with _COUNT_LOCK:
            encode_csv.launches += 1
        held = torch.empty(1, dtype=torch.int32, pin_memory=True)
        held.copy_(flag, non_blocking=True)
        stream.synchronize()
    if int(held[0]):
        return None
    return codes, labels, cont


encode_csv.launches = 0                # the device route's kernel


class CsvDecoder:
    """One chunk stream's device route: its schema's :class:`CsvSpec`, its
    device and, on CUDA, a stream of the input layer's own (made on the
    first chunk, by the thread that pulls the stream), so the copy and
    the kernel never queue on the fold's stream.  Calling it encodes a
    chunk reader's block (:func:`encode_csv`)."""

    def __init__(self, encoder, with_labels: bool, device):
        self.spec = CsvSpec(encoder, with_labels=with_labels)
        self.device = torch.device(device)
        self.stream = None

    def __call__(self, packed: torch.Tensor, rows: int, data_off: int,
                 nbytes: int, ncols: int, delim: str) -> Optional[Encoded]:
        if self.device.type == "cuda" and self.stream is None:
            self.stream = torch.cuda.Stream(self.device)
        return encode_csv(packed, rows, data_off, nbytes, self.spec, ncols,
                          delim, self.device, self.stream)


def _kernel() -> ctypes.CDLL:
    """The built library of ``csrc/csv_encode.cu``, its entry typed."""
    from avenir_tpu_torch.ops import _build

    lib = _build.load("csv_encode")
    fn = lib.csv_encode
    fn.restype = ctypes.c_int
    p, i, lg = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    fn.argtypes = [p, lg, lg, p, i, i, i, i, i, i, i, i, p, p, p, p, p]
    return lib
