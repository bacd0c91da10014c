"""Co-occurrence grams — the count kernels behind NB, MI and the tree.

Port of ``avenir_tpu/ops/pallas_hist.py``.  Every NB and MI count table is a
sub-block of G, where X is the [N, W] one-hot of the joint (feature, bin,
class) code.  The layout helpers (:func:`plan`, :func:`clsb_tile`,
:func:`g_key`, :func:`w_index`, :func:`counts_from_cooc`) and the PackGraft
disjoint-pack helpers (:func:`pack_disjoint`, :func:`packed_codes`,
:func:`packed_diag_index`) are copied unchanged, so G, its checkpoint key
and its read-out mean the same in both packages.

Wrappers of the hand-written CUDA kernels, each with its plain PyTorch
version beside it:

- :func:`cooc_counts_cols` → ``csrc/cooc_pair.cu`` in every plan mode: a
  pair histogram in shared memory over the tasks of :func:`pair_plan`,
  stored into G through the affine map of :func:`pair_layout` (replaces
  ``pallas_hist.py:283 _cooc_kernel`` in the fmaj and jmaj modes, B1, and
  ``:333 _cooc_cls_kernel`` and ``:365 _cooc_clsb_kernel`` in the per-class
  modes cls and clsb, B2 and B3); plain version
  :func:`cooc_counts_cols_ref`;
- :func:`cross_cooc_counts_cols` → ``csrc/cross.cu`` (replaces ``:484
  _cross_kernel``, B4), the decision tree's level table; plain version
  :func:`cross_cooc_counts_cols_ref`.

The SharedScan's chunk steps sit on these: :func:`gram_moments` (the gram
of a chunk and its class moments, back to back) on the kernel route, and
off it the exact one-hot product :func:`gram_counts` /
:func:`gram_counts_moments` where :func:`pack_tables` finds one product
cheaper than the per-table counts.

On a CPU tensor a wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises — there is no fallback between them.  Each
wrapper counts its launches in a function attribute (``launches``, and for
the per-class modes ``cls_launches`` / ``clsb_launches``).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from avenir_tpu_torch.ops.agg import check_chunk

# The XᵀX pass costs ~2·Wp² operations per row; past this width the JAX
# package switches to its per-class modes (and past their gates, to the
# scatter einsum).
MAX_W = 768

# per-class mode gates ("cls"): per-class width, class count, G bytes
MAX_W_CLS = 1536
MAX_C_CLS = 8
MAX_G_BYTES_CLS = 25 * 1024 * 1024

# blocked per-class mode gates ("clsb")
MAX_W_CLSB = 6144
MAX_C_CLSB = 16
_ACC_BYTES_CLSB = 35 * 1024 * 1024

# fmaj is preferred unless its jc→32 padding widens the gram by more than
# this factor against the j-major packing (shared with the JAX package's
# PackGraft cost model)
WIDTH_SLACK = 1.5


def _ru(x: int, m: int) -> int:
    return -(-x // m) * m


@functools.lru_cache(maxsize=1024)
def plan(num_feat: int, num_bins: int, num_classes: int):
    """Static layout plan → (mode, jcp, wp).

    ``fmaj``: w = f·jcp + (bin·C + cls), jcp = jc rounded up to 32.  Chosen
    unless that padding would widen the padded gram (wp) by more than
    ``WIDTH_SLACK`` versus the j-major packing ``jmaj`` (w = j·F + f).

    ``cls`` (wide shapes): G is [C, wp, wp] with per-class row index
    w = bin·F + f; ``clsb`` is the same gram for wider shapes still.
    """
    jc = num_bins * num_classes
    jcp32 = _ru(jc, 32)
    wp32 = _ru(num_feat * jcp32, 128)
    wpj = _ru(num_feat * jc, 128)
    if wp32 <= wpj or (wp32 <= MAX_W and wp32 <= WIDTH_SLACK * wpj):
        narrow = ("fmaj", jcp32, wp32)
    else:
        narrow = ("jmaj", jc, wpj)
    if narrow[2] <= MAX_W:
        return narrow
    wcp = _ru(num_feat * num_bins, 128)
    if (wcp <= MAX_W_CLS and 2 <= num_classes <= MAX_C_CLS
            and num_classes * wcp * wcp * 4 <= MAX_G_BYTES_CLS):
        return "cls", num_bins, wcp
    tile = clsb_tile(num_feat, num_bins, num_classes)
    if tile is not None:
        return "clsb", num_bins, tile[1]
    return narrow          # too wide for any kernel; applicable() rejects


def clsb_tile(num_feat: int, num_bins: int, num_classes: int):
    """(row-band height TR, padded per-class width wp) for the blocked
    per-class mode, or None when the shape is outside its gates.  A band
    is a whole number of bins (TR = F·k); wp pads the bin count to a
    multiple of k.  Pure function of the shape."""
    wcp = _ru(num_feat * num_bins, 128)
    if not (MAX_W_CLS < wcp or num_classes > MAX_C_CLS
            or num_classes * wcp * wcp * 4 > MAX_G_BYTES_CLS):
        return None                      # plain cls mode serves it
    if wcp > MAX_W_CLSB or not 2 <= num_classes <= MAX_C_CLSB:
        return None
    m = 8 // math.gcd(num_feat, 8)
    kmax = _ru(max(512 // num_feat, 1), m) + m
    best = None
    for k in range(m, kmax + 1, m):
        tr = num_feat * k
        wp = num_feat * _ru(num_bins, k)
        if wp > MAX_W_CLSB or num_classes * tr * wp * 4 > _ACC_BYTES_CLSB:
            continue
        key = (wp, -k)
        if best is None or key < best[0]:
            best = (key, (tr, wp))
    return best[1] if best else None


def g_key(num_feat: int, num_bins: int, num_classes: int) -> str:
    """Accumulator key of a G matrix of this shape's layout, the same string
    the JAX package uses (``g:<mode>:f<F>:b<B>:c<C>``), so a G total carries
    its layout across packages and a foreign layout can be refused."""
    mode, _, _ = plan(num_feat, num_bins, num_classes)
    return f"g:{mode}:f{num_feat}:b{num_bins}:c{num_classes}"


def gram_cells(num_feat: int, num_bins: int,
               num_classes: int) -> Tuple[int, int]:
    """(int32 cells of G, used lanes a gram contracts) in this shape's
    ``plan()`` mode: [wp, wp] over F·B·C lanes (fmaj, jmaj), or one
    [wp, wp] per class over F·B lanes (cls, clsb)."""
    mode, _jcp, wp = plan(num_feat, num_bins, num_classes)
    if mode in ("cls", "clsb"):
        return num_classes * wp * wp, num_feat * num_bins
    return wp * wp, num_feat * num_bins * num_classes


def gram_work(num_feat: int, n: int, g_cells: int, used: int,
              n_eff: int) -> Tuple[int, int]:
    """(bytes, operations) of a one-hot gram (B1–B3) as the work its
    inputs need — the one count behind PERF.md §6's bound and the
    profiler's analytic ``scan.chunk`` cost.  Bytes: a sparse product, so
    the int32 codes [F, n] and labels [n] read once and G (``g_cells``
    int32) written once.  Operations: the dense product of the one-hots,
    an int8 multiply and add per row for each upper-triangle cell of the
    ``used`` lanes, over the ``n_eff`` rows that count."""
    return (4 * num_feat * n + 4 * n + 4 * g_cells,
            used * (used + 1) * n_eff)


def cross_work(num_feat: int, n: int, num_bins: int, num_sel: int,
               n_eff: int) -> Tuple[int, int]:
    """(bytes, operations) of the cross table (B4) as the work its inputs
    need: the int32 codes [F, n] and selectors [n] read once and the
    [F, B, S] int32 table written once; the dense XᵀY form, an int8
    multiply and add per (feature, bin, selector) for each of the
    ``n_eff`` rows that count."""
    return (4 * num_feat * n + 4 * n + 4 * num_feat * num_bins * num_sel,
            2 * num_feat * num_bins * num_sel * n_eff)


def w_index(num_feat: int, num_bins: int, num_classes: int) -> np.ndarray:
    """[F, B, C] int64 array of each cell's row/col index in G (layout per
    :func:`plan`).  In the per-class modes the index is within class c's
    [wp, wp] gram; it is the same for every c."""
    mode, jcp, _ = plan(num_feat, num_bins, num_classes)
    if mode in ("cls", "clsb"):
        w2 = np.arange(num_bins)[None, :] * num_feat \
            + np.arange(num_feat)[:, None]
        return np.repeat(w2[:, :, None], num_classes, axis=2).astype(np.int64)
    j = np.arange(num_bins)[:, None] * num_classes + np.arange(num_classes)
    if mode == "fmaj":
        return (np.arange(num_feat)[:, None, None] * jcp + j[None]).astype(
            np.int64)
    return (j[None] * num_feat
            + np.arange(num_feat)[:, None, None]).astype(np.int64)


def default_block_cols(wp: int, mode: str = "fmaj") -> int:
    """The JAX kernel's column block (rows of the chunk per grid step),
    sized for the TPU's vector memory.  Kept for reference parity; the
    CUDA kernel stages 128 rows at a time in shared memory instead."""
    if mode == "fmaj":
        bn = min(98304, (72 * 1024 * 1024) // max(wp, 128))
    elif mode == "cls":
        bn = min(49152, (64 * 1024 * 1024) // (5 * max(wp, 128)))
    elif mode == "clsb":
        bn = (50 * 1024 * 1024) // (6 * max(wp, 128))
    else:
        bn = 49152 * 384 // max(wp, 128)
    return max(128, (bn // 128) * 128)


def applicable(num_feat: int, num_bins: int, num_classes: int) -> bool:
    """Static shape gate: does some XᵀX form (any plan mode) take it?"""
    if num_feat * num_bins * num_classes <= 0:
        return False
    mode, _, wp = plan(num_feat, num_bins, num_classes)
    return mode in ("cls", "clsb") or wp <= MAX_W


def use_kernel(num_feat: int, num_bins: int, num_classes: int,
               device) -> bool:
    """The routing predicate of the NB + MI count path: the data lives on
    CUDA and the shape is applicable in some plan mode (fmaj/jmaj launch
    B1, cls/clsb launch the per-class kernel)."""
    return (torch.device(device).type == "cuda"
            and applicable(num_feat, num_bins, num_classes))


def _gram_block_rows(num_feat: int, depth: int, wp: int) -> int:
    """Row block of the plain gram: a ~64 MB float32 intermediate budget and
    at most 2^16 rows, so each block's float32 matmul sums stay exact."""
    per_row = 4 * max(num_feat * depth + 2 * wp, 1)
    return max(256, min(1 << 16, (1 << 26) // per_row) // 128 * 128)


def cooc_counts_cols_ref(codes_t: torch.Tensor, labels: torch.Tensor,
                         num_bins: int, num_classes: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`cooc_counts_cols` for every plan
    mode, modelled on ``pallas_hist.gram_counts_cols``: codes_t [F, N],
    labels [N] → G int32 ([wp, wp], or [C, wp, wp] in the per-class modes).

    Rows are processed in blocks of at most 2^16; each block's one-hot
    product runs in float32, exact because its counts stay below 2^24, and
    is added into an int32 total.  Runs on whatever device its inputs are
    on."""
    f, n = codes_t.shape
    dev = codes_t.device
    mode, jcp, wp = plan(f, num_bins, num_classes)
    cls_mode = mode in ("cls", "clsb")
    out_shape = (num_classes, wp, wp) if cls_mode else (wp, wp)
    g = torch.zeros(out_shape, dtype=torch.int32, device=dev)
    if n == 0:
        return g
    jc = num_bins * num_classes
    depth = (wp // f if mode == "clsb" else
             num_bins if mode == "cls" else
             jcp if mode == "fmaj" else jc)
    br = _gram_block_rows(f, depth, wp)
    lanes = torch.arange(depth, device=dev)
    for s in range(0, n, br):
        cb = codes_t[:, s:s + br].long()                       # [F, br]
        yb = labels[s:s + br].long()                           # [br]
        rows = cb.shape[1]
        if cls_mode:
            # per-class gram over w = bin·F + f
            code = torch.where((cb >= 0) & (cb < num_bins), cb, -1)
            oh = (code[:, :, None] == lanes).to(torch.float32)  # [F, br, d]
            x = oh.permute(1, 2, 0).reshape(rows, depth * f)
            x = torch.nn.functional.pad(x, (0, wp - x.shape[1]))
            for c in range(num_classes):
                xc = x * (yb == c).to(torch.float32)[:, None]
                g[c] += (xc.T @ xc).to(torch.int32)
            continue
        ok = (((yb >= 0) & (yb < num_classes))[None, :]
              & (cb >= 0) & (cb < num_bins))
        j = torch.where(ok, cb * num_classes + yb[None, :], -1)  # [F, br]
        oh = (j[:, :, None] == lanes).to(torch.float32)          # [F, br, d]
        if mode == "fmaj":
            x = oh.permute(1, 0, 2).reshape(rows, f * depth)
        else:
            x = oh.permute(1, 2, 0).reshape(rows, depth * f)
        x = torch.nn.functional.pad(x, (0, wp - x.shape[1]))
        g += (x.T @ x).to(torch.int32)
    return g


def _check_operands(codes_t: torch.Tensor, vec: torch.Tensor,
                    what: str = "labels") -> None:
    """codes_t [F, N] and a per-row vector [N] (labels or selectors), both
    int32 on one device."""
    if codes_t.dim() != 2 or vec.dim() != 1:
        raise ValueError(f"codes_t must be [F, N] and {what} [N], got "
                         f"{tuple(codes_t.shape)} and {tuple(vec.shape)}")
    if codes_t.shape[1] != vec.shape[0]:
        raise ValueError(f"codes_t has {codes_t.shape[1]} rows, {what} "
                         f"{vec.shape[0]}")
    if codes_t.dtype != torch.int32 or vec.dtype != torch.int32:
        raise TypeError(f"codes_t and {what} must be int32, got "
                        f"{codes_t.dtype} and {vec.dtype}")
    if codes_t.device != vec.device:
        raise ValueError(f"codes_t on {codes_t.device}, {what} on "
                         f"{vec.device}")


def cooc_counts_cols(codes_t: torch.Tensor, labels: torch.Tensor,
                     num_bins: int, num_classes: int) -> torch.Tensor:
    """codes_t [F, N] int32 (columnar), labels [N] int32 → G int32
    co-occurrence counts (row/col index per :func:`w_index`): [wp, wp], or
    [C, wp, wp] in the per-class modes.

    G[w1, w2] = #rows whose feature f1 falls in (b1, c) and f2 in (b2, c):
    all NB/MI count tables at once.  On CUDA this launches
    ``csrc/cooc_pair.cu``, counted in ``cooc_counts_cols.launches`` (fmaj,
    jmaj: B1), ``cls_launches`` (B2) or ``clsb_launches`` (B3); on the CPU
    it runs :func:`cooc_counts_cols_ref`."""
    _check_operands(codes_t, labels)
    check_chunk(codes_t.shape[1])
    f, n = codes_t.shape
    dev = codes_t.device
    if dev.type == "cpu":
        return cooc_counts_cols_ref(codes_t, labels, num_bins, num_classes)
    if dev.type != "cuda":
        raise ValueError(f"cooc_counts_cols takes CPU or CUDA tensors, got {dev}")
    if not applicable(f, num_bins, num_classes):
        raise ValueError(f"shape F={f} B={num_bins} C={num_classes} is "
                         f"outside the gram kernels' gates (wp "
                         f"{plan(f, num_bins, num_classes)[2]} > {MAX_W})")
    if not (codes_t.is_contiguous() and labels.is_contiguous()):
        raise ValueError("cooc_counts_cols needs contiguous codes_t and labels")
    with _on_device(dev):
        shape, tasks, args, counter = _pair_launch(f, num_bins, num_classes,
                                                   n, dev.index)
        cells = math.prod(shape)
        # one allocation, zeroed by one fill: G and, after it, the 2·C int32
        # class counts and cursors of the sort
        buf = torch.zeros(cells + 2 * num_classes, dtype=torch.int32,
                          device=dev)
        g = buf[:cells].view(shape)
        if n == 0:
            return g
        sorted_codes = torch.empty(f * _ru(n, 8), dtype=torch.int16,
                                   device=dev)
        err = _kernel("cooc_pair").cooc_pair_gram(
            codes_t.data_ptr(), labels.data_ptr(), buf.data_ptr(),
            buf.data_ptr() + 4 * cells, sorted_codes.data_ptr(),
            tasks.data_ptr(), *args, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"cooc_pair_gram launch failed with CUDA error {err}")
    setattr(cooc_counts_cols, counter, getattr(cooc_counts_cols, counter) + 1)
    return g


def _on_device(dev: torch.device):
    """The context that makes ``dev`` the current CUDA device for a launch:
    none where it is current already (a chunk's host work counts in its
    time on the card, the card waiting)."""
    if torch.cuda.current_device() == dev.index:
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


@functools.lru_cache(maxsize=256)
def _pair_launch(num_feat: int, num_bins: int, num_classes: int, n: int,
                 index: int):
    """What a launch of the pair pass on CUDA device ``index`` (the
    current device) takes from the shape and row count alone → (G's shape,
    the device task table, the C entry's int arguments, the launch
    counter's name).  Cached, so that a chunk's host work is the
    allocations and the call."""
    mode, jcp, wp = plan(num_feat, num_bins, num_classes)
    limits = _pair_device(index)
    pp = pair_plan(num_feat, num_bins, num_classes, n, *limits)
    tasks = _pair_tasks(num_feat, num_bins, num_classes, *limits,
                        torch.device("cuda", index))
    shape = ((num_classes, wp, wp) if mode in ("cls", "clsb") else (wp, wp))
    args = (num_feat, n, num_bins, num_classes, wp, len(pp.tasks), pp.splits,
            pp.copies, pp.cells,
            *pair_layout(mode, num_feat, num_bins, num_classes, jcp, wp))
    counter = {"cls": "cls_launches", "clsb": "clsb_launches"}.get(
        mode, "launches")
    return shape, tasks, args, counter


def pair_layout(mode: str, num_feat: int, num_bins: int, num_classes: int,
                jcp: int, wp: int) -> Tuple[int, int, int, int]:
    """The store map of the pair pass for a :func:`plan` layout → (gmat,
    cs, fs, bs): cell (f, b) of class c lies in G's matrix c (offset
    c·gmat int32) at lane c·cs + f·fs + b·bs, which is :func:`w_index`."""
    if mode in ("cls", "clsb"):
        return wp * wp, 0, 1, num_feat           # w = b·F + f, per class
    if mode == "fmaj":
        return 0, 1, jcp, num_classes            # w = f·jcp + b·C + c
    return 0, num_feat, 1, num_classes * num_feat  # w = (b·C + c)·F + f


# the pair pass (csrc/cooc_pair.cu): tasks of one
# class, one feature f1, a run of f2 ≥ f1 and a band of f1's bins, each an
# int32 table [run, band, B + (8 − B) mod 32] in shared memory (a row
# stride ≡ 8 mod 32, which spreads a warp's cells over the banks)
PAIR_RUN = 8               # f2 per task at most (the kernel's register batch)
PAIR_COPIES = 8            # table copies per block at most
PAIR_SMEM = 96 * 1024      # table bytes per block, so two blocks share an SM
PAIR_BLOCKS_PER_SM = 4     # row splits aim at this many blocks per SM
PAIR_MIN_ROWS = 4096       # rows of a class per split, at least (estimated)


class PairPlan(NamedTuple):
    """The pair pass's work: ``tasks`` [T, 6] int32 rows (class, f1, first
    f2, f2 count, first bin of f1, f1 bins), each run ``splits`` times over
    a share of its class's rows with ``copies`` tables of at most ``cells``
    ints; ``smem`` bytes of shared memory per block."""
    tasks: np.ndarray
    splits: int
    copies: int
    cells: int
    smem: int


@functools.lru_cache(maxsize=256)
def pair_plan(num_feat: int, num_bins: int, num_classes: int, n: int,
              smem_limit: int, sms: int) -> PairPlan:
    """Tasks of the per-class pair histogram for an [F, n] chunk on a
    device with ``sms`` SMs and ``smem_limit`` bytes of shared memory per
    block.  Every (class, f1 ≤ f2, bin of f1) lies in exactly one task.  A
    pair's B × B table takes whole runs of up to PAIR_RUN f2 where it fits
    the budget; else f1's bins are cut into bands of one f2 each.  Small
    tables get one copy per warp group; rows are split until the grid has
    about PAIR_BLOCKS_PER_SM blocks per SM.  Pure function of its
    arguments (cached: the caller must not modify the tasks)."""
    f, b, c = num_feat, num_bins, num_classes
    budget = min(smem_limit, PAIR_SMEM) // 4              # ints per block
    stride = b + (8 - b) % 32               # the table's row stride
    if f < 1 or b < 1 or c < 1 or stride > budget:
        raise ValueError(f"no pair plan for F={f} B={b} C={c} in "
                         f"{smem_limit} bytes")
    if b * stride <= budget:
        run, band = min(PAIR_RUN, budget // (b * stride)), b
    else:
        run, band = 1, budget // stride
    tasks = [(cls, f1, f2, min(run, f - f2), b1, min(band, b - b1))
             for cls in range(c) for f1 in range(f)
             for b1 in range(0, b, band) for f2 in range(f1, f, run)]
    cells = max(t[3] * t[5] for t in tasks) * stride
    copies = max(1, min(PAIR_COPIES, budget // cells))
    splits = max(1, min(-(-PAIR_BLOCKS_PER_SM * sms // len(tasks)),
                        n // (c * PAIR_MIN_ROWS)))
    return PairPlan(np.asarray(tasks, np.int32), splits, copies, cells,
                    4 * copies * cells)


@functools.lru_cache(maxsize=None)
def _pair_device(index: int) -> Tuple[int, int]:
    """(shared memory per block, SMs) of CUDA device ``index``, which the
    caller has made the current device."""
    return (_kernel("cooc_pair").cooc_pair_smem_limit(),
            torch.cuda.get_device_properties(index).multi_processor_count)


@functools.lru_cache(maxsize=256)
def _pair_tasks(num_feat: int, num_bins: int, num_classes: int,
                smem_limit: int, sms: int, dev: torch.device) -> torch.Tensor:
    """pair_plan's task table on the device, uploaded once per shape (the
    tasks do not depend on the row count)."""
    pp = pair_plan(num_feat, num_bins, num_classes, 0, smem_limit, sms)
    return torch.from_numpy(pp.tasks).to(dev)


cooc_counts_cols.launches = 0          # B1 (fmaj, jmaj)
cooc_counts_cols.cls_launches = 0      # B2
cooc_counts_cols.clsb_launches = 0     # B3

# each kernel's C entry point and its argument types: pointers (and the
# stream) as c_void_p, ints as c_int
_ENTRY = {
    "cooc_pair": {"cooc_pair_gram": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 13
                  + [ctypes.c_void_p],
                  "cooc_pair_smem_limit": []},
    "cross": {"cross_counts": [ctypes.c_void_p] * 5, "cross_setup": []},
}


@functools.lru_cache(maxsize=None)
def _kernel(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, its entry points typed."""
    from avenir_tpu_torch.ops import _build

    lib = _build.load(name)
    for entry, argtypes in _ENTRY[name].items():
        fn = getattr(lib, entry)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return lib


def cooc_counts(codes: torch.Tensor, labels: torch.Tensor, num_bins: int,
                num_classes: int) -> torch.Tensor:
    """Row-major entry: codes [N, F] → one device transpose, then
    :func:`cooc_counts_cols`."""
    return cooc_counts_cols(codes.t().contiguous(), labels, num_bins,
                            num_classes)


def gram_moments(codes: torch.Tensor, labels: torch.Tensor,
                 cont: torch.Tensor, num_bins: int, num_classes: int):
    """One SharedScan chunk step on the kernel route: the gram G of the
    chunk's codes (:func:`cooc_counts`: B1, or B2/B3 in the per-class
    modes) and the class-conditional (count, Σx, Σx²) moments of its
    continuous block (``agg.class_moments``), issued back to back on the
    current stream over the same resident chunk.

    codes [N, F], labels [N], cont [N, Fc] → (G, cnt [C], s1 [C, Fc],
    s2 [C, Fc])."""
    from avenir_tpu_torch.ops import agg

    g = cooc_counts(codes, labels, num_bins, num_classes)
    cnt, s1, s2 = agg.class_moments(cont, labels, num_classes)
    return g, cnt, s1, s2


def gram_counts_cols(codes_t: torch.Tensor, labels: torch.Tensor,
                     num_bins: int, num_classes: int) -> torch.Tensor:
    """G as one exact one-hot product in every plan mode, the packed
    fold's program (``pallas_hist.gram_counts_cols``): float32 row blocks
    of :func:`_gram_block_rows`, each exact below 2^24, summed in int32.
    It is not a Pallas kernel in the JAX package, and here it is
    ``torch.matmul`` on whatever device the inputs are on — the same
    program as :func:`cooc_counts_cols_ref`, B1's plain version."""
    check_chunk(codes_t.shape[1])
    return cooc_counts_cols_ref(codes_t, labels, num_bins, num_classes)


def gram_counts(codes: torch.Tensor, labels: torch.Tensor, num_bins: int,
                num_classes: int) -> torch.Tensor:
    """Row-major entry of :func:`gram_counts_cols` (codes [N, F])."""
    return gram_counts_cols(codes.t(), labels, num_bins, num_classes)


def gram_counts_moments(codes: torch.Tensor, labels: torch.Tensor,
                        cont: torch.Tensor, num_bins: int, num_classes: int):
    """The packed fold's analog of :func:`gram_moments`: the one-hot gram
    and the class moments of the same chunk."""
    from avenir_tpu_torch.ops import agg

    g = gram_counts(codes, labels, num_bins, num_classes)
    cnt, s1, s2 = agg.class_moments(cont, labels, num_classes)
    return g, cnt, s1, s2


def nb_mi_step(codes: torch.Tensor, labels: torch.Tensor, ci, cj,
               num_classes: int, num_bins: int):
    """The gram route's counterpart of ``agg.nb_mi_pipeline_step``:
    → (fbc [F, B, C], pair [P, B, B, C]) as numpy arrays, read out of one
    chunk's G (which waits for the device)."""
    g = cooc_counts(codes, labels, num_bins, num_classes)
    return counts_from_cooc(g, codes.shape[1], num_bins, num_classes, ci, cj)


def chunk_pipeline(num_feat: int, num_bins: int, num_classes: int, ci, cj,
                   device, columnar: bool = False):
    """(step, chain_scalar, is_kernel) for the per-chunk NB + MI step on
    ``device``, routed by :func:`use_kernel`.

    ``step(codes, labels)`` returns the chunk's counts (G on the kernel
    route, (fbc, pair) on the ``agg`` route); ``chain_scalar(out)`` is a
    zero int32 scalar taken from them, which a benchmark adds to the next
    chunk's labels so that one final wait covers the whole chain.  With
    ``columnar=True`` (kernel route only) ``step`` takes codes as [F, N]."""
    if use_kernel(num_feat, num_bins, num_classes, device):
        kernel = cooc_counts_cols if columnar else cooc_counts

        def step(codes, labels):
            return kernel(codes, labels, num_bins, num_classes)

        def chain_scalar(out):
            return (out[(0,) * out.dim()] * 0).to(torch.int32)

        return step, chain_scalar, True

    from avenir_tpu_torch.ops import agg

    def step(codes, labels):
        return agg.nb_mi_pipeline_step(codes, labels, ci, cj,
                                       num_classes, num_bins)

    def chain_scalar(out):
        return (out[0][0, 0, 0] * 0).to(torch.int32)

    return step, chain_scalar, False


def counts_from_cooc(g, num_feat: int, num_bins: int, num_classes: int,
                     ci, cj):
    """Host-side (numpy) read-out of the reference-shaped count tensors
    from G:  → (fbc [F, B, C], pair [P, B, B, C]), dtype preserved.  Runs
    once per job on a small matrix."""
    if isinstance(g, torch.Tensor):
        g = g.cpu().numpy()
    g = np.asarray(g)
    b, c = num_bins, num_classes
    wf = w_index(num_feat, b, c)                             # [F, B, C]
    ci = np.asarray(ci, np.int64)
    cj = np.asarray(cj, np.int64)
    p = len(ci)
    if g.ndim == 3:                                          # cls mode
        w2 = wf[:, :, 0]                                     # [F, B]
        fbc = np.stack([g[k][w2, w2] for k in range(c)], axis=-1)
        wi = np.broadcast_to(w2[ci][:, :, None], (p, b, b))
        wj = np.broadcast_to(w2[cj][:, None, :], (p, b, b))
        pair = np.stack([g[k][wi, wj] for k in range(c)], axis=-1)
        return fbc, pair
    fbc = g[wf, wf]
    wi = wf[ci][:, :, None, :]                               # [P, B, 1, C]
    wj = wf[cj][:, None, :, :]                               # [P, 1, B, C]
    pair = g[np.broadcast_to(wi, (p, b, b, c)),
             np.broadcast_to(wj, (p, b, b, c))]
    return fbc, pair


# ---------------------------------------------------------------------------
# cross co-occurrence XᵀY: the decision tree's level table (B4)
# ---------------------------------------------------------------------------

MAX_SEL_CROSS = 1024


def cross_sel_width(num_sel: int) -> int:
    """Padded selector lane width of the JAX cross gram's dot (Y pads to
    whole 128-lane tiles) — what ``DecisionTree.level_stats`` reports as
    ``sel_width`` on the cross route, as the JAX package does."""
    return _ru(max(num_sel, 1), 128)


def cross_applicable(num_feat: int, num_bins: int, num_sel: int) -> bool:
    """Gate of the cross kernel, the JAX package's: the X side obeys the
    joint-gram width cap (fmaj, jcp = B rounded up to 32) and the selector
    side stays at most 1024."""
    if num_feat * num_bins <= 0 or num_sel <= 0:
        return False
    jcp = _ru(num_bins, 32)
    wp = _ru(num_feat * jcp, 128)
    return wp <= MAX_W and num_sel <= MAX_SEL_CROSS


def cross_cooc_counts_cols_ref(codes_t: torch.Tensor, sel: torch.Tensor,
                               num_bins: int, num_sel: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`cross_cooc_counts_cols`, the product
    XᵀY of ``pallas_hist.cross_cooc_counts_cols``: X the (feature, bin)
    one-hot, Y the selector one-hot, in row blocks of at most 2^16 whose
    float32 products are exact, summed in int32.  A code outside [0, B)
    gives an all-zero X cell and a selector outside [0, num_sel) an
    all-zero Y row, so both drop out.  Runs on whatever device its inputs
    are on."""
    f, n = codes_t.shape
    dev = codes_t.device
    out = torch.zeros((f * num_bins, num_sel), dtype=torch.int32, device=dev)
    br = _gram_block_rows(f, num_bins, num_sel)
    bins = torch.arange(num_bins, device=dev)
    sels = torch.arange(num_sel, device=dev)
    for s in range(0, n, br):
        cb = codes_t[:, s:s + br].long()                       # [F, br]
        rows = cb.shape[1]
        x = (cb[:, :, None] == bins).to(torch.float32)        # [F, br, B]
        x = x.permute(1, 0, 2).reshape(rows, f * num_bins)
        y = (sel[s:s + br].long()[:, None] == sels).to(torch.float32)
        out += (x.T @ y).to(torch.int32)
    return out.reshape(f, num_bins, num_sel)


def cross_cooc_counts_cols(codes_t: torch.Tensor, sel: torch.Tensor,
                           num_bins: int, num_sel: int) -> torch.Tensor:
    """codes_t [F, N] int32 (columnar), sel [N] int32 → [F, B, num_sel]
    int32 counts of each (feature, bin, selector) co-occurrence; a code
    outside [0, B) drops its cell and a selector outside [0, num_sel)
    (−1 included) drops the whole row.

    The decision tree's [F, B, K, C] level table is this with
    sel = node·C + class.  On CUDA this launches ``csrc/cross.cu`` as
    :func:`cross_plan` sizes it (counted in
    ``cross_cooc_counts_cols.launches``; shapes past
    :func:`cross_applicable` raise); on the CPU it runs
    :func:`cross_cooc_counts_cols_ref`."""
    _check_operands(codes_t, sel, "sel")
    f, n = codes_t.shape
    dev = codes_t.device
    if dev.type == "cpu":
        return cross_cooc_counts_cols_ref(codes_t, sel, num_bins, num_sel)
    if dev.type != "cuda":
        raise ValueError(f"cross_cooc_counts_cols takes CPU or CUDA tensors, "
                         f"got {dev}")
    if not cross_applicable(f, num_bins, num_sel):
        raise ValueError(f"shape F={f} B={num_bins} num_sel={num_sel} is "
                         f"outside the cross kernel's gates")
    if not (codes_t.is_contiguous() and sel.is_contiguous()):
        raise ValueError("cross_cooc_counts_cols needs contiguous codes_t "
                         "and sel")
    out = codes_t.new_empty((f, num_bins, num_sel))
    if n == 0:
        return out.zero_()
    with _on_device(dev):
        args = _cross_launch(f, num_bins, num_sel, n, dev.index)
        # the raw handle: torch.cuda.current_stream() builds a Stream object,
        # several µs of host time on every level
        stream = torch._C._cuda_getCurrentRawStream(dev.index)
        err = _kernel("cross").cross_counts(
            codes_t.data_ptr(), sel.data_ptr(), out.data_ptr(),
            ctypes.addressof(args), stream)
    if err:
        raise RuntimeError(f"cross_counts launch failed with CUDA error {err}")
    cross_cooc_counts_cols.launches += 1
    return out


# the cross kernel (csrc/cross.cu): a block of 256 threads stages ROWS-row
# tiles of the selectors and of its features' codes into a ring of STAGES
# segments of ROWS + 4 ints each, after HEAD bytes of mbarriers, and keeps
# its table of [feat_tile, B, sel_tile] counters behind the ring.  The
# constants are cross.cu's (tests/test_torch_hist.py reads them there).
CROSS_ROWS = 1024
CROSS_STAGES = 2
CROSS_HEAD = 128
CROSS_MAX_FEAT_TILE = 24   # the gate's widest X side (wp ≤ 768, jcp ≥ 32)
CROSS_CLUSTER = 2          # blocks per cluster: an H100 schedules SMs by pairs
CROSS_PACKED_ROWS = 65_532  # rows per block with 16-bit counters, at most


class CrossPlan(NamedTuple):
    """The cross kernel's grid: ``tiles`` tiles of ``feat_tile`` features
    by ``sel_tile`` selectors (feature-major; the last of each may hold
    fewer), each over ``row_blocks`` blocks of ``rows_per_block`` rows (a
    multiple of 4; trailing blocks may hold none) in clusters of
    ``cluster``; a block counts into int32 counters, or 16-bit ones two to
    a word where ``packed``, and takes ``smem`` bytes of dynamic shared
    memory."""
    feat_tile: int
    sel_tile: int
    tiles: int
    rows_per_block: int
    row_blocks: int
    cluster: int
    packed: bool
    smem: int


def cross_smem(feat_tile: int, num_bins: int, sel_tile: int,
               packed: bool) -> int:
    """Dynamic shared memory of a cross block in bytes: the mbarriers, the
    ring (the selectors and ``feat_tile`` features per stage) and the
    table."""
    cells = feat_tile * num_bins * sel_tile
    words = -(-cells // 2) if packed else cells
    return CROSS_HEAD + 4 * (CROSS_STAGES * (1 + feat_tile) * (CROSS_ROWS + 4)
                             + words)


def cross_plan(num_feat: int, num_bins: int, num_sel: int, n: int,
               smem_limit: int, sms: int) -> CrossPlan:
    """The cross kernel's grid for [F, n] codes on a device with ``sms`` SMs
    and ``smem_limit`` bytes of dynamic shared memory per block.

    A tile takes as many features as fit with every selector, balanced
    over the tiles, so each block reads only its own features' codes; only
    where one feature's table does not fit are the selectors cut too.
    16-bit counters where int32 ones do not fit, or where they make fewer
    tiles and one wave of blocks of at most CROSS_PACKED_ROWS rows covers
    the rows.  Two blocks share an SM where two fit.  The row blocks of the
    tiles fill one wave of the SMs, in clusters of CROSS_CLUSTER.  Pure
    function of its arguments."""
    f, b, s = num_feat, num_bins, num_sel
    if f < 1 or b < 1 or s < 1:
        raise ValueError(f"no cross plan for F={f} B={b} num_sel={s}")

    def layout(packed):
        """(feat_tile, sel_tile, tiles, blocks per SM) with these counters,
        or None where not one feature and selector fits."""
        fits = [ft for ft in range(1, min(f, CROSS_MAX_FEAT_TILE) + 1)
                if cross_smem(ft, b, s, packed) <= smem_limit]
        ft, st = (fits[-1], s) if fits else (1, min(s, (
            smem_limit - cross_smem(1, b, 0, packed))
            // 4 * (2 if packed else 1) // b))
        if st < 1:
            return None
        ft = -(-f // -(-f // ft))
        st = -(-s // -(-s // st))
        # two blocks and their 1 KB reserves in one SM's shared memory
        two = cross_smem(ft, b, st, packed) <= smem_limit // 2 - 1024
        return ft, st, -(-f // ft) * -(-s // st), 2 if two else 1

    wide, narrow = layout(False), layout(True)
    if narrow is None:
        raise ValueError(f"no cross plan for F={f} B={b} num_sel={s} in "
                         f"{smem_limit} bytes")
    packed = wide is None or (
        narrow[2] < wide[2]
        and n <= narrow[3] * sms // narrow[2] * CROSS_PACKED_ROWS)
    ft, st, tiles, per_sm = narrow if packed else wide
    blocks = max(1, min(per_sm * sms // tiles, -(-n // CROSS_ROWS)))
    cluster = min(CROSS_CLUSTER, 1 << (blocks.bit_length() - 1))
    row_blocks = blocks // cluster * cluster
    if packed:
        row_blocks = max(row_blocks, _ru(-(-n // CROSS_PACKED_ROWS), cluster))
    rows_per_block = _ru(-(-max(n, 1) // row_blocks), 4)
    return CrossPlan(ft, st, tiles, rows_per_block, row_blocks, cluster,
                     packed, cross_smem(ft, b, st, packed))


class _CrossArgs(ctypes.Structure):
    """``CrossArgs`` of csrc/cross.cu: one launch's plan."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "f", "n", "nbins", "nsel", "feat_tile", "sel_tile", "tiles",
        "rows_per_block", "row_blocks", "cluster", "smem", "pack")]


@functools.lru_cache(maxsize=256)
def _cross_launch(num_feat: int, num_bins: int, num_sel: int, n: int,
                  index: int) -> _CrossArgs:
    """The ``_CrossArgs`` of a launch of the cross kernel on CUDA device
    ``index`` (the current device), which depend on the shape and row count
    alone.  Cached, so that a level's host work is the output's allocation
    and the call."""
    cp = cross_plan(num_feat, num_bins, num_sel, n, *_cross_device(index))
    return _CrossArgs(num_feat, n, num_bins, num_sel, cp.feat_tile,
                      cp.sel_tile, cp.tiles, cp.rows_per_block, cp.row_blocks,
                      cp.cluster, cp.smem, int(cp.packed))


@functools.lru_cache(maxsize=None)
def _cross_device(index: int) -> Tuple[int, int]:
    """(dynamic shared memory per block, SMs) of CUDA device ``index``,
    which the caller has made the current device; the first call lets the
    kernel take that much shared memory there."""
    limit = _kernel("cross").cross_setup()
    if limit <= 0:
        raise RuntimeError(f"cross_setup failed with CUDA error {-limit}")
    return limit, torch.cuda.get_device_properties(index).multi_processor_count


cross_cooc_counts_cols.launches = 0


# ---------------------------------------------------------------------------
# PackGraft disjoint packs (pallas_hist.py:818-988): M row-disjoint members
# (tree frontier nodes), each an [F, B, C] table, as one joint gram over
# M bin stripes.  Composite codes code + m·stripe keep every cross-member
# block structurally zero, because no row carries two members.
# ---------------------------------------------------------------------------


class PackMember(NamedTuple):
    """One table riding a pack: its (F, B, C) shape plus where its block
    starts (the bin-stripe offset of a disjoint pack)."""
    key: str
    num_feat: int
    num_bins: int
    num_classes: int
    offset: int


class PackPlan(NamedTuple):
    """One packed gram: the members plus the JOINT (F, B, C) shape handed
    to :func:`plan` and :func:`cooc_counts_cols`."""
    members: Tuple[PackMember, ...]
    num_feat: int
    num_bins: int          # JOINT bins (disjoint: n_members · stripe_bins)
    num_classes: int
    mode: str              # plan() mode of the joint shape
    wp: int                # padded joint width
    band_bins: int         # clsb band size in bins (0 otherwise)
    stripe_bins: int       # disjoint packs: per-member bin stride, else 0
    disjoint: bool

    @property
    def signature(self) -> str:
        """Composite pack identity, the JAX package's string."""
        tag = "d" if self.disjoint else "x"
        return (f"{self.mode}:{tag}{len(self.members)}:f{self.num_feat}"
                f":b{self.num_bins}:c{self.num_classes}:w{self.wp}")

    @property
    def g_key(self) -> str:
        """Key of the packed G: the layout of g_key(joint shape) with a
        ``packed`` base, as the JAX package writes it."""
        return (f"g:packed:{self.mode}:f{self.num_feat}"
                f":b{self.num_bins}:c{self.num_classes}")


def packed_g_key(num_feat: int, num_bins: int, num_classes: int) -> str:
    """The packed-provenance g_key of a joint shape (same byte layout as
    :func:`g_key`, another base string)."""
    mode, _, _ = plan(num_feat, num_bins, num_classes)
    return f"g:packed:{mode}:f{num_feat}:b{num_bins}:c{num_classes}"


def pack_tables(num_feat: int, num_bins: int, num_classes: int,
                num_pairs: int, max_width: Optional[int] = None
                ) -> Optional[PackPlan]:
    """Cross-pack planner: NB's [F, B, C] table and P MI pair tables
    ([B, B, C] each) as ONE joint gram, or None when the pack does not pay.

    The JAX package's cost model, unchanged: the unpacked fold builds
    F·B + P·B·(1 + C) one-hot-contracted cells per row; the packed gram
    pays wp², so pack iff wp ≤ WIDTH_SLACK · (F·B + P·B·(1 + C)) and wp
    fits the clsb ceiling (or ``max_width``)."""
    if num_feat * num_bins * num_classes <= 0:
        return None
    mode, _jcp, wp = plan(num_feat, num_bins, num_classes)
    cap = min(max_width or MAX_W_CLSB, MAX_W_CLSB)
    if wp > cap:
        return None
    cells = num_feat * num_bins + num_pairs * num_bins * (1 + num_classes)
    if wp > WIDTH_SLACK * cells:
        return None
    wf = w_index(num_feat, num_bins, num_classes)
    members = tuple(
        PackMember(key=f"f{i}", num_feat=1, num_bins=num_bins,
                   num_classes=num_classes, offset=int(wf[i].min()))
        for i in range(num_feat))
    band = clsb_tile(num_feat, num_bins, num_classes) if mode == "clsb" \
        else None
    return PackPlan(members=members, num_feat=num_feat, num_bins=num_bins,
                    num_classes=num_classes, mode=mode, wp=wp,
                    band_bins=(band[0] // num_feat if band else 0),
                    stripe_bins=0, disjoint=False)


def pack_disjoint(num_members: int, num_feat: int, num_bins: int,
                  num_classes: int, max_width: Optional[int] = None
                  ) -> Optional[PackPlan]:
    """Disjoint-pack planner: M row-disjoint members, each an [F, B, C]
    table, as one joint gram over M·Bp bins, where Bp is B rounded up so
    that clsb bands hold whole members.  None when the joint shape exceeds
    every tier or the stripe↔band fixpoint does not settle in 4 steps."""
    if num_members <= 0 or num_feat * num_bins * num_classes <= 0:
        return None
    bp = num_bins
    mode = wp = None
    for _ in range(4):                       # stripe↔band fixpoint, ≤4 hops
        mode, _, wp = plan(num_feat, num_members * bp, num_classes)
        if mode != "clsb":
            break
        tile = clsb_tile(num_feat, num_members * bp, num_classes)
        if tile is None:
            return None
        k = tile[0] // num_feat              # band size in bins
        bp2 = _ru(num_bins, k)
        if bp2 == bp:
            break
        bp = bp2
    else:
        return None
    cap = min(max_width or MAX_W_CLSB, MAX_W_CLSB)
    if wp > cap or not (mode in ("cls", "clsb") or wp <= MAX_W):
        return None
    members = tuple(
        PackMember(key=f"m{i}", num_feat=num_feat, num_bins=num_bins,
                   num_classes=num_classes, offset=i * bp)
        for i in range(num_members))
    band = clsb_tile(num_feat, num_members * bp, num_classes) \
        if mode == "clsb" else None
    return PackPlan(members=members, num_feat=num_feat,
                    num_bins=num_members * bp, num_classes=num_classes,
                    mode=mode, wp=wp,
                    band_bins=(band[0] // num_feat if band else 0),
                    stripe_bins=bp, disjoint=True)


def packed_codes(codes_t: torch.Tensor, member: torch.Tensor,
                 stripe_bins: int, member_bins: int) -> torch.Tensor:
    """Composite int32 codes of a disjoint pack: joint bin = code +
    m·stripe.  The mask is against the member's OWN bin count: an
    out-of-range local code becomes −1 (dropped by the kernels), never a
    cell of the next member's stripe.  Rows with member −1 drop whole."""
    ct = codes_t.to(torch.int32)
    mem = member.to(torch.int32)
    off = torch.where(mem >= 0, mem * stripe_bins, 0)[None, :]
    ok = (mem >= 0)[None, :] & (ct >= 0) & (ct < member_bins)
    return torch.where(ok, ct + off, -1).to(torch.int32)


def packed_diag_index(pplan: PackPlan) -> np.ndarray:
    """Host-side unpack index of a disjoint pack: w cells [F, B, M, C] such
    that G[w, w] (per class in the cls modes) is member m's [F, B, C]
    table."""
    wf = w_index(pplan.num_feat, pplan.num_bins, pplan.num_classes)
    b = pplan.members[0].num_bins
    offs = np.array([mb.offset for mb in pplan.members], np.int64)
    sel = offs[None, :] + np.arange(b)[:, None]              # [B, M]
    return wf[:, sel, :]                                     # [F, B, M, C]


def packed_applicable(pplan: PackPlan) -> bool:
    """Kernel eligibility of the JOINT shape."""
    return applicable(pplan.num_feat, pplan.num_bins, pplan.num_classes)
