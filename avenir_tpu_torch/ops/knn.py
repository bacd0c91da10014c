"""kNN candidate search — the squared distance as one bf16 product, a
candidate kernel, an exact re-rank and a certificate.

Port of ``avenir_tpu/ops/pallas_knn.py``.  The operand layout, its packing
(:func:`prepare_refs`, :func:`prepare_queries`, :func:`_pack`), the host
re-rank :func:`exact_rerank` and the constants are copied unchanged, so the
packed operands are bit for bit the JAX package's and the certificate's
error bound ``D2_EPS`` holds for them:

- columns ``[0, F·B)``: the flattened categorical one-hots (0.5 on the
  reference side, so the product counts matches and ``F − matches`` is
  folded into the norm terms);
- six groups of Fc columns: the continuous values split into three bf16
  limbs (hi, lo, lo2) paired so that the product reproduces x·y to ~2⁻²⁶;
- three plus three norm columns carrying ‖x‖² + F and ‖y‖² as limbs.

The reference operand is multiplied by −2 (exact), so A·Bᵀ IS d²; pad
reference rows carry ``_PADC`` in their norm column, so they lose to every
real reference.

Two candidate kernels, hand-written in CUDA, each with its plain PyTorch
version beside it:

- :func:`knn_tourney` → ``csrc/knn_tourney.cu`` (replaces
  ``pallas_knn.py:290 _knn_tourney_kernel``, B5): per query row and
  2048-row reference segment, the two smallest int32 keys
  ``(bits(max(d², 0)) & ~2047) | column`` and the third smallest; plain
  version :func:`knn_tourney_ref`;
- :func:`knn_topk` → ``csrc/knn_topk.cu`` (replaces ``pallas_knn.py:73
  _knn_kernel``, B6): per query row the kk smallest (d², reference index),
  the references split into ranges (:func:`topk_splits`) whose lists a
  second kernel merges; plain version :func:`knn_topk_ref`, and
  :func:`knn_topk_merge_ref` for the merge alone.

:func:`search` is the counterpart of ``search_fused``: query pack, B5 or
B6 by the JAX package's route gate, assembly, exact re-rank and
certificate, all on the tensors' device.  On a CPU tensor a wrapper runs
its plain version; on a CUDA tensor it launches its kernel or raises.
Each wrapper counts its launches in ``launches``.

The port's tie rule: every route orders its final top-k by (exact d²,
reference index).  The re-rank computes d² in float64 in a fixed order and
rounds it to float32, so ``cuda`` and the CPU give the same bits, and sorts
index-ordered candidates stably.  Wherever the certificate holds, every
reference that could precede the k-th in that order is a candidate, so the
result does not depend on which kernel ran or how it broke ties among
approximate d².
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

# Block shapes of the JAX kernels, kept because the operand padding follows
# them: queries pad to TM rows, small reference sets to TN rows.
TM = 512
TN = 2048
SLOTS = 128
MARGIN = 8             # extra candidates kept beyond k for the exact re-rank
# Large finite sentinels — true infinities must never reach the product.
_BIG = 3.0e30          # "retired / empty slot" distance
_PADC = 1.0e30         # reference pad-row norm term: dominates any real d²
# Absolute d² error bound of the limb-split dot (see _limbs): each of the
# ~20 contributing terms is reproduced to ~2^-26 relative, magnitudes ≤ ~32.
D2_EPS = 1e-4
TB = 16384             # reference rows per tournament block (8 segments)
SEG = 2048             # certificate granularity: top-2 + third-min bound
# pad-lane key: the int32 bit pattern of _BIG (finite; NEVER 0x7fffffff,
# whose truncated bitcast is NaN and would poison every downstream min)
_PAD_KEY = int(np.float32(_BIG).view(np.int32))


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _bf16_round(x: np.ndarray) -> np.ndarray:
    """Round f32 → nearest-even bf16, returned as f32 (numpy lacks bf16)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    rounded = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return rounded.view(np.float32)


def _limbs(v: np.ndarray, n: int = 3):
    """Split f32 values into n bf16 limbs: v ≈ Σ limbs (each exactly
    representable in bf16), residual ~2^(-9n)·|v|."""
    out = []
    rem = v.astype(np.float32)
    for _ in range(n):
        hi = _bf16_round(rem)
        out.append(hi)
        rem = rem - hi
    return out


def _width(f: int, num_bins: int, fc: int) -> int:
    # cat | 6 cross-limb cont groups | 3+3 norm columns
    return _round_up(max(f * num_bins + 6 * fc + 6, 1), 128)


def used_lanes(f: int, num_bins: int, fc: int) -> int:
    """Columns of the packed operands that can be non-zero, :func:`_width`'s
    terms before its padding: F·B one-hot lanes, six limb groups of Fc
    and six norm columns.  Every column past them is zero in both
    operands."""
    return f * num_bins + 6 * fc + 6


def contraction_width(w: int, used: Optional[int]) -> int:
    """The columns a kernel contracts of operands W wide: ``used`` rounded
    up to the kernels' 64-column chunk, at most W (all of W where ``used``
    is None).  The skipped columns are zero in both operands, so they add
    exact zeros to every d²."""
    if used is None:
        return w
    return min(w, _round_up(max(used, 1), 64))


def _pack(codes: np.ndarray, cont01: np.ndarray, num_bins: int,
          rows: int, is_ref: bool, extra_norm) -> torch.Tensor:
    """Build the packed bf16 operand matrix (see module doc for layout) on
    the host."""
    n, f = codes.shape
    fc = cont01.shape[1]
    width = _width(f, num_bins, fc)
    mat = np.zeros((rows, width), np.float32)

    if f:
        r = np.repeat(np.arange(n), f)
        c = (np.arange(f) * num_bins)[None, :] + codes
        mat[r, c.ravel()] = 0.5 if is_ref else 1.0

    base = f * num_bins
    hi, lo, lo2 = _limbs(cont01) if fc else (None, None, None)
    norm = (cont01.astype(np.float64) ** 2).sum(axis=1).astype(np.float32)
    if fc:
        if is_ref:      # pairs: (hi,hi) (hi,lo) (lo,hi) (lo,lo) (hi,lo2) (lo2,hi)
            groups = [hi, lo, hi, lo, lo2, hi]
        else:
            groups = [hi, hi, lo, lo, hi, lo2]
        for g, arr in enumerate(groups):
            mat[:n, base + g * fc: base + (g + 1) * fc] = arr
    nb_ = base + 6 * fc

    if is_ref:
        colc = np.full(rows, np.float32(extra_norm), np.float32)
        colc[:n] = norm
        ch, cl, cl2 = _limbs(-0.5 * colc)
        mat[:, nb_ + 0] = ch
        mat[:, nb_ + 1] = cl
        mat[:, nb_ + 2] = cl2
        mat[:, nb_ + 3] = -0.5
        mat[:, nb_ + 4] = -0.5
        mat[:, nb_ + 5] = -0.5
        # fold the norm-expansion's −2 into the reference operand: ×−2 is
        # exact for every entry (one-hots, bf16 limbs, −0.5 constants), so
        # the kernel's dot IS d² with no per-block scale pass
        mat *= -2.0
    else:
        rowc = np.zeros(rows, np.float32)
        rowc[:n] = np.float32(extra_norm) + norm
        mat[:, nb_ + 0] = 1.0
        mat[:, nb_ + 1] = 1.0
        mat[:, nb_ + 2] = 1.0
        rh, rl, rl2 = _limbs(rowc)
        mat[:, nb_ + 3] = rh
        mat[:, nb_ + 4] = rl
        mat[:, nb_ + 5] = rl2
    # every entry is bf16-exact, so the conversion rounds nothing
    return torch.from_numpy(mat).to(torch.bfloat16)


def prepare_refs(codes: np.ndarray, cont01: np.ndarray, num_bins: int
                 ) -> Tuple[torch.Tensor, int]:
    """Packed reference operand [Npad, W] bf16 (on the CPU; the caller
    moves it once to its device).

    Sets larger than one tournament block round up to TB (a multiple of
    TN, so both kernels accept the operand); small sets — which can never
    fill the tournament's candidate pool and always route to B6 — round
    only to TN."""
    n = codes.shape[0]
    npad = _round_up(n, TB) if n > TB else _round_up(max(n, TN), TN)
    return _pack(codes, cont01, num_bins, npad, True, _PADC), n


def prepare_queries(codes: np.ndarray, cont01: np.ndarray, num_bins: int
                    ) -> Tuple[torch.Tensor, int]:
    """Packed query operand [Mpad, W] bf16 on the CPU.  The query's
    constant distance term is f (every categorical mismatch contributes
    ≤ f)."""
    m, f = codes.shape
    mpad = _round_up(max(m, TM), TM)
    return _pack(codes, cont01, num_bins, mpad, False, float(f)), m


def _limbs_dev(v: torch.Tensor, n: int = 3):
    """Tensor bf16 limb split (matches :func:`_limbs`: ``.to(bfloat16)``
    rounds to nearest-even exactly like _bf16_round)."""
    out = []
    rem = v.to(torch.float32)
    for _ in range(n):
        hi = rem.to(torch.bfloat16).to(torch.float32)
        out.append(hi)
        rem = rem - hi
    return out


def _pack_queries_dev(codes: torch.Tensor, cont01: torch.Tensor,
                      num_bins: int, rows: int, extra_norm: float
                      ) -> torch.Tensor:
    """Equivalent of ``_pack(..., is_ref=False)`` on the tensors' device:
    [rows, W] bf16.  ``codes``/``cont01`` may be shorter than ``rows``;
    the tail is zero (pad queries, whose results the caller drops).  The
    norm is summed column by column in float32, a fixed order, so ``cuda``
    and the CPU give the same bits."""
    n, f = codes.shape
    fc = cont01.shape[1]
    dev = codes.device
    width = _width(f, num_bins, fc)
    parts = []
    if f:
        onehot = (codes.long()[:, :, None]
                  == torch.arange(num_bins, device=dev)).to(torch.float32)
        parts.append(onehot.reshape(n, f * num_bins))
    x = cont01.to(torch.float32)
    if fc:
        hi, lo, lo2 = _limbs_dev(x)
        parts.extend([hi, hi, lo, lo, hi, lo2])
    norm = torch.zeros(n, dtype=torch.float32, device=dev)
    for j in range(fc):
        norm = norm + x[:, j] * x[:, j]
    rowc = torch.tensor(extra_norm, dtype=torch.float32, device=dev) + norm
    rh, rl, rl2 = _limbs_dev(rowc)
    ones = torch.ones(n, dtype=torch.float32, device=dev)
    parts.append(torch.stack([ones, ones, ones, rh, rl, rl2], dim=1))
    mat = torch.cat(parts, dim=1)
    mat = torch.nn.functional.pad(mat, (0, width - mat.shape[1], 0, rows - n))
    return mat.to(torch.bfloat16)


# ---------------------------------------------------------------------------
# the candidate kernels and their plain versions
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def full_float32():
    """float32 matrix products in full float32 on the card (no TF32), as
    the JAX package's ``precision="highest"`` asks; restores the flags."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])


def _d2_block(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """d² = A·Bᵀ in float32 from the bf16 operands widened to float32.
    Products of bf16 values are exact in float32, so only the order of
    the sums can differ from a kernel's."""
    with full_float32():
        return a.to(torch.float32) @ b.to(torch.float32).T


def _keys(d2: torch.Tensor, col0: int) -> torch.Tensor:
    """int32 sort keys ``(bits(max(d², 0)) & ~(SEG−1)) | column`` of a
    [M, cols] block whose first column is column ``col0`` of its segment.
    ``where(d2 > 0, d2, 0)`` maps −0.0 to +0."""
    pos = torch.where(d2 > 0, d2, torch.zeros((), dtype=d2.dtype,
                                                device=d2.device))
    col = (torch.arange(d2.shape[1], device=d2.device, dtype=torch.int32)
           + col0) & (SEG - 1)
    return (pos.view(torch.int32) & ~(SEG - 1)) | col


def _check_pair(a: torch.Tensor, b: torch.Tensor, what: str) -> None:
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(f"{what}: a [M, W] and b [N, W] needed, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise TypeError(f"{what}: operands must be bfloat16, got {a.dtype} "
                        f"and {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"{what}: a on {a.device}, b on {b.device}")


def _check_cuda(a: torch.Tensor, b: torch.Tensor, what: str, mrows: int,
                nrows: int) -> None:
    if a.device.type != "cuda":
        raise ValueError(f"{what} takes CPU or CUDA tensors, got {a.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{what} needs contiguous operands")
    if a.shape[1] % 64:
        raise ValueError(f"{what}: operand width {a.shape[1]} must be a "
                         f"multiple of 64")
    if a.shape[0] % mrows or b.shape[0] % nrows:
        raise ValueError(f"{what}: a rows must be a multiple of {mrows} and "
                         f"b rows of {nrows}, got {a.shape[0]} and "
                         f"{b.shape[0]}")


def knn_tourney_ref(a: torch.Tensor, b: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`knn_tourney`: a [M, W], b [N, W]
    bf16 (N a multiple of SEG) → (k1, k2, k3) [M, nbp] int32, the three
    smallest keys of every 2048-row segment; lanes ≥ N/SEG hold
    ``_PAD_KEY``.  Walks the references one TB block at a time.  Keys are
    unique within a segment (the column rides in the low bits), so the
    result is a function of d² alone."""
    m, n = a.shape[0], b.shape[0]
    nseg = n // SEG
    nbp = _round_up(max(nseg, 1), 128)
    out = [torch.full((m, nbp), _PAD_KEY, dtype=torch.int32, device=a.device)
           for _ in range(3)]
    for s0 in range(0, n, TB):
        blk = b[s0:s0 + TB]
        keys = _keys(_d2_block(a, blk), 0)
        segs = blk.shape[0] // SEG
        top = torch.topk(keys.view(m, segs, SEG), 3, dim=2, largest=False,
                         sorted=True).values
        for t in range(3):
            out[t][:, s0 // SEG:s0 // SEG + segs] = top[:, :, t]
    return out[0], out[1], out[2]


def knn_tourney(a: torch.Tensor, b: torch.Tensor, used: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """a [Mpad, W] bf16 queries (Mpad a multiple of TM), b [Npad, W] bf16
    references (Npad a multiple of SEG) → (k1, k2, k3) [Mpad, nbp] int32:
    for every query row and 2048-row reference segment the two smallest
    keys ``(bits(max(d², 0)) & ~2047) | column`` and the third smallest,
    nbp = round_up(Npad / 2048, 128); lanes past the segments hold
    ``_PAD_KEY``.  ``used`` is the operands' :func:`used_lanes`: the kernel
    contracts only :func:`contraction_width` columns (all W where None).

    On CUDA this launches ``csrc/knn_tourney.cu`` (B5, counted in
    ``knn_tourney.launches``); on the CPU it runs :func:`knn_tourney_ref`."""
    _check_pair(a, b, "knn_tourney")
    if a.device.type == "cpu":
        return knn_tourney_ref(a, b)
    _check_cuda(a, b, "knn_tourney", TM, SEG)
    m, n = a.shape[0], b.shape[0]
    nbp = _round_up(max(n // SEG, 1), 128)
    out = torch.full((3, m, nbp), _PAD_KEY, dtype=torch.int32, device=a.device)
    if m == 0 or n == 0:
        return out[0], out[1], out[2]
    lib = _kernel("knn_tourney")
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.knn_tourney(a.data_ptr(), b.data_ptr(), out[0].data_ptr(),
                              out[1].data_ptr(), out[2].data_ptr(), m, n,
                              a.shape[1], contraction_width(a.shape[1], used),
                              nbp, TOURNEY_KERNEL, stream)
    if err:
        raise RuntimeError(f"knn_tourney launch failed with CUDA error {err}")
    knn_tourney.launches += 1
    return out[0], out[1], out[2]


# the variant of csrc/knn_tourney.cu that is the kernel; the others are the
# decomposition probe's (probes.knn_tourney_probe)
TOURNEY_KERNEL = 2
knn_tourney.launches = 0               # B5


def knn_topk_ref(a: torch.Tensor, b: torch.Tensor, kk: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`knn_topk`: a [M, W], b [N, W] bf16
    → (d² [M, SLOTS] float32, idx [M, SLOTS] int32), the kk smallest by
    (d², reference index) ascending, slots ≥ kk at ``_BIG`` / −1.  Walks
    the references one TB block at a time, merging a running best list:
    a stable sort of [best, block] keeps the lower index first among
    equal d², since every index in ``best`` precedes the block's."""
    if not 1 <= kk <= SLOTS:
        raise ValueError(f"kk must be in [1, {SLOTS}], got {kk}")
    m, n = a.shape[0], b.shape[0]
    dev = a.device
    best_d = torch.empty((m, 0), dtype=torch.float32, device=dev)
    best_i = torch.empty((m, 0), dtype=torch.int32, device=dev)
    for s0 in range(0, n, TB):
        d2 = _d2_block(a, b[s0:s0 + TB])
        idx = (torch.arange(d2.shape[1], dtype=torch.int32, device=dev)
               + s0).expand(m, -1)
        cd = torch.cat([best_d, d2], dim=1)
        ci = torch.cat([best_i, idx], dim=1)
        order = torch.sort(cd, dim=1, stable=True).indices[:, :kk]
        best_d = torch.gather(cd, 1, order)
        best_i = torch.gather(ci, 1, order)
    out_d = torch.full((m, SLOTS), _BIG, dtype=torch.float32, device=dev)
    out_i = torch.full((m, SLOTS), -1, dtype=torch.int32, device=dev)
    out_d[:, :best_d.shape[1]] = best_d
    out_i[:, :best_i.shape[1]] = best_i
    return out_d, out_i


def knn_topk_merge_ref(part_d: torch.Tensor, part_i: torch.Tensor, kk: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the merge of ``csrc/knn_topk.cu``: S
    per-range lists part_d / part_i [S, M, kk] (each ascending by (d²,
    index), the indices of range s all below those of range s + 1) → the
    [M, SLOTS] outputs of :func:`knn_topk`, the kk smallest by (d², index).
    A stable sort over the lists in range order keeps the lower index of a
    tie."""
    s, m, k = part_d.shape
    cd = part_d.permute(1, 0, 2).reshape(m, s * k)
    ci = part_i.permute(1, 0, 2).reshape(m, s * k)
    order = torch.sort(cd, dim=1, stable=True).indices[:, :kk]
    out_d = torch.full((m, SLOTS), _BIG, dtype=torch.float32, device=cd.device)
    out_i = torch.full((m, SLOTS), -1, dtype=torch.int32, device=cd.device)
    out_d[:, :kk] = torch.gather(cd, 1, order)
    out_i[:, :kk] = torch.gather(ci, 1, order)
    return out_d, out_i


TOPK_MAX_SPLITS = 32    # reference ranges one merge warp takes
TOPK_REFS_PER_SLOT = 128  # references per range and kept slot, at least
TOPK_RESIDENT_ROWS = 32   # query rows per block where they stay resident


def topk_splits(m: int, n: int, kk: int, rows_per_block: int, slots: int,
                splits: Optional[int] = None) -> Tuple[int, int]:
    """B6's reference split → (S, tiles per range): the n / 128 reference
    tiles cut into S ranges of whole tiles, the last possibly shorter.
    Unless ``splits`` asks for a number, the m / rows_per_block query
    blocks times S fill the card's ``slots`` resident blocks (SMs × blocks
    per SM): where the queries stay resident the kk-lists dominate and S
    is the fewest ranges that fill it, a partial last wave included; where
    they stream (64 rows per block) the MMAs dominate and S is the most
    ranges within one wave.  Each range holds at least
    TOPK_REFS_PER_SLOT·kk references: every range refills its own kk-list.
    S stays within [1, min(32, tiles)]."""
    tiles = n // 128
    if splits is None:
        qblocks = max(m // rows_per_block, 1)
        fill = (-(-slots // qblocks) if rows_per_block == TOPK_RESIDENT_ROWS
                else slots // qblocks)
        splits = min(fill, n // (TOPK_REFS_PER_SLOT * kk))
    s = max(1, min(splits, TOPK_MAX_SPLITS, tiles))
    per = -(-tiles // s)
    return -(-tiles // per), per


def knn_topk(a: torch.Tensor, b: torch.Tensor, kk: int,
             splits: Optional[int] = None, used: Optional[int] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a [Mpad, W] bf16 queries (Mpad a multiple of TM), b [Npad, W] bf16
    references (Npad a multiple of TN) → (d² [Mpad, SLOTS] float32, idx
    [Mpad, SLOTS] int32): per row the kk ≤ SLOTS smallest by (d², reference
    index), ascending; slots ≥ kk hold ``_BIG`` / −1.  ``used`` is the
    operands' :func:`used_lanes`, as for :func:`knn_tourney`.

    On CUDA this launches ``csrc/knn_topk.cu`` (B6, counted in
    ``knn_topk.launches``) over the reference ranges of
    :func:`topk_splits` (``splits`` forces their number), merged on the
    card where there are several; on the CPU it runs :func:`knn_topk_ref`."""
    _check_pair(a, b, "knn_topk")
    if not 1 <= kk <= SLOTS:
        raise ValueError(f"kk must be in [1, {SLOTS}], got {kk}")
    if a.device.type == "cpu":
        return knn_topk_ref(a, b, kk)
    _check_cuda(a, b, "knn_topk", TM, TN)
    m, n = a.shape[0], b.shape[0]
    if m == 0 or n == 0:
        return (torch.full((m, SLOTS), _BIG, dtype=torch.float32, device=a.device),
                torch.full((m, SLOTS), -1, dtype=torch.int32, device=a.device))
    lib = _kernel("knn_topk")
    with torch.cuda.device(a.device):
        rows, slots = _topk_geometry(a.device.index, a.shape[1], kk)
        s, per = topk_splits(m, n, kk, rows, slots, splits)
        # the kernels write every slot; one allocation holds the outputs
        # and, where there are several ranges, their lists
        buf = torch.empty(2 * m * SLOTS + (2 * s * m * kk if s > 1 else 0),
                          dtype=torch.float32, device=a.device)
        out_d = buf[:m * SLOTS].view(m, SLOTS)
        out_i = buf[m * SLOTS:2 * m * SLOTS].view(torch.int32).view(m, SLOTS)
        part = buf.data_ptr() + 4 * 2 * m * SLOTS
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.knn_topk(a.data_ptr(), b.data_ptr(), out_d.data_ptr(),
                           out_i.data_ptr(), part if s > 1 else None,
                           part + 4 * s * m * kk if s > 1 else None,
                           m, n, a.shape[1],
                           contraction_width(a.shape[1], used), kk, s, per,
                           stream)
    if err:
        raise RuntimeError(f"knn_topk launch failed with CUDA error {err}")
    knn_topk.launches += 1
    return out_d, out_i


knn_topk.launches = 0                  # B6


@functools.lru_cache(maxsize=None)
def _topk_geometry(index: int, w: int, kk: int) -> Tuple[int, int]:
    """(query rows per block, blocks the card holds at once) of B6 on CUDA
    device ``index`` for width w and kk slots; the caller has made it the
    current device."""
    lib = _kernel("knn_topk")
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return (lib.knn_topk_rows_per_block(w),
            sms * lib.knn_topk_blocks_per_sm(w, kk))

# each kernel's C entry points and their argument types: pointers (and the
# stream) as c_void_p, ints as c_int
_ENTRY = {
    "knn_tourney": {"knn_tourney": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                    + [ctypes.c_void_p]},
    "knn_topk": {"knn_topk": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                 + [ctypes.c_void_p],
                 "knn_topk_rows_per_block": [ctypes.c_int],
                 "knn_topk_blocks_per_sm": [ctypes.c_int] * 2},
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


# ---------------------------------------------------------------------------
# the search: pack → kernel → assembly → exact re-rank → certificate
# ---------------------------------------------------------------------------

def use_tourney(n_real: int, npad: int, kk: int) -> bool:
    """The route gate of ``search_fused`` (``pallas_knn.py:548-549``): B5
    when enough real segments exist to fill the candidate pool and the
    operand is a whole number of TB blocks, else B6."""
    return 2 * -(-n_real // SEG) >= kk and npad % TB == 0


def _assemble_tourney(k1, k2, k3, kk: int):
    """B5's keys → (cand_d2 [M, kk] ascending, cand_idx [M, kk] int64,
    bound3 [M], third keys unpacked (d3, i3) [M, nbp]).  The kk best of
    the 2·nbp candidates are taken by (truncated d², reference index)."""
    nbp = k1.shape[1]
    dev = k1.device
    segmask = ~(SEG - 1)
    seg_base = torch.arange(nbp, dtype=torch.int64, device=dev) * SEG

    def unpack(key):
        return ((key & segmask).view(torch.float32),
                seg_base + (key & (SEG - 1)).long())

    d1, i1 = unpack(k1)
    d2, i2 = unpack(k2)
    d3, i3 = unpack(k3)
    cand_d = torch.cat([d1, d2], dim=1)
    cand_i = torch.cat([i1, i2], dim=1)
    # d ≥ 0, so its float bits order as integers: one int64 key per
    # candidate orders by (d, index)
    order = torch.sort((cand_d.view(torch.int32).long() << 32) | cand_i,
                       dim=1).indices[:, :kk]
    return (torch.gather(cand_d, 1, order), torch.gather(cand_i, 1, order),
            d3.min(dim=1).values, d3, i3)


def rerank_d2(codes_q: torch.Tensor, cont_q: torch.Tensor,
              codes_r: torch.Tensor, cont_r: torch.Tensor,
              idx: torch.Tensor, metric: str = "euclidean") -> torch.Tensor:
    """Exact distance sums of each query row against the references
    ``idx`` [M, K] (≥ 0): mismatches + Σ diff² (euclidean) or + Σ |diff|
    (manhattan), in float64 summed feature by feature in a fixed order and
    rounded once to float32 — the same bits on every device."""
    mism = (codes_q[:, None, :] != codes_r[idx]).sum(-1).to(torch.float64)
    acc = mism
    for j in range(cont_q.shape[1]):
        diff = (cont_q[:, j, None] - cont_r[idx, j]).to(torch.float64)
        acc = acc + (diff * diff if metric == "euclidean" else diff.abs())
    return acc.to(torch.float32)


def distances(sums: torch.Tensor, total_attrs: int,
              metric: str = "euclidean") -> torch.Tensor:
    """[0, 1] distances from exact sums: sqrt(sum / total) (euclidean) or
    sum / total, in float32 on the sums' device, correctly rounded so that
    every device gives the same bits.  The divisor is a 0-dim tensor on
    that device, not a Python scalar: CUDA divides by a host scalar through
    its reciprocal, by a tensor with a correctly rounded division, as the
    CPU does.  The CPU's float32 square root is not always correctly
    rounded, so the root is taken in float64 and rounded once (exact for a
    float32 argument)."""
    total = torch.tensor(float(max(total_attrs, 1)), dtype=torch.float32,
                         device=sums.device)
    d = sums.clamp_min(0.0) / total
    if metric == "euclidean":
        d = torch.sqrt(d.to(torch.float64)).to(torch.float32)
    return d.clamp(0.0, 1.0)


def rank_exact(d2: torch.Tensor, idx: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each row's candidates ordered by (exact d², reference index): a
    stable sort by d² over index-ordered candidates (never ``topk``, whose
    order among ties is unspecified).  Returns (d², idx) sorted."""
    by_idx = torch.sort(idx, dim=1, stable=True).indices
    d2, idx = torch.gather(d2, 1, by_idx), torch.gather(idx, 1, by_idx)
    order = torch.sort(d2, dim=1, stable=True).indices
    return torch.gather(d2, 1, order), torch.gather(idx, 1, order)


class Candidates(NamedTuple):
    """A candidate kernel's output, assembled: ``d2`` [M, kk] approximate
    d² ascending, ``idx`` [M, kk] int64 reference indices, ``bound`` [M]
    the least approximate d² a non-candidate can have, and for B5 ``third``
    = (d², index) [M, nbp] of every segment's third-smallest key."""
    d2: torch.Tensor
    idx: torch.Tensor
    bound: torch.Tensor
    third: Optional[Tuple[torch.Tensor, torch.Tensor]]


def assemble(out, m: int, kk: int) -> Candidates:
    """B5's keys (k1, k2, k3) or B6's (d², idx) slots → the first ``m``
    rows' :class:`Candidates`.  B5: the kk best of the 2·nbp candidates by
    (truncated d², index), and the least truncated third key as bound.
    B6: the kk kept slots, the kk-th being the bound."""
    if len(out) == 3:
        cand_d2, cand_idx, bound, d3, i3 = _assemble_tourney(
            out[0][:m], out[1][:m], out[2][:m], kk)
        return Candidates(cand_d2, cand_idx, bound, (d3, i3))
    cand_d2, cand_idx = out[0][:m, :kk], out[1][:m, :kk].long()
    return Candidates(cand_d2, cand_idx, cand_d2[:, -1], None)


def finish(codes_q: torch.Tensor, cont01_q: torch.Tensor,
           codes_r: torch.Tensor, cont01_r: torch.Tensor, n_real: int,
           cand: Candidates, k: int, total_attrs: int):
    """Exact re-rank of the candidates and the certificate → ([M, k]
    distances in [0, 1], [M, k] int64 indices, [M] bool certificate),
    ordered by (exact d², index)."""
    kk = cand.idx.shape[1]
    eps = D2_EPS if cont01_q.shape[1] else 0.0
    # pad reference rows (index ≥ n_real) would gather out of bounds: mark
    # unseen. A pad in the slots also implies every real ref is a candidate.
    cand_idx = torch.where(cand.idx >= n_real, -1, cand.idx)
    pad_last = cand_idx[:, -1] < 0
    d2 = rerank_d2(codes_q, cont01_q.to(torch.float32), codes_r, cont01_r,
                   cand_idx.clamp_min(0))
    d2 = torch.where(cand_idx < 0, torch.full_like(d2, _BIG), d2)
    d2s, idxs = rank_exact(d2, cand_idx)
    kth_at = min(k, kk) - 1
    kth = d2s[:, kth_at]
    # certificate: nothing outside the candidate set can beat the k-th
    # exact candidate — non-candidates are ≥ both the kk-th approx
    # candidate and (B5) every segment's third-smallest
    cert = kth <= torch.minimum(cand.d2[:, -1], cand.bound) - 2 * eps
    if cand.third is None:
        # B6 only: a pad in the last slot proves every real ref was kept
        # (all real d² beat _PADC). On the B5 route a pad in the pool
        # merely means some segment ran short of real rows — segments
        # still hide non-candidates, so the bound term must decide.
        cert = cert | pad_last
    elif eps == 0.0:
        # exact d² (categorical only): a segment's third may EQUAL the k-th
        # and hide a lower index, so its (d², index) must follow the k-th's
        d3, i3 = cand.third
        cert &= ((d3 > kth[:, None])
                 | ((d3 == kth[:, None])
                    & (i3 > idxs[:, kth_at, None]))).all(dim=1)
    return distances(d2s[:, :k], total_attrs), idxs[:, :k], cert


def search(codes_q: torch.Tensor, cont01_q: torch.Tensor, r_mat: torch.Tensor,
           codes_r: torch.Tensor, cont01_r: torch.Tensor, n_real: int,
           num_bins: int, k: int, total_attrs: int, margin: int = MARGIN):
    """Exact search of one query batch on the tensors' device (the
    counterpart of ``search_fused``).  codes_q [M, F] int32, cont01_q
    [M, Fc] float32, r_mat the packed references, codes_r / cont01_r the
    reference rows for the re-rank.  Returns ([M, k] distances in [0, 1],
    [M, k] int64 reference indices, [M] bool certificate) ordered by
    (exact d², index); a row whose certificate is False must be served by
    the exact scan."""
    m, f = codes_q.shape
    kk = min(k + margin, SLOTS)
    rows = _round_up(max(m, TM), TM)
    q_mat = _pack_queries_dev(codes_q, cont01_q, num_bins, rows, float(f))
    used = used_lanes(f, num_bins, cont01_q.shape[1])
    if use_tourney(n_real, r_mat.shape[0], kk):
        out = knn_tourney(q_mat, r_mat, used=used)
    else:
        out = knn_topk(q_mat, r_mat, kk, used=used)
    return finish(codes_q, cont01_q, codes_r, cont01_r, n_real,
                  assemble(out, m, kk), k, total_attrs)


def topk_candidates(q_mat: torch.Tensor, r_mat: torch.Tensor, k: int,
                    margin: int = MARGIN) -> Tuple[np.ndarray, np.ndarray]:
    """[Mpad, k+margin] (approx d², ref indices) from B6, ascending by
    (approx d², index)."""
    kk = min(k + margin, SLOTS)
    d2, idx = knn_topk(q_mat, r_mat, kk)
    return d2[:, :kk].cpu().numpy(), idx[:, :kk].cpu().numpy()


def exact_rerank(cand_idx: np.ndarray, cand_d2: np.ndarray,
                 codes_q: np.ndarray, cont_q: np.ndarray,
                 codes_r: np.ndarray, cont_r: np.ndarray,
                 k: int, total_attrs: int, eps: float | None = None,
                 n_real: int | None = None
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Exact f32 re-rank of the kernel's k' candidates (host, numpy).

    Returns ([M, k] distances in [0,1], [M, k] indices, [M] certificate):
    certificate[i] is True when the exact top-k of row i is guaranteed
    (k-th exact candidate d² ≤ k'-th approx d² − 2·eps, so no non-candidate
    can beat it). Rows with certificate False must fall back to the exact
    scan path. With no continuous features the kernel's bf16 arithmetic is
    exact — pass eps=0 so integer-distance ties still certify.
    """
    if eps is None:
        eps = D2_EPS if cont_q.shape[1] else 0.0
    if n_real is None:
        n_real = codes_r.shape[0]
    # pad rows (d² ≈ _PADC) can land in candidate slots when the reference
    # set is barely larger than k' — their indices point past n_real and
    # would index codes_r out of bounds; mark them unseen. A pad in the
    # slots also means every real reference is already among the candidates
    # (all real d² beat _PADC), which the certificate below relies on.
    cand_idx = np.where(cand_idx >= n_real, -1, cand_idx)
    m, kk = cand_idx.shape
    safe_idx = np.maximum(cand_idx, 0)
    mism = (codes_q[:, None, :] != codes_r[safe_idx]).sum(-1).astype(np.float32)
    diff = cont_q[:, None, :] - cont_r[safe_idx]
    d2 = mism + (diff * diff).sum(-1)
    d2[cand_idx < 0] = _BIG
    order = np.argsort(d2, axis=1, kind="stable")
    d2s = np.take_along_axis(d2, order, axis=1)
    idxs = np.take_along_axis(cand_idx, order, axis=1)
    kth = d2s[:, min(k, kk) - 1]
    cert = kth <= cand_d2[:, -1] - 2 * eps
    cert |= cand_idx[:, -1] < 0          # fewer refs than k': all seen
    d = np.sqrt(np.maximum(d2s[:, :k], 0.0) / max(total_attrs, 1))
    return np.clip(d, 0.0, 1.0), idxs[:, :k], cert
