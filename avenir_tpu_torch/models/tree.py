"""Decision-tree induction — port of ``avenir_tpu/models/tree.py``
(candidate-split search + frontier growth) and its RandomForest.

Capability parity with the reference's tree stack (explore/
ClassPartitionGenerator.java, util/AttributeSplitStat.java,
tree/SplitGenerator.java + DataPartitioner.java), grown as the JAX package
grows it: the whole frontier lives in memory, each row carries a node id on
the device, and one level table [F, B, K, C] (feature bin × frontier node ×
class counts) per level feeds every candidate split's histogram.

The level table is built on one of three routes, chosen as the JAX package
chooses them, with "the tensors live on CUDA" in place of "a single TPU":

- ``cross``: the cross-count kernel ``csrc/cross.cu`` (B4, through
  ``ops/hist.cross_cooc_counts_cols``) whenever ``cross_applicable(F, B,
  K·C)`` holds on CUDA;
- ``packed``: a PackGraft disjoint pack of the frontier, one wide gram
  through ``ops/hist.cooc_counts_cols`` in whatever mode ``plan()`` picks
  for the joint shape (B1, B2 or B3 on CUDA; the plain gram on the CPU with
  ``level_packed="on"``);
- ``plain``: an integer bincount over the composite (feature, bin,
  node·C + class) index (:func:`node_bin_class_counts`), the JAX package's
  einsum route.

Every route gives the same integer table.  Scores are float32, so across
packages and devices they agree to rounding (abs 1e-6), not bit for bit;
ties are broken toward the lowest flat candidate index everywhere (a stable
descending sort stands in for ``lax.top_k``).
"""

from __future__ import annotations

import json
import math
import time
from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from avenir_tpu_torch.core.encoding import EncodedDataset
from avenir_tpu_torch.device import resolve_device
from avenir_tpu_torch.ops import agg, hist, info
from avenir_tpu_torch.parallel.collectives import per_shard, shard_sum
from avenir_tpu_torch.parallel.mesh import mesh_on_cuda, place_batch
from avenir_tpu_torch.telemetry import profile as _profile
from avenir_tpu_torch.telemetry.spans import CompileKeyMonitor
from avenir_tpu_torch.utils.metrics import ConfusionMatrix, Counters

ALGORITHMS = ("entropy", "giniIndex", "hellingerDistance", "classConfidenceRatio")

# level-table / split-histogram strategy (``tree.hist.mode``): ``direct``
# contracts the whole frontier per level; ``cumsum`` scores binary
# thresholds from one bin-axis prefix sum of the table; ``subtract`` adds
# sibling-subtraction level tables (only the smaller children of each split
# are counted, each largest sibling is its parent's slice minus them).  All
# three grow the same tree.
HIST_MODES = ("direct", "cumsum", "subtract")


# ---------------------------------------------------------------------------
# candidate splits
# ---------------------------------------------------------------------------

@dataclass
class CandidateSplit:
    """A way to segment one binned attribute.

    ``seg_of_bin[b]`` maps the attribute's bin code to a segment index —
    the device-friendly compilation of the reference's
    AttributeSplitHandler.Split containers (IntegerSplit: segment = first
    split point ≥ value :135-168; CategoricalSplit: group membership
    :174-234). ``key`` is a human-readable split id in the same spirit as the
    reference's serialized split keys.
    """

    attr: int
    kind: str                    # "numeric" | "categorical"
    seg_of_bin: np.ndarray       # [B] int32
    num_segments: int
    key: str


def enumerate_numeric_splits(
    n_bins: int, max_split: int, pad_bins: int, max_candidates: int = 512,
) -> List[Tuple[Tuple[int, ...], np.ndarray]]:
    """All increasing threshold tuples (1..max_split−1 points) on the bin grid.

    A threshold t means codes < t go left of that point; k thresholds make
    k+1 segments. Mirrors createNumPartitions' recursion over the bucketWidth
    grid (thresholds here are bin indices; bin b ≡ grid value offset+b)."""
    out: List[Tuple[Tuple[int, ...], np.ndarray]] = []

    def seg_map(thresholds: Tuple[int, ...]) -> np.ndarray:
        segs = np.zeros(pad_bins, np.int32)
        arange = np.arange(pad_bins)
        for t in thresholds:
            segs += (arange >= t).astype(np.int32)
        return segs

    def rec(prev: Tuple[int, ...]):
        if len(out) >= max_candidates or len(prev) >= max_split - 1:
            return
        start = (prev[-1] + 1) if prev else 1
        for t in range(start, n_bins):
            cur = prev + (t,)
            out.append((cur, seg_map(cur)))
            if len(out) >= max_candidates:
                return
            rec(cur)

    rec(())
    return out


def enumerate_categorical_partitions(
    n_values: int, max_split: int, pad_bins: int, max_candidates: int = 512,
) -> List[Tuple[Tuple[int, ...], np.ndarray]]:
    """All partitions of value indices into 2..max_split groups, via
    restricted-growth strings (canonical set-partition enumeration — the
    counterpart of createCatPartitions' group shuffling)."""
    out: List[Tuple[Tuple[int, ...], np.ndarray]] = []

    def rec(prefix: List[int], used: int):
        if len(out) >= max_candidates:
            return
        if len(prefix) == n_values:
            groups = used + 1
            if 2 <= groups <= max_split:
                segs = np.zeros(pad_bins, np.int32)
                segs[:n_values] = prefix
                # OOV / padding bins fall into segment 0
                out.append((tuple(prefix), segs))
            return
        for g in range(min(used + 1, max_split - 1) + 1):
            rec(prefix + [g], max(used, g))

    rec([0], 0)   # first value always group 0 (canonical form)
    return out


def generate_candidate_splits(
    ds: EncodedDataset,
    max_split: int = 3,
    is_categorical: Optional[Sequence[bool]] = None,
    max_candidates_per_attr: int = 256,
    attrs: Optional[Sequence[int]] = None,
) -> Dict[int, List[CandidateSplit]]:
    """Enumerate splits for each binned attribute (host-side, tiny)."""
    b = ds.max_bins
    result: Dict[int, List[CandidateSplit]] = {}
    attr_list = list(attrs) if attrs is not None else list(range(ds.num_binned))
    for a in attr_list:
        nb = int(ds.n_bins[a])
        cat = bool(is_categorical[a]) if is_categorical is not None else True
        splits: List[CandidateSplit] = []
        if cat:
            # exclude the reserved OOV slot from the partitioned value set
            for prefix, segs in enumerate_categorical_partitions(
                    max(nb - 1, 1), max_split, b, max_candidates_per_attr):
                key = f"attr{a}:cat:{''.join(map(str, prefix))}"
                splits.append(CandidateSplit(a, "categorical", segs,
                                             int(segs[:max(nb - 1, 1)].max()) + 1, key))
        else:
            for thresholds, segs in enumerate_numeric_splits(
                    nb, max_split, b, max_candidates_per_attr):
                key = f"attr{a}:num:{','.join(map(str, thresholds))}"
                splits.append(CandidateSplit(a, "numeric", segs, len(thresholds) + 1, key))
        result[a] = splits
    return result


def candidate_splits_for(
    ds: EncodedDataset,
    split_search: str,
    max_split: int,
    is_categorical: Optional[Sequence[bool]],
    max_candidates_per_attr: int = 256,
    attrs: Optional[Sequence[int]] = None,
) -> Dict[int, List[CandidateSplit]]:
    """The ONE mapping from ``split_search`` to a candidate family, shared
    by DecisionTree.fit and the ClassPartitionGenerator / DataPartitioner
    jobs — the same enumeration must produce the same keys everywhere or
    DataPartitioner's split-key lookup breaks.  ``binary`` = one sorted
    threshold on the bin-code grid for EVERY attribute (ordinal
    semantics, sklearn's candidate family); ``exhaustive`` = the
    reference's multi-way numeric/categorical enumeration."""
    if split_search == "binary":
        return generate_candidate_splits(
            ds, 2, [False] * ds.num_binned, max_candidates_per_attr,
            attrs=attrs)
    return generate_candidate_splits(
        ds, max_split, is_categorical, max_candidates_per_attr, attrs=attrs)


# ---------------------------------------------------------------------------
# the level table
# ---------------------------------------------------------------------------

def _int_contract(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 einsum of integer operands: float64 holds every count
    and partial sum here exactly (all are below 2^53), and CUDA has no
    integer matmul."""
    return torch.einsum(eq, a.to(torch.float64), b.to(torch.float64)).to(
        torch.int32)


def node_bin_class_counts(codes: torch.Tensor, node_ids: torch.Tensor,
                          labels: torch.Tensor, num_nodes: int,
                          num_classes: int, num_bins: int) -> torch.Tensor:
    """codes [N, F], node_ids [N] (frontier-local, −1 = settled), labels
    [N] → [F, B, K, C] int32 per-(feature bin, frontier node, class) counts:
    one integer bincount over the composite (f·B + bin)·K·C + node·C + class
    index.  Settled rows, out-of-range labels and out-of-range codes drop
    out, as the JAX einsum's zero one-hot rows do."""
    f = codes.shape[1]
    c = num_classes
    kc = num_nodes * c
    valid = (node_ids >= 0) & (labels >= 0) & (labels < c)
    comp = torch.where(valid, node_ids.long() * c + labels.long(), -1)
    keep = (comp >= 0)[:, None] & (codes >= 0) & (codes < num_bins)
    feat = torch.arange(f, device=codes.device)[None, :]
    idx = (feat * num_bins + codes.long()) * kc + comp[:, None]
    t = torch.bincount(idx[keep], minlength=f * num_bins * kc)
    return t.to(torch.int32).reshape(f, num_bins, num_nodes, c)


def _level_table_cross(codes_t: torch.Tensor, node_ids: torch.Tensor,
                       labels: torch.Tensor, num_nodes: int, num_classes: int,
                       num_bins: int) -> torch.Tensor:
    """The level table through the cross-count kernel (B4 on CUDA):
    selector = node·C + class, −1 for settled rows and invalid labels."""
    c = num_classes
    valid = (node_ids >= 0) & (labels >= 0) & (labels < c)
    sel = torch.where(valid, node_ids * c + labels, -1).to(torch.int32)
    t = hist.cross_cooc_counts_cols(codes_t, sel, num_bins, num_nodes * c)
    return t.reshape(t.shape[0], t.shape[1], num_nodes, c)


def _level_table_packed(codes_t: torch.Tensor, node_ids: torch.Tensor,
                        labels: torch.Tensor, pplan) -> torch.Tensor:
    """The level table through a PackGraft disjoint pack: the K frontier
    nodes' [F, B, C] tables ride one wide gram over K bin stripes
    (composite code = code + node·stripe_bins), read out on the pack's
    diagonal — per class in the cls modes.  Rows off the frontier (node −1)
    drop whole and out-of-range codes drop per feature.  Returns
    [F, B, K, C] int32."""
    comp = hist.packed_codes(codes_t, node_ids, pplan.stripe_bins,
                             pplan.members[0].num_bins)
    # the gram takes chunks below agg's exact-count cap; a fit holds all its
    # rows, so longer ones are counted block by block (int32 sums stay
    # exact: counts ≤ N < 2^31)
    n = comp.shape[1]
    step = agg.MAX_EXACT_CHUNK_ROWS - 1
    g = None
    for s in range(0, max(n, 1), step):
        part = hist.cooc_counts_cols(comp[:, s:s + step].contiguous(),
                                     labels[s:s + step], pplan.num_bins,
                                     pplan.num_classes)
        g = part if g is None else g + part
    wi = torch.as_tensor(hist.packed_diag_index(pplan), device=g.device)
    if g.dim() == 3:                         # cls/clsb: per-class diagonal
        w2 = wi[..., 0]                      # [F, B, K] — same cell per class
        t = torch.movedim(g[:, w2, w2], 0, -1)
    else:                                    # fmaj/jmaj: class rides the cell
        t = g[wi, wi]
    return t.to(torch.int32)


def _remap_nodes(node: torch.Tensor, remap: torch.Tensor) -> torch.Tensor:
    """[N] absolute node ids → frontier-local indices (−1 = settled)."""
    return remap[node.clamp(min=0).long()]


def _apply_level_partition(codes: torch.Tensor, node: torch.Tensor,
                           remap: torch.Tensor, attr: torch.Tensor,
                           child_tab: torch.Tensor) -> torch.Tensor:
    """Device-side frontier partition: rows of frontier node ki whose
    level-chosen split routes bin b to child ``child_tab[ki, b]`` move
    there; settled rows and unsplit frontier rows (child −1) keep their id.
    A negative code wraps by +B and any code is then clipped to [0, B) —
    the JAX indexing semantics, reproduced exactly."""
    local = _remap_nodes(node, remap)
    lc = local.clamp(min=0).long()
    a = attr[lc].long()
    code = codes.gather(1, a[:, None])[:, 0]
    b = child_tab.shape[1]
    code = torch.where(code < 0, code + b, code).clamp(0, b - 1).long()
    new = child_tab[lc, code]
    return torch.where((local >= 0) & (new >= 0), new, node)


def split_histograms_from_table(table_a: np.ndarray,
                                chunk: Sequence["CandidateSplit"],
                                gmax: int) -> np.ndarray:
    """table_a [B, K, C] (one attribute's slice of the level table) →
    [S, G, K, C] histograms for a chunk of candidate splits — pure host
    numpy over segment maps; no N-dependent work."""
    seg_tab = np.stack([sp.seg_of_bin for sp in chunk])          # [S, B]
    m = (seg_tab[:, None, :] == np.arange(gmax)[None, :, None])  # [S, G, B]
    return np.einsum("sgb,bkc->sgkc", m, table_a)


def _chunk_seg_mask(chunk: Sequence["CandidateSplit"], gmax: int) -> np.ndarray:
    """[S, G] validity mask: segment g is real for split s iff
    g < num_segments — shared by the host and device scoring paths so
    padded segments never leak into a score (classConfidenceRatio is the
    one algorithm not zero-count-invariant: an empty padded segment would
    contribute confidence (0+1)/(0+1) = 1, making the score depend on
    which splits happened to share a chunk/padding width)."""
    nsegs = np.array([sp.num_segments for sp in chunk], np.int32)
    return nsegs[:, None] > np.arange(gmax, dtype=np.int32)[None, :]


def iter_scored_splits(table: np.ndarray, all_splits, algorithm: str,
                       split_chunk: int, attrs=None, parent_info=None):
    """Yield (attr, chunk, scores [S, K], hist [S, G, K, C]) per candidate
    split chunk, all derived from the level table on the host CPU — the
    host pipeline behind ``selection="host"``."""
    for a in (attrs if attrs is not None else sorted(all_splits)):
        splits = all_splits[a]
        if not splits:
            continue
        for s0 in range(0, len(splits), split_chunk):
            chunk = splits[s0:s0 + split_chunk]
            gmax = max(sp.num_segments for sp in chunk)
            h = split_histograms_from_table(table[a], chunk, gmax)
            # the host pipeline (selection="host"): CPU tensors, .numpy() is a
            # view and syncs nothing
            # graftlint: disable=GL005
            scores = split_scores(
                torch.as_tensor(h).to(torch.float32), algorithm,
                parent_info=parent_info,
                seg_mask=torch.as_tensor(_chunk_seg_mask(chunk, gmax))).numpy()
            yield a, chunk, scores, h


def split_scores(hist_: torch.Tensor, algorithm: str,
                 parent_info: Optional[float] = None,
                 seg_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """hist [S, G, K, C] → score [S, K] float32; higher is better for every
    algorithm.

    entropy/giniIndex → gain ratio: (parent impurity − weighted child
    impurity) / split info content (AttributeSplitStat.java:85-93,153-218);
    ``parent_info`` substitutes the reference's externally supplied
    ``parent.info`` for the parent impurity.  hellingerDistance → distance
    between the per-class segment distributions (binary class, :228-284).
    classConfidenceRatio → negated entropy of the normalized per-segment
    class-confidence ratios (:291-339).  ``seg_mask`` [S, G] marks the real
    segments of each split: only classConfidenceRatio, whose +1 smoothing
    would count padded segments, needs it.

    The statistics are computed in float64 and returned as float32.  A gain
    is a small difference of two entropies, so float32 arithmetic loses
    up to ~1e-6 of it, differently on every backend; in float64 the
    result is the float32 rounding of the exact score on the CPU and on
    CUDA alike, and the JAX package's float32 scores lie within their own
    rounding error of it."""
    return _split_scores64(hist_.to(torch.float64), algorithm, parent_info,
                           seg_mask).to(torch.float32)


def _split_scores64(h: torch.Tensor, algorithm: str,
                    parent_info: Optional[float],
                    seg_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """:func:`split_scores` on a float64 [S, G, K, C] histogram."""
    seg_tot = h.sum(-1)                                   # [S, G, K]
    node_tot = torch.clamp(seg_tot.sum(1), min=1e-9)      # [S, K]
    w = seg_tot / node_tot[:, None, :]                    # segment weights
    parent = h.sum(1)                                     # [S, K, C]
    if algorithm in ("entropy", "giniIndex"):
        imp = (info.entropy_from_counts if algorithm == "entropy"
               else info.gini_from_counts)
        child = imp(h, axis=-1)                           # [S, G, K]
        weighted = (w * child).sum(1)                     # [S, K]
        p_imp = (imp(parent, axis=-1) if parent_info is None
                 else torch.tensor(parent_info, dtype=h.dtype,
                                   device=h.device))
        gain = p_imp - weighted
        split_info = info.entropy(w.transpose(1, 2), axis=-1)   # [S, K]
        return gain / torch.clamp(split_info, min=1e-6)
    if algorithm == "hellingerDistance":
        cls_tot = torch.clamp(h.sum(1, keepdim=True), min=1e-9)  # [S, 1, K, C]
        p_seg_given_c = h / cls_tot                               # [S, G, K, C]
        d = (torch.sqrt(p_seg_given_c[..., 0])
             - torch.sqrt(p_seg_given_c[..., 1])) ** 2
        return torch.sqrt(torch.clamp(d.sum(1), min=0.0)) / math.sqrt(2.0)
    if algorithm == "classConfidenceRatio":
        conf = (h[..., 0] + 1.0) / (h[..., 1] + 1.0)              # [S, G, K]
        if seg_mask is not None:
            conf = torch.where(seg_mask[:, :, None], conf, 0.0)
        ratio = conf / torch.clamp(conf.sum(1, keepdim=True), min=1e-9)
        return -info.entropy(ratio.transpose(1, 2), axis=-1)
    raise ValueError(f"unknown algorithm {algorithm!r}; known: {ALGORITHMS}")


# ---------------------------------------------------------------------------
# device-resident split selection
# ---------------------------------------------------------------------------

@dataclass
class FlatSplits:
    """Per-fit candidate-split metadata as padded device tensors.

    ``splits`` holds the CandidateSplit objects in flat order — ascending
    attribute, then enumeration order — the order the host path iterates,
    so picking the lowest flat index among equal scores reproduces the
    host's stable sort.  Pad rows (``valid`` False) are masked to −inf."""

    splits: List[CandidateSplit]
    attr_of: np.ndarray                  # [S_pad] int32 (host copy, for masks)
    valid: np.ndarray                    # [S_pad] bool — False on pad rows
    gmax: int
    chunk: int
    seg_tab_dev: torch.Tensor            # [S_pad, B] int32
    attr_dev: torch.Tensor               # [S_pad] int32
    nseg_dev: torch.Tensor               # [S_pad] int32
    # thr_of[s] = the single sorted threshold of split s (0 on pad rows),
    # meaningful when ``all_binary``: every real split is a two-segment
    # numeric threshold (codes < t left) — the split.search=binary family
    thr_of: np.ndarray = dc_field(default_factory=lambda: np.zeros(0, np.int32))
    thr_dev: Optional[torch.Tensor] = None
    all_binary: bool = False

    @property
    def num_real(self) -> int:
        return len(self.splits)

    def allow_vector(self, attrs: Sequence[int]) -> np.ndarray:
        """[S_pad] bool — splits whose attribute the level's strategy
        selected, excluding pad rows."""
        return self.valid & np.isin(
            self.attr_of, np.asarray(list(attrs), np.int32))


def flatten_splits(all_splits: Dict[int, List[CandidateSplit]],
                   max_bins: int, split_chunk: int,
                   device=None) -> FlatSplits:
    """The per-attr candidate dict as FlatSplits tensors on ``device``."""
    flat = [sp for a in sorted(all_splits) for sp in all_splits[a]]
    s = len(flat)
    gmax = max([sp.num_segments for sp in flat] or [1])
    chunk = max(1, min(split_chunk, max(s, 1)))
    s_pad = max(-(-s // chunk) * chunk, chunk)
    seg_tab = np.zeros((s_pad, max_bins), np.int32)
    attr_of = np.zeros(s_pad, np.int32)
    nseg = np.ones(s_pad, np.int32)
    valid = np.zeros(s_pad, bool)
    thr = np.zeros(s_pad, np.int32)
    all_binary = s > 0
    for i, sp in enumerate(flat):
        seg_tab[i] = sp.seg_of_bin
        attr_of[i] = sp.attr
        nseg[i] = sp.num_segments
        valid[i] = True
        t = int(np.argmax(sp.seg_of_bin == 1)) if sp.num_segments == 2 else 0
        if (sp.kind == "numeric" and sp.num_segments == 2 and t > 0
                and np.array_equal(
                    sp.seg_of_bin,
                    (np.arange(len(sp.seg_of_bin)) >= t).astype(np.int32))):
            thr[i] = t
        else:
            all_binary = False
    dev = torch.device("cpu") if device is None else torch.device(device)
    return FlatSplits(
        splits=flat, attr_of=attr_of, valid=valid, gmax=gmax, chunk=chunk,
        seg_tab_dev=torch.as_tensor(seg_tab, device=dev),
        attr_dev=torch.as_tensor(attr_of, device=dev),
        nseg_dev=torch.as_tensor(nseg, device=dev), thr_of=thr,
        thr_dev=torch.as_tensor(thr, device=dev), all_binary=all_binary)


def _scored_chunks(table: torch.Tensor, seg_tab: torch.Tensor,
                   attr_of: torch.Tensor, nseg: torch.Tensor, algorithm: str,
                   gmax: int, chunk: int, parent_info=None,
                   want_hist: bool = False,
                   thr: Optional[torch.Tensor] = None, binary: bool = False):
    """Score every padded candidate split against the level table in
    ``chunk``-sized blocks (bounding the [s, B, K, C] gather).  Returns
    scores [S_pad, K] and, with ``want_hist``, the [S_pad, G, K, C] int32
    histograms.  With ``binary`` (every candidate one sorted threshold),
    each histogram is two gathers against one bin-axis cumsum of the table
    instead of the segment contraction — the same integers."""
    s_pad = seg_tab.shape[0]
    grange = torch.arange(gmax, dtype=torch.int32, device=seg_tab.device)
    if binary and gmax != 2:
        raise ValueError("the binary cumsum path needs two-segment splits")
    cum = info.cumulative_level_table(table) if binary else None
    scores, hists = [], []
    for s0 in range(0, s_pad, chunk):
        ao = attr_of[s0:s0 + chunk].long()
        ns = nseg[s0:s0 + chunk]
        if binary:
            h = info.binary_split_histograms(cum, ao, thr[s0:s0 + chunk].long())
        else:
            h = info.split_segment_histograms(table, seg_tab[s0:s0 + chunk],
                                              ao, gmax)
        mask = grange[None, :] < ns[:, None]                  # [s, G]
        scores.append(split_scores(h, algorithm, parent_info=parent_info,
                                   seg_mask=mask))
        if want_hist:
            hists.append(h)
    return (torch.cat(scores), torch.cat(hists) if want_hist else None)


def _device_select_splits(table: torch.Tensor, seg_tab: torch.Tensor,
                          attr_of: torch.Tensor, nseg: torch.Tensor,
                          allow: torch.Tensor,
                          thr: Optional[torch.Tensor] = None, *,
                          algorithm: str, gmax: int, top_k: int, chunk: int,
                          binary: bool = False):
    """Split selection for one frontier level on the table's device: every
    candidate's histogram and score, then the top-k winners PER FRONTIER
    NODE.  Returns (vals [K, P], idx [K, P], hist [K, P, G, C] int32),
    best first.  Ties go to the lowest flat index, as ``lax.top_k`` breaks
    them in the JAX package: a stable descending sort, not ``torch.topk``,
    which promises no order among equal values.  Disallowed and pad
    candidates come back as −inf."""
    scores, _ = _scored_chunks(table, seg_tab, attr_of, nseg, algorithm,
                               gmax, chunk, thr=thr, binary=binary)
    scores = torch.where(allow[:, None] & ~torch.isnan(scores), scores,
                         -math.inf)
    order = torch.sort(scores.T, dim=1, descending=True, stable=True)
    vals, idx = order.values[:, :top_k], order.indices[:, :top_k]  # [K, P]
    k = table.shape[2]
    grange = torch.arange(gmax, dtype=torch.int32, device=table.device)
    tt = table.permute(2, 0, 1, 3)                            # [K, F, B, C]
    w_ta = tt[torch.arange(k, device=table.device)[:, None],
              attr_of[idx].long()]                            # [K, P, B, C]
    w_m = (seg_tab[idx][:, :, None, :]
           == grange[None, None, :, None])                    # [K, P, G, B]
    w_hist = _int_contract("kpgb,kpbc->kpgc", w_m, w_ta)
    return vals, idx, w_hist


def _device_score_all(table: torch.Tensor, seg_tab: torch.Tensor,
                      attr_of: torch.Tensor, nseg: torch.Tensor, parent_info,
                      thr: Optional[torch.Tensor] = None, *, algorithm: str,
                      gmax: int, chunk: int, want_hist: bool = False,
                      binary: bool = False):
    """Score EVERY candidate split: (scores [S_pad, K], hist
    [S_pad, G, K, C] or None) — the ClassPartitionGenerator job's entry,
    whose contract is the full scored list.  ``parent_info`` None means
    the node's own impurity."""
    return _scored_chunks(table, seg_tab, attr_of, nseg, algorithm, gmax,
                          chunk, parent_info=parent_info,
                          want_hist=want_hist, thr=thr, binary=binary)


def _assemble_subtract_table(direct_table: torch.Tensor,
                             prev_table: torch.Tensor, dslot: torch.Tensor,
                             pslot: torch.Tensor,
                             sib_mat: torch.Tensor) -> torch.Tensor:
    """Sibling-subtraction level table (``tree.hist.mode`` subtract): node
    k is either direct (``dslot[k]`` ≥ 0 → its own slice of the [F, B, D, C]
    direct table) or derived: its parent's previous-level slice
    (``pslot[k]``) minus its directly counted siblings (``sib_mat[k]``, a
    one-hot over direct slots).  Exact in integers."""
    direct_part = direct_table[:, :, dslot.clamp(min=0).long(), :]
    parent_part = prev_table[:, :, pslot.clamp(min=0).long(), :]
    sib_sum = _int_contract("fbdc,kd->fbkc", direct_table, sib_mat)
    return torch.where((dslot >= 0)[None, None, :, None], direct_part,
                       parent_part - sib_sum)


# ---------------------------------------------------------------------------
# tree model
# ---------------------------------------------------------------------------

@dataclass
class TreeNode:
    node_id: int
    depth: int
    class_counts: np.ndarray            # [C]
    split: Optional[CandidateSplit] = None
    children: List[int] = dc_field(default_factory=list)
    score: float = 0.0

    @property
    def is_leaf(self) -> bool:
        return self.split is None


@dataclass
class DecisionTreeModel:
    """A grown tree.  Its JSON (:meth:`to_string`) is the JAX package's
    format, so a model file of either package loads in the other."""

    nodes: List[TreeNode]
    class_values: List[str]
    max_bins: int
    algorithm: str
    # the CONFIGURED depth / segment caps the tree was grown under (None on
    # legacy artifacts); predict_shape_signature buckets on these
    depth_cap: Optional[int] = None
    split_cap: Optional[int] = None

    def compile_arrays(self, pad: bool = False, device=None):
        """Flat tensors (attr, seg_table, child, distr) for the walker.
        With ``pad``, the node and segment axes round up to power-of-two
        buckets; pad rows are unreachable self-loop leaves, so padded and
        unpadded walks give the same predictions."""
        m = len(self.nodes)
        gmax = max([n.split.num_segments for n in self.nodes if n.split] or [1])
        if pad:
            _dp, mp, gp, _b, _c = predict_shape_signature(self)
        else:
            mp, gp = m, gmax
        attr = np.full(mp, 0, np.int32)
        seg_table = np.zeros((mp, self.max_bins), np.int32)
        child = np.tile(np.arange(mp, dtype=np.int32)[:, None], (1, gp))
        c = len(self.class_values)
        distr = np.zeros((mp, c), np.float32)
        for n in self.nodes:
            tot = max(n.class_counts.sum(), 1.0)
            distr[n.node_id] = n.class_counts / tot
            if n.split is not None:
                attr[n.node_id] = n.split.attr
                seg_table[n.node_id] = n.split.seg_of_bin
                for g, ch in enumerate(n.children):
                    child[n.node_id, g] = ch
        dev = torch.device("cpu") if device is None else torch.device(device)
        return tuple(torch.as_tensor(x, device=dev)
                     for x in (attr, seg_table, child, distr))

    @property
    def max_depth(self) -> int:
        return max(n.depth for n in self.nodes)

    # -- serde ---------------------------------------------------------------
    def to_json(self) -> Dict:
        return {
            "class_values": self.class_values,
            "max_bins": self.max_bins,
            "algorithm": self.algorithm,
            "depth_cap": self.depth_cap,
            "split_cap": self.split_cap,
            "nodes": [
                {
                    "id": n.node_id, "depth": n.depth,
                    "counts": n.class_counts.tolist(),
                    "children": n.children, "score": n.score,
                    "split": None if n.split is None else {
                        "attr": n.split.attr, "kind": n.split.kind,
                        "seg_of_bin": n.split.seg_of_bin.tolist(),
                        "num_segments": n.split.num_segments, "key": n.split.key,
                    },
                }
                for n in self.nodes
            ],
        }

    @classmethod
    def from_json(cls, obj: Dict) -> "DecisionTreeModel":
        nodes = []
        for d in obj["nodes"]:
            sp = d["split"]
            nodes.append(TreeNode(
                node_id=d["id"], depth=d["depth"],
                class_counts=np.asarray(d["counts"], np.float64),
                split=None if sp is None else CandidateSplit(
                    sp["attr"], sp["kind"], np.asarray(sp["seg_of_bin"], np.int32),
                    sp["num_segments"], sp["key"]),
                children=list(d["children"]), score=d["score"],
            ))
        dcap = obj.get("depth_cap")
        scap = obj.get("split_cap")
        return cls(nodes=nodes, class_values=list(obj["class_values"]),
                   max_bins=int(obj["max_bins"]), algorithm=obj["algorithm"],
                   depth_cap=None if dcap is None else int(dcap),
                   split_cap=None if scap is None else int(scap))

    def to_string(self) -> str:
        return json.dumps(self.to_json())

    @classmethod
    def from_string(cls, s: str) -> "DecisionTreeModel":
        return cls.from_json(json.loads(s))


def _pow2_bucket(n: int) -> int:
    """Smallest power of two ≥ n (n ≥ 1 → 1, 2, 4, 8, …)."""
    return 1 << max(n - 1, 0).bit_length()


def _tree_walk(attr: torch.Tensor, seg_table: torch.Tensor,
               child: torch.Tensor, distr: torch.Tensor, codes: torch.Tensor,
               depth: int):
    """Walk every row ``depth`` levels down the flat tree → ([N] class
    index int32, [N, C] leaf distribution).  Levels past a leaf are
    identities (leaves self-loop).  A code indexes the bin axis as JAX
    indexing does: negative codes wrap, then out-of-range ones clip;
    ``argmax`` returns the first maximum, as ``jnp.argmax`` does."""
    node = torch.zeros(codes.shape[0], dtype=torch.long, device=codes.device)
    b = seg_table.shape[1]
    for _ in range(depth):
        a = attr[node].long()
        code = codes.gather(1, a[:, None])[:, 0].long()
        code = torch.where(code < 0, code + b, code).clamp(0, b - 1)
        seg = seg_table[node, code].long()
        node = child[node, seg].long()
    d = distr[node]
    return torch.argmax(d, dim=-1).to(torch.int32), d


def predict_shape_signature(model: DecisionTreeModel) -> tuple:
    """The padded shape bucket of the walker — (depth bucket, node bucket,
    segment bucket, max_bins, classes), from the CONFIGURED caps the tree
    was grown under (the grown shape only on legacy artifacts), as the JAX
    package computes it."""
    m = len(model.nodes)
    gmax = max([n.split.num_segments for n in model.nodes if n.split] or [1])
    dp = _pow2_bucket(max(model.depth_cap or model.max_depth, 1))
    gp = max(_pow2_bucket(max(model.split_cap or 1, gmax)), 4)
    full = (gp ** (dp + 1) - 1) // (gp - 1)
    mp = _pow2_bucket(max(m, min(full, 4096)))
    return (dp, mp, gp, model.max_bins, len(model.class_values))


def predict_fn(model: DecisionTreeModel, pad_shapes: bool = True,
               device=None):
    """A walker [N, F] codes → ([N] class index, [N, C] distr) over the
    model's flat tensors on ``device``.  ``pad_shapes`` pads them to the
    shape signature's buckets and walks the depth bucket; predictions are
    the same either way."""
    attr, seg_table, child, distr = model.compile_arrays(pad=pad_shapes,
                                                         device=device)
    if pad_shapes:
        depth = predict_shape_signature(model)[0]
    else:
        depth = max(model.max_depth, 1)

    def walk(codes: torch.Tensor):
        return _tree_walk(attr, seg_table, child, distr, codes, depth)

    return walk


# ---------------------------------------------------------------------------
# estimator
# ---------------------------------------------------------------------------

class DecisionTree:
    """Frontier-growth decision-tree trainer, the JAX package's
    ``DecisionTree``.

    Parameters mirror the reference's job properties: ``algorithm``,
    ``max_depth``, ``min_node_size``, ``min_gain``, ``max_split``,
    ``attr_strategy`` all|userSpecified|randomK, ``top_n`` random-from-top-N
    selection.  ``selection`` device|host picks where per-level split
    scoring runs (the level table's device, or the host CPU from the
    fetched table); ``split_search`` exhaustive|binary the candidate family;
    ``hist_mode`` direct|cumsum|subtract the level-table strategy
    (:data:`HIST_MODES`); ``level_packed`` auto|on|off whether a frontier
    may ride one disjoint-pack gram (auto: on CUDA only, where the joint
    shape runs a gram kernel; on: also the plain gram on the CPU).  All
    grow the same tree.  ``collect_phase_stats`` records per-level
    table/select/partition walls in ``level_stats`` (with a device
    synchronisation per phase on CUDA).  ``device`` is ``cuda`` unless
    ``"cpu"`` is asked for.

    ``mesh``: an optional data mesh (``parallel/mesh.py``, the jobs'
    ``auto_mesh``).  The rows are split over it once (−1 pad rows count
    nothing), each shard keeps its own node vector, and each level's
    table is taken per shard and summed in shard order: B4 per card on a
    mesh of CUDA cards where its gate passes, the plain bincount on a CPU
    mesh; never a disjoint pack, as in the JAX package."""

    def __init__(
        self,
        algorithm: str = "entropy",
        max_depth: int = 4,
        min_node_size: int = 32,
        min_gain: float = 1e-4,
        max_split: int = 3,
        attr_strategy: str = "all",
        user_attrs: Optional[Sequence[int]] = None,
        random_k: Optional[int] = None,
        top_n: int = 1,
        max_candidates_per_attr: int = 128,
        split_chunk: int = 128,
        seed: int = 0,
        selection: str = "device",
        split_search: str = "exhaustive",
        hist_mode: str = "direct",
        level_packed: str = "auto",
        collect_phase_stats: bool = False,
        mesh=None,
        device=None,
    ):
        if algorithm not in ALGORITHMS:
            raise ValueError(f"unknown algorithm {algorithm!r}; known: {ALGORITHMS}")
        if selection not in ("device", "host"):
            raise ValueError(
                f"unknown selection {selection!r}; known: device, host")
        if split_search not in ("exhaustive", "binary"):
            raise ValueError(f"unknown split_search {split_search!r}; "
                             "known: exhaustive, binary")
        if hist_mode not in HIST_MODES:
            raise ValueError(f"unknown hist_mode {hist_mode!r}; "
                             f"known: {HIST_MODES}")
        if level_packed not in ("auto", "on", "off"):
            raise ValueError(f"unknown level_packed {level_packed!r}; "
                             "known: auto, on, off")
        self.selection = selection
        self.split_search = split_search
        self.hist_mode = hist_mode
        self.level_packed = level_packed
        self.collect_phase_stats = collect_phase_stats
        self.level_stats: List[dict] = []
        self.algorithm = algorithm
        self.max_depth = max_depth
        self.min_node_size = min_node_size
        self.min_gain = min_gain
        self.max_split = max_split
        self.attr_strategy = attr_strategy
        self.user_attrs = list(user_attrs) if user_attrs is not None else None
        self.random_k = random_k
        self.top_n = top_n
        self.max_candidates_per_attr = max_candidates_per_attr
        self.split_chunk = split_chunk
        self.seed = seed
        self.mesh = mesh
        self.device = resolve_device(device)

    def _attrs_for_node(self, rng: np.random.Generator, num_attrs: int) -> List[int]:
        if self.attr_strategy == "userSpecified":
            if not self.user_attrs:
                raise ValueError("userSpecified strategy requires user_attrs")
            return self.user_attrs
        if self.attr_strategy == "randomK":
            k = self.random_k or max(1, int(np.sqrt(num_attrs)))
            return sorted(rng.choice(num_attrs, size=min(k, num_attrs), replace=False).tolist())
        if self.attr_strategy == "all":
            return list(range(num_attrs))
        raise ValueError(f"unknown attr_strategy {self.attr_strategy!r}")

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def fit(self, ds: EncodedDataset,
            is_categorical: Optional[Sequence[bool]] = None) -> DecisionTreeModel:
        if ds.labels is None:
            raise ValueError("fit requires labels")
        dev = self.device
        rng = np.random.default_rng(self.seed)
        c = ds.num_classes
        nf, nb = ds.num_binned, ds.max_bins
        # codes and labels go to the device (split over the mesh) once;
        # per level only the [N] node vector changes, and it stays there
        mesh = self.mesh
        labels_dev, codes_dev = place_batch(
            mesh, dev, np.ascontiguousarray(ds.labels, np.int32),
            np.ascontiguousarray(ds.codes, np.int32))
        on_card = (dev.type == "cuda" if mesh is None
                   else mesh_on_cuda(mesh))
        # the X-side gate of the cross kernel is level-independent
        use_cross = on_card and hist.cross_applicable(nf, nb, max(c, 1))
        may_pack = mesh is None and (self.level_packed == "on" or (
            self.level_packed == "auto" and on_card))
        codes_t_dev = (per_shard(lambda x: x.t().contiguous(), codes_dev)
                       if (use_cross or may_pack) else None)
        all_splits = candidate_splits_for(
            ds, self.split_search, self.max_split, is_categorical,
            self.max_candidates_per_attr)
        flat = (flatten_splits(all_splits, nb, self.split_chunk, device=dev)
                if self.selection == "device" else None)
        use_device_sel = flat is not None and flat.num_real > 0
        # cumsum fast path: every candidate is one sorted threshold
        use_cum = (use_device_sel and flat.all_binary
                   and self.hist_mode in ("cumsum", "subtract"))

        root_counts = np.bincount(ds.labels, minlength=c).astype(np.float64)
        nodes: List[TreeNode] = [TreeNode(0, 0, root_counts)]
        node_dev = per_shard(lambda y: torch.zeros(
            y.shape[0], dtype=torch.int32, device=y.device), labels_dev)
        frontier = [0]
        use_subtract = self.hist_mode == "subtract"
        prev_table_dev = None
        sub_plan = None     # (remap_direct, dslot, pslot, sib_mat, kd)
        collect = self.collect_phase_stats
        self.level_stats = []

        def build_table(local_ids, k_slots):
            """The one level-count entry: the cross kernel when the
            selector width qualifies, a disjoint pack where the planner
            accepts the frontier, the plain bincount otherwise.  Returns
            (table, route) with route in ("cross", "packed", "plain")."""
            if use_cross and hist.cross_applicable(nf, nb, k_slots * c):
                return shard_sum(_level_table_cross, codes_t_dev, local_ids,
                                 labels_dev, k_slots, c, nb), "cross"
            if may_pack and k_slots > 0:
                pplan = hist.pack_disjoint(k_slots, nf, nb, max(c, 1))
                if pplan is not None and (
                        (hist.packed_applicable(pplan) and on_card)
                        or self.level_packed == "on"):
                    return _level_table_packed(codes_t_dev, local_ids,
                                               labels_dev, pplan), "packed"
            return shard_sum(node_bin_class_counts, codes_dev, local_ids,
                             labels_dev, k_slots, c, nb), "plain"

        for depth in range(self.max_depth):
            if not frontier:
                break
            t_lv = time.perf_counter()
            k = len(frontier)
            # remap frontier ids to 0..k-1 for the level table
            remap = np.full(len(nodes), -1, np.int32)
            for i, nid in enumerate(frontier):
                remap[nid] = i
            remap_dev = torch.as_tensor(remap, device=dev)
            k_contracted = k
            if use_subtract and sub_plan is not None:
                # count only the direct (smaller-sibling) slots and derive
                # each largest sibling by exact parent-slice subtraction
                remap_direct, dslot, pslot, sib_mat, kd = sub_plan
                k_contracted = kd
                local_direct = per_shard(
                    _remap_nodes, node_dev,
                    torch.as_tensor(remap_direct, device=dev))
                direct_dev, path_lv = build_table(local_direct, kd)
                table_dev = _assemble_subtract_table(
                    direct_dev, prev_table_dev,
                    torch.as_tensor(dslot, device=dev),
                    torch.as_tensor(pslot, device=dev),
                    torch.as_tensor(sib_mat, device=dev))
            else:
                table_dev, path_lv = build_table(
                    per_shard(_remap_nodes, node_dev, remap_dev), k)
            if use_subtract:
                prev_table_dev = table_dev
            if collect:
                self._sync()
                t_tab = time.perf_counter()

            attrs_lv = self._attrs_for_node(rng, nf)
            best_per_node: List[List[Tuple[float, CandidateSplit, np.ndarray]]] = [
                [] for _ in range(k)]
            if use_device_sel:
                # histograms + scores + per-node top-k on the device; the
                # host fetches only the winners' descriptors
                top_k = min(max(self.top_n, 1), flat.seg_tab_dev.shape[0])
                allow_dev = torch.as_tensor(flat.allow_vector(attrs_lv),
                                            device=dev)
                thr_dev = flat.thr_dev if use_cum else None
                statics = dict(algorithm=self.algorithm, gmax=flat.gmax,
                               top_k=top_k, chunk=flat.chunk, binary=use_cum)
                prof = _profile.profiler()
                pkey = None
                if prof.enabled:
                    # the level-selection program, keyed on its shapes and
                    # statics; plain torch, so shapes only (no kernel cost)
                    pkey = CompileKeyMonitor.shape_key(
                        table_dev, flat.seg_tab_dev, thr_dev) + (
                        tuple(sorted(statics.items())),)
                    prof.observe(pkey, site="tree.level")
                    t_disp = time.perf_counter()
                vals, idx, whist = _device_select_splits(
                    table_dev, flat.seg_tab_dev, flat.attr_dev,
                    flat.nseg_dev, allow_dev, thr_dev, **statics)
                # the one fetch per level by design: the host takes only the
                # winners' descriptors to grow the tree
                # graftlint: disable=GL005
                vals, idx, whist = (vals.cpu().numpy(), idx.cpu().numpy(),
                                    whist.cpu().numpy())  # graftlint: disable=GL005
                if pkey is not None:
                    prof.sample(pkey, "tree.level",
                                time.perf_counter() - t_disp)
                for ki in range(k):
                    for p in range(top_k):
                        s = float(vals[ki, p])
                        if s == -np.inf:        # pad / strategy-masked slot
                            continue
                        best_per_node[ki].append(
                            (s, flat.splits[int(idx[ki, p])], whist[ki, p]))
            else:
                # the host selection route fetches the level table once per level
                # by design (selection="host"); the device route is the one above
                # graftlint: disable=GL005
                table = table_dev.cpu().numpy()
                for _a, chunk, scores, h in iter_scored_splits(
                        table, all_splits, self.algorithm, self.split_chunk,
                        attrs=attrs_lv):
                    for si, sp in enumerate(chunk):
                        for ki in range(k):
                            best_per_node[ki].append(
                                (float(scores[si, ki]), sp, h[si, :, ki, :]))
            # select per node: best or random among top_n
            new_frontier: List[int] = []
            attr_arr = np.zeros(k, np.int32)
            child_tab = np.full((k, nb), -1, np.int32)
            split_records: List[Tuple[int, List[int], np.ndarray]] = []
            for ki, nid in enumerate(frontier):
                node = nodes[nid]
                cands = sorted(best_per_node[ki], key=lambda t: -t[0])[:max(self.top_n, 1)]
                if not cands:
                    continue
                pick = cands[0] if len(cands) == 1 or self.top_n <= 1 else \
                    cands[int(rng.integers(len(cands)))]
                score, sp, h = pick
                # stopping rules (DataPartitioner recursion guards)
                if not np.isfinite(score) or score < self.min_gain:
                    continue
                seg_counts = h.sum(-1)
                live_segs = seg_counts > 0
                if live_segs.sum() < 2 or node.class_counts.sum() < self.min_node_size:
                    continue
                if (node.class_counts > 0).sum() < 2:   # pure node
                    continue
                node.split = sp
                node.score = score
                for g in range(sp.num_segments):
                    ch = TreeNode(len(nodes), depth + 1, h[g].astype(np.float64))
                    node.children.append(ch.node_id)
                    nodes.append(ch)
                    if seg_counts[g] >= self.min_node_size and depth + 1 < self.max_depth:
                        new_frontier.append(ch.node_id)
                child_ids = np.asarray(node.children, np.int32)
                attr_arr[ki] = sp.attr
                child_tab[ki] = child_ids[sp.seg_of_bin]
                split_records.append((ki, list(node.children), seg_counts))
            if collect:
                t_sel = time.perf_counter()
            # no next level (or nothing split): the vector would never be read
            if new_frontier and (child_tab >= 0).any():
                node_dev = per_shard(
                    _apply_level_partition, codes_dev, node_dev, remap_dev,
                    torch.as_tensor(attr_arr, device=dev),
                    torch.as_tensor(child_tab, device=dev))
                if collect:
                    self._sync()
            sub_plan = (self._subtract_plan(split_records, new_frontier,
                                            len(nodes))
                        if use_subtract and new_frontier else None)
            if collect:
                t_end = time.perf_counter()
                self.level_stats.append({
                    "level": depth, "frontier": k,
                    "contracted_slots": k_contracted,
                    "path": path_lv,
                    # the count's dot width on the route this level took,
                    # as the JAX package reports it
                    "sel_width": (
                        hist.cross_sel_width(k_contracted * c)
                        if path_lv == "cross" else
                        hist.pack_disjoint(k_contracted, nf, nb,
                                           max(c, 1)).wp
                        if path_lv == "packed" else k_contracted * c),
                    "table_ms": round((t_tab - t_lv) * 1e3, 3),
                    "select_ms": round((t_sel - t_tab) * 1e3, 3),
                    "partition_ms": round((t_end - t_sel) * 1e3, 3)})
            frontier = new_frontier
        return DecisionTreeModel(nodes=nodes, class_values=list(ds.class_values),
                                 max_bins=nb, algorithm=self.algorithm,
                                 depth_cap=self.max_depth,
                                 split_cap=(2 if self.split_search == "binary"
                                            else self.max_split))

    @staticmethod
    def _subtract_plan(split_records, new_frontier, num_nodes: int):
        """Host-side plan (tiny) for the next level's sibling-subtraction
        table: per split parent with frontier children, pick the
        largest-mass segment g* (stable: lowest g on ties) as the DERIVED
        child and mark every other segment's child a DIRECT contraction
        slot (settled siblings included — the subtraction needs them);
        when the g* child itself is settled, only the frontier children
        are contracted (nothing needs deriving there).  Returns
        (remap_direct [num_nodes] abs id → slot, dslot [K] (−1 =
        derived), pslot [K] parent's previous-level local index,
        sib_mat [K, D] direct-sibling one-hot, D)."""
        fs = set(new_frontier)
        direct_ids: List[int] = []
        dslot_of: Dict[int, int] = {}
        derived_info: Dict[int, Tuple[int, List[int]]] = {}
        for ki, child_ids, masses in split_records:
            in_f = [cid for cid in child_ids if cid in fs]
            if not in_f:
                continue
            gstar = int(np.argmax(np.asarray(masses)))
            gstar_child = child_ids[gstar]
            if gstar_child in fs:
                members = [cid for g, cid in enumerate(child_ids)
                           if g != gstar]
                derived_info[gstar_child] = (ki, members)
            else:
                members = in_f
            for cid in members:
                dslot_of[cid] = len(direct_ids)
                direct_ids.append(cid)
        kd = len(direct_ids)
        kf = len(new_frontier)
        remap_direct = np.full(num_nodes, -1, np.int32)
        for cid, sl in dslot_of.items():
            remap_direct[cid] = sl
        dslot = np.full(kf, -1, np.int32)
        pslot = np.zeros(kf, np.int32)
        sib_mat = np.zeros((kf, kd), np.int32)
        for k2, cid in enumerate(new_frontier):
            if cid in derived_info:
                kp, members = derived_info[cid]
                pslot[k2] = kp
                for m in members:
                    sib_mat[k2, dslot_of[m]] = 1
            else:
                dslot[k2] = dslot_of[cid]
        return remap_direct, dslot, pslot, sib_mat, kd

    def predict(self, model: DecisionTreeModel, ds: EncodedDataset,
                validate: bool = False, pos_class: Optional[str] = None):
        walk = predict_fn(model, device=self.device)
        pred, distr = walk(torch.from_numpy(
            np.ascontiguousarray(ds.codes, np.int32)).to(self.device))
        pred, distr = pred.cpu().numpy(), distr.cpu().numpy()
        counters = Counters()
        cm = None
        if validate:
            if ds.labels is None:
                raise ValueError("validation requires labels")
            cm = ConfusionMatrix(model.class_values, pos_class=pos_class)
            cm.add_batch(ds.labels, pred)
            cm.publish(counters)
        return pred, distr, cm, counters


class RandomForest:
    """Bagged ensemble of randomK trees — port of the JAX package's
    ``RandomForest``.  Tree ``t`` is grown by :class:`DecisionTree` on a
    bootstrap sample drawn with ``prng.prng_key(seed * 1000 + t)`` and with
    that seed for its attribute draws, so each tree is the JAX package's
    tree ``t``; every level of every tree builds its table as
    ``DecisionTree.fit`` does (B4 or B1–B3 on CUDA)."""

    def __init__(self, num_trees: int = 10, seed: int = 0, device=None,
                 **tree_kwargs):
        tree_kwargs.setdefault("attr_strategy", "randomK")
        self.num_trees = num_trees
        self.seed = seed
        self.device = resolve_device(device)
        self.tree_kwargs = tree_kwargs

    def fit(self, ds: EncodedDataset,
            is_categorical: Optional[Sequence[bool]] = None
            ) -> List[DecisionTreeModel]:
        from avenir_tpu_torch.models.samplers import bagging_sample
        from avenir_tpu_torch.utils import prng

        models = []
        for t in range(self.num_trees):
            seed = self.seed * 1000 + t
            sample = bagging_sample(prng.prng_key(seed), ds)
            tree = DecisionTree(seed=seed, device=self.device,
                                **self.tree_kwargs)
            models.append(tree.fit(sample, is_categorical))
        return models

    def predict(self, models: List[DecisionTreeModel], ds: EncodedDataset):
        """→ ([N] class index of the mean vote, [N, C] float32 votes)."""
        votes = np.zeros((ds.num_rows, len(models[0].class_values)),
                         np.float32)
        walker = DecisionTree(device=self.device)
        for m in models:
            _, distr, _, _ = walker.predict(m, ds)
            votes += distr
        votes /= len(models)
        return np.argmax(votes, axis=1).astype(np.int32), votes
