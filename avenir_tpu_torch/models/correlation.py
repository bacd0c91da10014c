"""Categorical correlation — the Cramér index and heterogeneity reduction;
port of ``avenir_tpu/models/correlation.py`` (the reference's
explore/CramerCorrelation.java, CategoricalCorrelation.java and
HeterogeneityReductionCorrelation.java).

Every selected (src, dst) attribute pair gets a contingency table, and one
statistic of it per pair.  On CUDA the tables come from the co-occurrence
gram (``ops/hist.py``): feature pairs are the gram of one class (all labels
0, so B1 counts (bin, bin) per pair), against-class tables are the
[F, B, C] diagonal of the gram over the real labels (B1, or B2/B3 on wide
schemas).  Elsewhere they are ``agg.pair_counts`` in slices of
``pair_chunk`` pairs.  Both give the same integer tables; each pair's
statistic is computed from them in float32 on the host CPU, so the result
does not depend on the device the counts came from.

Under a data mesh (``mesh=``, the jobs' ``auto_mesh``) the tables are
accumulated under the ``agg`` route's keys on any mesh, as in the JAX
package; on a mesh of CUDA cards each shard's tables still come from its
gram (B1–B3 on its card), summed and read out into those keys' tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from avenir_tpu_torch.core.encoding import EncodedDataset, peek_chunks
from avenir_tpu_torch.device import resolve_device
from avenir_tpu_torch.ops import agg, hist, info
from avenir_tpu_torch.parallel.collectives import shard_sum
from avenir_tpu_torch.parallel.mesh import mesh_on_cuda, place_batch

STATS: Dict[str, Callable] = {
    "cramerIndex": info.cramer_index,
    "concentrationCoeff": info.concentration_coefficient,
    "uncertaintyCoeff": info.uncertainty_coefficient,
}


def _einsum_key_prefix(f: int, b_dst: int, pairs) -> str:
    """Accumulator key prefix of the ``agg`` route (chunk keys are
    ``"<prefix>:<chunk_start>"``): the binned-feature count, the
    destination width, the pair count and a digest of the (src, dst) pairs,
    the JAX package's strings.  A snapshot taken under another attribute
    selection then carries other keys, which :meth:`CategoricalCorrelation.fit`
    refuses instead of summing tables of other pairs."""
    import hashlib

    canon = repr([(int(a), int(b)) for a, b in pairs])
    digest = hashlib.blake2s(canon.encode(), digest_size=4).hexdigest()
    return f"c{f}x{b_dst}p{len(pairs)}h{digest}"


def select_pairs(num_feat: int, names: Sequence[str],
                 src: Optional[Sequence[int]] = None,
                 dst: Optional[Sequence[int]] = None,
                 against_class: bool = False):
    """(pairs, pair_names) of an attribute selection: ``src`` × the class
    (dst index −1) against the class, else ``src`` × ``dst`` with i < j;
    ``None`` selects every binned feature."""
    src_idx = list(src) if src is not None else list(range(num_feat))
    if against_class:
        return [(i, -1) for i in src_idx], [(names[i], "class") for i in src_idx]
    dst_idx = list(dst) if dst is not None else list(range(num_feat))
    pairs = [(i, j) for i in src_idx for j in dst_idx if i < j]
    return pairs, [(names[i], names[j]) for i, j in pairs]


def class_tables(fbc: np.ndarray, pairs, b_dst: int) -> np.ndarray:
    """The against-class contingency stack [P, Bd, Bd] of ``pairs`` (src,
    −1) from the [F, B, C] class-conditional bin counts."""
    _f, b, c = fbc.shape
    cont = np.zeros((len(pairs), b_dst, b_dst), fbc.dtype)
    cont[:, :b, :c] = fbc[[i for i, _ in pairs]]
    return cont


def gram_tables(g: np.ndarray, num_feat: int, num_bins: int,
                num_classes: int, pairs, against_class: bool,
                b_dst: int) -> np.ndarray:
    """The contingency stack [P, Bd, Bd] of ``pairs`` read out of a gram
    total: against the class, the [F, B, C] diagonal of the class gram;
    else the (bin, bin) pair tables of the one-class gram."""
    if against_class:
        fbc, _ = hist.counts_from_cooc(g, num_feat, num_bins, num_classes,
                                       np.zeros(0, np.int64),
                                       np.zeros(0, np.int64))
        return class_tables(fbc, pairs, b_dst)
    _, pair4 = hist.counts_from_cooc(
        g, num_feat, num_bins, 1, np.array([p[0] for p in pairs], np.int64),
        np.array([p[1] for p in pairs], np.int64))
    return pair4[:, :, :, 0]


def _pair_tables(codes: torch.Tensor, labels: Optional[torch.Tensor],
                 pairs, b_dst: int) -> torch.Tensor:
    """[P, Bd, Bd] ``agg.pair_counts`` of ``pairs``, the destination the
    class label where a pair's is −1."""
    ci = codes[:, [p[0] for p in pairs]]
    if labels is not None:
        cj = labels.long()[:, None].expand(codes.shape[0], len(pairs))
    else:
        cj = codes[:, [p[1] for p in pairs]]
    return agg.pair_counts(ci, cj, b_dst)


def result_from_counts(
    algorithm: str,
    pairs: List[Tuple[int, int]],
    pair_names: List[Tuple[str, str]],
    contingency: np.ndarray,
    n_bins: np.ndarray,
    num_classes: int,
) -> "CorrelationResult":
    """:class:`CorrelationResult` from an aggregated [P, Bd, Bd] contingency
    stack, without touching data: the finalize step of
    :meth:`CategoricalCorrelation.fit` and of the SharedScan consumer.
    ``pairs`` use the fit contract (dst index −1 = the class attribute).
    Each statistic runs over the pair's true (rows, cols) support, in
    float32 on the CPU."""
    if algorithm not in STATS:
        raise ValueError(f"unknown algorithm {algorithm!r}; known: {sorted(STATS)}")
    stat = np.zeros(len(pairs))
    stat_fn = STATS[algorithm]
    for k, (i, j) in enumerate(pairs):
        rows = int(n_bins[i])
        cols = int(num_classes) if j < 0 else int(n_bins[j])
        table = np.ascontiguousarray(contingency[k, :rows, :cols])
        stat[k] = float(stat_fn(torch.from_numpy(table).to(torch.float32)))
    return CorrelationResult(
        pairs=pairs, pair_names=pair_names, stat=stat,
        algorithm=algorithm, contingency=contingency,
    )


@dataclass
class CorrelationResult:
    pairs: List[Tuple[int, int]]         # (src binned-index, dst binned-index)
    pair_names: List[Tuple[str, str]]
    stat: np.ndarray                     # [P]
    algorithm: str
    contingency: np.ndarray              # [P, B, B] counts

    def to_lines(self, delim: str = ",") -> List[str]:
        return [delim.join([a, b, f"{v:.6f}"])
                for (a, b), v in zip(self.pair_names, self.stat)]

    def top(self, k: int = 10) -> List[Tuple[Tuple[str, str], float]]:
        order = np.argsort(-self.stat)[:k]
        return [(self.pair_names[i], float(self.stat[i])) for i in order]


class CategoricalCorrelation:
    """All-pairs categorical association over binned features on
    ``device`` (``cuda`` unless the caller asks for the CPU).

    ``src`` / ``dst`` are binned-feature indices (defaults: all × all,
    i < j).  ``against_class=True`` makes the class attribute the
    destination of every pair (the churn tutorial's use)."""

    def __init__(self, algorithm: str = "cramerIndex", pair_chunk: int = 512,
                 mesh=None, device=None):
        if algorithm not in STATS:
            raise ValueError(f"unknown algorithm {algorithm!r}; known: {sorted(STATS)}")
        self.algorithm = algorithm
        self.pair_chunk = pair_chunk
        self.mesh = mesh          # optional data mesh (parallel/mesh.py)
        self.device = resolve_device(device)

    def fit(
        self,
        data: Union[EncodedDataset, Iterable[EncodedDataset]],
        src: Optional[Sequence[int]] = None,
        dst: Optional[Sequence[int]] = None,
        against_class: bool = False,
        feature_names: Optional[Sequence[str]] = None,
        accumulator: Optional[agg.Accumulator] = None,
    ) -> CorrelationResult:
        """``accumulator``: an accumulator owned by the caller, possibly
        restored from a snapshot (the streamed job's
        ``StreamCheckpointer``); by default a private one."""
        meta, chunks = peek_chunks(data)
        f, b = meta.num_binned, meta.max_bins
        names = list(feature_names) if feature_names is not None else [
            f"f{o}" for o in meta.binned_ordinals]
        if against_class and meta.labels is None:
            raise ValueError("against_class requires labels")
        pairs, pair_names = select_pairs(f, names, src, dst, against_class)
        b_dst = max(b, meta.num_classes) if against_class else b
        acc = accumulator if accumulator is not None else agg.Accumulator()
        # kernel route: feature-pair tables are the gram of ONE class
        # (labels ≡ 0), against-class tables its [F, B, C] diagonal over the
        # real labels; under a mesh the agg route's keys, each shard's
        # tables from its gram on a mesh of cards
        n_cls = meta.num_classes if against_class else 1
        fast = self.mesh is None and hist.use_kernel(f, b, n_cls, self.device)
        shard_gram = (self.mesh is not None and mesh_on_cuda(self.mesh)
                      and hist.applicable(f, b, n_cls))
        gk = hist.g_key(f, b, n_cls) if fast else None
        ek = None if fast else _einsum_key_prefix(f, b_dst, pairs)
        if accumulator is not None:
            expected = {gk} if fast else {
                f"{ek}:{s}"
                for s in range(0, len(pairs), self.pair_chunk)}
            stale = [k for k in accumulator.names() if k not in expected]
            if stale:
                raise ValueError(
                    f"restored correlation accumulator holds keys {stale} "
                    f"incompatible with this run's count path "
                    f"({'kernel ' + gk if fast else 'einsum'}) or pair "
                    f"list (F={f}, B_dst={b_dst}, {len(pairs)} pairs); the "
                    f"snapshot was written under a different device/kernel "
                    f"layout or attribute selection — clear the checkpoint "
                    f"directory and re-run")

        def gram(codes, labels):
            y = (labels if against_class else
                 torch.zeros(codes.shape[0], dtype=torch.int32,
                             device=codes.device))
            return hist.cooc_counts(codes, y, b, n_cls)

        for ds in chunks:
            codes, lab = place_batch(self.mesh, self.device, ds.codes,
                                     ds.labels)
            if fast:
                acc.add(gk, gram(codes, lab))
                continue
            if shard_gram:
                tables = gram_tables(
                    # one fetch per chunk by design: the host reads each chunk's gram
                    # out into the pair tables, as the JAX package's sharded path does
                    # graftlint: disable=GL005
                    shard_sum(gram, codes, lab).cpu().numpy(), f, b, n_cls,
                    pairs, against_class, b_dst)
                for s in range(0, len(pairs), self.pair_chunk):
                    acc.add(f"{ek}:{s}", tables[s:s + self.pair_chunk])
                continue
            for s in range(0, len(pairs), self.pair_chunk):
                acc.add(f"{ek}:{s}", shard_sum(
                    _pair_tables, codes, lab if against_class else None,
                    pairs[s:s + self.pair_chunk], b_dst))
        if fast and gk in acc:
            cont = gram_tables(acc.get(gk), f, b, n_cls, pairs,
                               against_class, b_dst)
        elif pairs:
            cont = np.concatenate([
                acc.get(f"{ek}:{s}")
                for s in range(0, len(pairs), self.pair_chunk)])
        else:
            cont = np.zeros((0, b_dst, b_dst), np.int64)
        return result_from_counts(self.algorithm, pairs, pair_names, cont,
                                  meta.n_bins, meta.num_classes)


class CramerCorrelation(CategoricalCorrelation):
    """The reference job's statistic, the Cramér index."""

    def __init__(self, pair_chunk: int = 512, mesh=None, device=None):
        super().__init__("cramerIndex", pair_chunk, mesh=mesh, device=device)


class HeterogeneityReductionCorrelation(CategoricalCorrelation):
    """Concentration (Gini) or uncertainty coefficient."""

    def __init__(self, algorithm: str = "concentrationCoeff",
                 pair_chunk: int = 512, mesh=None, device=None):
        super().__init__(algorithm, pair_chunk, mesh=mesh, device=device)
