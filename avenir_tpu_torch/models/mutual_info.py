"""Mutual-information feature analysis — port of
``avenir_tpu/models/mutual_info.py`` (the reference's
explore/MutualInformation.java and MutualInformationScore.java).

One pass counts the class vector, the [F, B, C] feature-class tensor and
the [P, B, B, C] pair-class tensor; every reference distribution family and
MI statistic derives from them.  On CUDA the counts come from the
co-occurrence gram kernels (``ops/hist.py``), read out once at the end; on
the CPU, and for shapes outside every kernel gate, from the integer
``agg`` counts.  Both give the same counts.  MI values are in nats.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from avenir_tpu_torch.core.encoding import EncodedDataset, peek_chunks
from avenir_tpu_torch.device import resolve_device, to_device
from avenir_tpu_torch.ops import agg, hist, info


@dataclass
class MutualInfoResult:
    """All distributions + MI statistics from one pass over the data."""

    feature_names: List[str]                 # [F] display names (binned features)
    class_values: List[str]
    n_bins: np.ndarray                       # [F]
    class_counts: np.ndarray                 # [C]
    feature_class_counts: np.ndarray         # [F, B, C]
    pair_index: np.ndarray                   # [P, 2] (i, j) with i < j
    pair_class_counts: np.ndarray            # [P, B, B, C]

    # derived statistics (computed in finish())
    feature_class_mi: Optional[np.ndarray] = None        # [F]  I(f; class)
    feature_pair_mi: Optional[np.ndarray] = None         # [P]  I(fi; fj)
    pair_class_mi: Optional[np.ndarray] = None           # [P]  I((fi,fj); class)
    pair_class_entropy: Optional[np.ndarray] = None      # [P]  H(fi, fj, class)
    feature_pair_class_cond_mi: Optional[np.ndarray] = None  # [P] I(fi; fj | class)
    feature_entropy: Optional[np.ndarray] = None         # [F]  H(f)
    class_entropy: Optional[float] = None

    @property
    def num_features(self) -> int:
        return len(self.feature_names)

    def finish(self) -> "MutualInfoResult":
        """Derived statistics in float32 on the host CPU — tiny tensors, so
        the result does not depend on the device the counts came from."""
        fcc = torch.as_tensor(self.feature_class_counts).to(torch.float32)
        pcc = torch.as_tensor(self.pair_class_counts).to(torch.float32)
        cc = torch.as_tensor(self.class_counts).to(torch.float32)
        p, b, _, c = pcc.shape
        self.feature_class_mi = info.mutual_information(fcc).numpy()
        self.feature_entropy = info.entropy_from_counts(fcc.sum(-1), axis=-1).numpy()
        self.class_entropy = float(info.entropy_from_counts(cc))
        self.feature_pair_mi = info.mutual_information(pcc.sum(-1)).numpy()
        self.pair_class_mi = info.mutual_information(pcc.reshape(p, b * b, c)).numpy()
        self.pair_class_entropy = info.entropy_from_counts(
            pcc.reshape(p, -1), axis=-1).numpy()
        self.feature_pair_class_cond_mi = info.conditional_mutual_information(pcc).numpy()
        return self

    def pair_pos(self) -> Dict[Tuple[int, int], int]:
        return {(int(i), int(j)): k for k, (i, j) in enumerate(self.pair_index)}

    def to_lines(self, delim: str = ",") -> List[str]:
        """Tagged rows for each MI family, ordered by feature/pair."""
        lines = []
        for f, name in enumerate(self.feature_names):
            lines.append(delim.join(["featureClassMI", name, f"{self.feature_class_mi[f]:.6f}"]))
        for k, (i, j) in enumerate(self.pair_index):
            a, b = self.feature_names[i], self.feature_names[j]
            lines.append(delim.join(["featurePairMI", a, b, f"{self.feature_pair_mi[k]:.6f}"]))
            lines.append(delim.join(["featurePairClassMI", a, b, f"{self.pair_class_mi[k]:.6f}"]))
            lines.append(delim.join(
                ["featurePairClassCondMI", a, b, f"{self.feature_pair_class_cond_mi[k]:.6f}"]))
        return lines


def result_from_counts(
    feature_names: Sequence[str],
    class_values: Sequence[str],
    n_bins: np.ndarray,
    class_counts: np.ndarray,
    feature_class_counts: np.ndarray,
    pair_index: np.ndarray,
    pair_class_counts: np.ndarray,
) -> MutualInfoResult:
    """Finished :class:`MutualInfoResult` from already-aggregated count
    tensors, without touching data."""
    return MutualInfoResult(
        feature_names=list(feature_names),
        class_values=list(class_values),
        n_bins=np.asarray(n_bins, np.int64),
        class_counts=np.asarray(class_counts),
        feature_class_counts=np.asarray(feature_class_counts),
        pair_index=np.asarray(pair_index),
        pair_class_counts=np.asarray(pair_class_counts),
    ).finish()


def all_pairs(num_feat: int) -> np.ndarray:
    """[P, 2] int32 feature pairs (i, j), i < j, in row-major order."""
    return np.array([(i, j) for i in range(num_feat) for j in range(i + 1, num_feat)],
                    np.int32).reshape(-1, 2)


class MutualInformation:
    """One-pass MI/distribution engine over encoded chunks.

    ``pair_chunk`` bounds the pair dimension of the per-chunk [P, B, B, C]
    tensor on the ``agg`` route; ``device`` defaults to ``cuda``."""

    def __init__(self, pair_chunk: int = 256, device=None):
        self.pair_chunk = pair_chunk
        self.device = resolve_device(device)

    def fit(self, data: Union[EncodedDataset, Iterable[EncodedDataset]],
            feature_names: Optional[Sequence[str]] = None) -> MutualInfoResult:
        meta, chunks = peek_chunks(data)
        if meta.labels is None:
            raise ValueError("mutual information requires a class attribute")
        f, b, c = meta.num_binned, meta.max_bins, meta.num_classes
        pair_index = all_pairs(f)
        acc = agg.Accumulator()
        # kernel route: one gram per chunk (B1, or B2/B3 in the per-class
        # plan modes), accumulated as G and read out once at the end
        kernel = hist.use_kernel(f, b, c, self.device)
        gk = hist.g_key(f, b, c)
        for ds in chunks:
            codes = to_device(ds.codes, self.device)
            labels = to_device(ds.labels, self.device)
            acc.add("class", agg.class_counts(labels, c))
            if kernel:
                acc.add(gk, hist.cooc_counts(codes, labels, b, c))
                continue
            acc.add("fc", agg.feature_class_counts(codes, labels, c, b))
            for s in range(0, len(pair_index), self.pair_chunk):
                sl = torch.from_numpy(pair_index[s:s + self.pair_chunk]).to(
                    self.device, torch.long)
                acc.add(f"pcc{s}", agg.pair_class_counts(
                    codes[:, sl[:, 0]], codes[:, sl[:, 1]], labels, c, b))
        if gk in acc:
            fc_full, pcc_full = hist.counts_from_cooc(
                acc.get(gk), f, b, c, pair_index[:, 0], pair_index[:, 1])
        elif len(pair_index):
            fc_full = acc.get("fc")
            pcc_full = np.concatenate(
                [acc.get(f"pcc{s}")
                 for s in range(0, len(pair_index), self.pair_chunk)])
        else:
            fc_full = acc.get("fc")
            pcc_full = np.zeros((0, b, b, c), np.int64)
        names = list(feature_names) if feature_names is not None else [
            f"f{o}" for o in meta.binned_ordinals]
        return result_from_counts(
            feature_names=names,
            class_values=list(meta.class_values),
            n_bins=meta.n_bins,
            class_counts=acc.get("class"),
            feature_class_counts=fc_full,
            pair_index=pair_index,
            pair_class_counts=pcc_full,
        )


# ---------------------------------------------------------------------------
# feature-subset scoring (host-side greedy, as in MutualInformationScore.java)
# ---------------------------------------------------------------------------

def _greedy(num_features: int, first: int, gain) -> List[Tuple[int, float]]:
    """Shared greedy loop: start from ``first``, repeatedly add argmax gain."""
    selected = [first]
    out = [(first, float("nan"))]
    while len(selected) < num_features:
        best, best_score = -1, -np.inf
        for f in range(num_features):
            if f in selected:
                continue
            s = gain(f, selected)
            if s > best_score:
                best, best_score = f, s
        selected.append(best)
        out.append((best, best_score))
    return out


def mim_score(result: MutualInfoResult) -> List[Tuple[int, float]]:
    """Mutual Information Maximization: rank by I(f; class)."""
    order = np.argsort(-result.feature_class_mi)
    return [(int(f), float(result.feature_class_mi[f])) for f in order]


def mifs_score(result: MutualInfoResult, redundancy_factor: float = 1.0) -> List[Tuple[int, float]]:
    """MIFS greedy: gain = I(f;c) − β · Σ_{s∈S} I(f;s)."""
    mi_c = result.feature_class_mi
    pos = result.pair_pos()
    pmi = result.feature_pair_mi

    def pair_mi(a, bf):
        return pmi[pos[(min(a, bf), max(a, bf))]]

    def gain(f, sel):
        return mi_c[f] - redundancy_factor * sum(pair_mi(f, s) for s in sel)

    first = int(np.argmax(mi_c))
    out = _greedy(result.num_features, first, gain)
    return [(f, (float(mi_c[f]) if np.isnan(s) else s)) for f, s in out]


def jmi_score(result: MutualInfoResult) -> List[Tuple[int, float]]:
    """Joint Mutual Information greedy: gain = Σ_{s∈S} I((f,s); class)."""
    pos = result.pair_pos()
    jmi = result.pair_class_mi

    def gain(f, sel):
        return sum(jmi[pos[(min(f, s), max(f, s))]] for s in sel)

    first = int(np.argmax(result.feature_class_mi))
    out = _greedy(result.num_features, first, gain)
    return [(f, (float(result.feature_class_mi[f]) if np.isnan(s) else s)) for f, s in out]


def disr_score(result: MutualInfoResult) -> List[Tuple[int, float]]:
    """Double Input Symmetrical Relevance: gain = Σ_s I((f,s);c) / H(f,s,c)."""
    pos = result.pair_pos()
    jmi = result.pair_class_mi
    ent = result.pair_class_entropy

    def gain(f, sel):
        return sum(jmi[k] / max(ent[k], 1e-12)
                   for k in (pos[(min(f, s), max(f, s))] for s in sel))

    first = int(np.argmax(result.feature_class_mi))
    out = _greedy(result.num_features, first, gain)
    return [(f, (float(result.feature_class_mi[f]) if np.isnan(s) else s)) for f, s in out]


def mrmr_score(result: MutualInfoResult) -> List[Tuple[int, float]]:
    """min-Redundancy-Max-Relevance greedy: gain = I(f;c) − mean_{s∈S} I(f;s)."""
    mi_c = result.feature_class_mi
    pos = result.pair_pos()
    pmi = result.feature_pair_mi

    def gain(f, sel):
        red = sum(pmi[pos[(min(f, s), max(f, s))]] for s in sel) / len(sel)
        return mi_c[f] - red

    first = int(np.argmax(mi_c))
    out = _greedy(result.num_features, first, gain)
    return [(f, (float(mi_c[f]) if np.isnan(s) else s)) for f, s in out]


SCORE_ALGORITHMS = {
    "mutual.info.maximization": mim_score,
    "mutual.info.selection": mifs_score,
    "joint.mutual.info": jmi_score,
    "double.input.symmetrical.relevance": disr_score,
    "min.redundancy.max.relevance": mrmr_score,
    # short aliases
    "mim": mim_score, "mifs": mifs_score, "jmi": jmi_score,
    "disr": disr_score, "mrmr": mrmr_score,
}


def score_features(result: MutualInfoResult, algorithm: str, **kwargs) -> List[Tuple[int, float]]:
    try:
        fn = SCORE_ALGORITHMS[algorithm]
    except KeyError:
        raise ValueError(f"unknown scoring algorithm {algorithm!r}; "
                         f"known: {sorted(set(SCORE_ALGORITHMS))}") from None
    return fn(result, **kwargs)
