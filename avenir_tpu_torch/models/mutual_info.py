"""Mutual-information feature analysis — port of
``avenir_tpu/models/mutual_info.py`` (the reference's
explore/MutualInformation.java and MutualInformationScore.java).

One pass counts the class vector, the [F, B, C] feature-class tensor and
the [P, B, B, C] pair-class tensor; every reference distribution family and
MI statistic derives from them.  On CUDA the counts come from the
co-occurrence gram kernels (``ops/hist.py``), read out once at the end; on
the CPU, and for shapes outside every kernel gate, from the integer
``agg`` counts.  Both give the same counts.  MI values are in nats.

Under a data mesh (``mesh=``, the jobs' ``auto_mesh``) the route follows
the JAX package on the same kind of mesh: on a mesh of CUDA cards (the
JAX package's TPU mesh) each shard's gram is B1–B3 on its card, summed
exactly (``collectives.sharded_cooc_step``), under the plain ``g_key``;
on a CPU mesh each shard's ``agg`` counts, summed (the ``fc`` /
``pcc<s>`` keys).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from avenir_tpu_torch.core.encoding import EncodedDataset, peek_chunks
from avenir_tpu_torch.device import resolve_device
from avenir_tpu_torch.ops import agg, hist, info
from avenir_tpu_torch.parallel.collectives import shard_sum, sharded_cooc_step
from avenir_tpu_torch.parallel.mesh import mesh_on_cuda, place_batch


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

    # -- distribution views (the reference's 7 families) ---------------------
    def class_distr(self) -> np.ndarray:
        return self.class_counts / self.class_counts.sum()

    def feature_distr(self) -> np.ndarray:
        fc = self.feature_class_counts.sum(-1)
        return fc / np.maximum(fc.sum(-1, keepdims=True), 1)

    def feature_pair_distr(self) -> np.ndarray:
        pc = self.pair_class_counts.sum(-1)
        return pc / np.maximum(pc.sum((-2, -1), keepdims=True), 1)

    def feature_class_cond_distr(self) -> np.ndarray:
        """[F, B, C] P(bin | class) — the reference's feature-class-conditional."""
        fcc = self.feature_class_counts
        return fcc / np.maximum(fcc.sum(1, keepdims=True), 1)

    def feature_pair_class_cond_distr(self) -> np.ndarray:
        """[P, B, B, C] P(bin_i, bin_j | class)."""
        pcc = self.pair_class_counts
        return pcc / np.maximum(pcc.sum((1, 2), keepdims=True), 1)

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
    tensor on the ``agg`` route; ``device`` defaults to ``cuda``;
    ``mesh`` is an optional data mesh (module docstring)."""

    def __init__(self, pair_chunk: int = 256, mesh=None, device=None):
        self.pair_chunk = pair_chunk
        self.mesh = mesh
        self.device = resolve_device(device)

    def fit(self, data: Union[EncodedDataset, Iterable[EncodedDataset]],
            feature_names: Optional[Sequence[str]] = None,
            accumulator: Optional[agg.Accumulator] = None) -> MutualInfoResult:
        """``accumulator``: an accumulator owned by the caller, possibly
        restored from a snapshot (the streamed job's ``StreamCheckpointer``).
        Its keys decide the route of a resumed run: a G total under another
        layout's key is refused; a G total where the kernel does not apply
        (a run crashed on ``cuda``, resumed on the CPU) becomes the ``agg``
        route's ``fc`` / ``pcc<s>`` tensors, exactly; ``agg``-route totals
        keep the resumed run on that route."""
        meta, chunks = peek_chunks(data)
        if meta.labels is None:
            raise ValueError("mutual information requires a class attribute")
        f, b, c = meta.num_binned, meta.max_bins, meta.num_classes
        pair_index = all_pairs(f)
        acc = accumulator if accumulator is not None else agg.Accumulator()
        # kernel route: one gram per chunk (B1, or B2/B3 in the per-class
        # plan modes), accumulated as G and read out once at the end; on
        # a mesh of cards, one gram a shard, summed
        if self.mesh is None:
            kernel = hist.use_kernel(f, b, c, self.device)
            gram = lambda cd, lb: hist.cooc_counts(cd, lb, b, c)  # noqa: E731
        else:
            kernel = mesh_on_cuda(self.mesh) and hist.applicable(f, b, c)
            gram = sharded_cooc_step(self.mesh, b, c)
        gk = hist.g_key(f, b, c)
        if accumulator is not None:
            stale = [k for k in accumulator.names()
                     if (k == "g" or k.startswith("g:")) and k != gk]
            if stale:
                raise ValueError(
                    f"checkpoint holds count matrix {stale[0]!r} from an "
                    f"incompatible kernel layout (this build uses {gk!r}); "
                    f"restart the job without --resume")
            if gk in accumulator and not kernel:
                g = accumulator.state()
                fc0, pcc0 = hist.counts_from_cooc(
                    g.pop(gk), f, b, c, pair_index[:, 0], pair_index[:, 1])
                g["fc"] = fc0
                for s in range(0, len(pair_index), self.pair_chunk):
                    g[f"pcc{s}"] = pcc0[s:s + self.pair_chunk]
                accumulator.load(g)
            elif "fc" in accumulator and kernel:
                kernel = False
        for ds in chunks:
            codes, labels = place_batch(self.mesh, self.device, ds.codes,
                                        ds.labels)
            acc.add("class", shard_sum(agg.class_counts, labels, c))
            if kernel:
                acc.add(gk, gram(codes, labels))
                continue
            acc.add("fc", shard_sum(agg.feature_class_counts, codes, labels,
                                    c, b))
            for s in range(0, len(pair_index), self.pair_chunk):
                sl = torch.from_numpy(pair_index[s:s + self.pair_chunk]).long()
                # the pcc<s> keys are the port contract's keys and must not be
                # renamed: MI always counts all pairs for a given F, so the chunk
                # keys are fully determined by (F, B, C), which the resume gate
                # validates; a fingerprint would add no safety
                # graftlint: disable=GL002
                acc.add(f"pcc{s}", shard_sum(agg.pair_class_counts_at,
                                             codes, labels, sl, c, b))
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
