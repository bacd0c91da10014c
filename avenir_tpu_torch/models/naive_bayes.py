"""Naive Bayes — training and scoring; port of
``avenir_tpu/models/naive_bayes.py`` (the reference's
bayesian/BayesianDistribution.java, BayesianPredictor.java and
BayesianModel.java).

Binned features become class-conditional multinomial bins, unbinned numeric
features Gaussian class-conditional densities from (count, Σx, Σx²);
scoring is log prior + Σ log posterior, with argmax or cost-based
arbitration and an ambiguity flag.  The model file keeps the reference's
CSV row layout (BayesianPredictor.java:186-224), so a file written by
``avenir_tpu`` loads here unchanged.

Training counts are ``agg`` bincounts on the chosen device; the derived
log-probability tables are float64 numpy on the host, as in the JAX
package; scoring gathers them in float32 on the device and sums over
features one feature at a time, so the scores are the same bits on the CPU
and on CUDA.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field as dc_field
from typing import Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from avenir_tpu_torch.core.encoding import DatasetEncoder, EncodedDataset, peek_chunks
from avenir_tpu_torch.device import resolve_device
from avenir_tpu_torch.ops import agg
from avenir_tpu_torch.parallel.collectives import shard_sum
from avenir_tpu_torch.parallel.mesh import place_batch
from avenir_tpu_torch.utils.metrics import ConfusionMatrix, CostBasedArbitrator, Counters

_LOG2PI = float(np.log(2.0 * np.pi))


@dataclass
class NaiveBayesModel:
    """Sufficient statistics + derived log-probability tables."""

    class_values: List[str]
    n_bins: np.ndarray                                  # int [F]
    bin_counts: np.ndarray                              # float64 [F, B, C]
    class_counts: np.ndarray                            # float64 [C]
    cont_count: Optional[np.ndarray] = None             # float64 [C]
    cont_sum: Optional[np.ndarray] = None               # float64 [C, Fc]
    cont_sumsq: Optional[np.ndarray] = None             # float64 [C, Fc]
    laplace: float = 1.0

    @functools.cached_property
    def log_prior(self) -> np.ndarray:
        c = self.class_counts
        return np.log(np.maximum(c, 1e-300) / max(c.sum(), 1e-300))

    @functools.cached_property
    def log_posterior(self) -> np.ndarray:
        """[F, B, C] log P(bin | class), Laplace-smoothed over valid bins."""
        f, b, _ = self.bin_counts.shape
        valid = (np.arange(b)[None, :] < self.n_bins[:, None])[..., None]   # [F,B,1]
        counts = self.bin_counts + self.laplace * valid
        totals = counts.sum(axis=1, keepdims=True)                          # [F,1,C]
        probs = np.where(valid, counts / np.maximum(totals, 1e-300), 1.0)
        return np.log(np.maximum(probs, 1e-300))

    @functools.cached_property
    def cont_stats(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """([C,Fc] mean, [C,Fc] std) for continuous features, or None."""
        if self.cont_sum is None or self.cont_sum.size == 0:
            return None
        cnt = np.maximum(self.cont_count, 1.0)[:, None]
        mean = self.cont_sum / cnt
        var = np.maximum(self.cont_sumsq / cnt - mean ** 2, 1e-12)
        # unbiased correction to match sample σ (reference divides by n−1)
        var = var * (cnt / np.maximum(cnt - 1.0, 1.0))
        return mean, np.sqrt(var)

    @property
    def num_classes(self) -> int:
        return len(self.class_values)

    def scoring_params(self, device: torch.device):
        """float32 scoring tables on ``device``, cached per device so repeated
        scoring does not re-upload them."""
        cache = self.__dict__.setdefault("_scoring_params", {})
        key = str(device)
        if key not in cache:
            mean_std = self.cont_stats
            if mean_std is None:
                mean = std = np.zeros((self.num_classes, 0), np.float32)
            else:
                mean, std = mean_std
            cache[key] = tuple(
                torch.as_tensor(np.asarray(a, np.float32), device=device)
                for a in (self.log_posterior, self.log_prior, mean, std))
        return cache[key]


def model_from_counts(
    class_values: Sequence[str],
    n_bins: np.ndarray,
    bin_counts: Optional[np.ndarray],
    class_counts: np.ndarray,
    cont_count: Optional[np.ndarray] = None,
    cont_sum: Optional[np.ndarray] = None,
    cont_sumsq: Optional[np.ndarray] = None,
    laplace: float = 1.0,
) -> NaiveBayesModel:
    """A :class:`NaiveBayesModel` from already-aggregated count tables,
    without touching data.  ``bin_counts=None`` means no binned features."""
    n_bins = np.asarray(n_bins, np.int64)
    f = len(n_bins)
    bmax = int(n_bins.max()) if f else 0
    c = len(class_values)
    if bin_counts is None:
        bin_counts = np.zeros((f, bmax, c))
    return NaiveBayesModel(
        class_values=list(class_values),
        n_bins=n_bins,
        bin_counts=np.asarray(bin_counts).astype(np.float64),
        class_counts=np.asarray(class_counts).astype(np.float64),
        cont_count=cont_count,
        cont_sum=cont_sum,
        cont_sumsq=cont_sumsq,
        laplace=laplace,
    )


def nb_log_scores(
    log_posterior: torch.Tensor,   # [F, B, C]
    log_prior: torch.Tensor,       # [C]
    cont_mean: torch.Tensor,       # [C, Fc]
    cont_std: torch.Tensor,        # [C, Fc]
    codes: torch.Tensor,           # [N, F]
    cont: torch.Tensor,            # [N, Fc]
) -> torch.Tensor:
    """[N, C] unnormalized log P(c | x) = log P(c) + Σ_f log P(x_f | c).
    The feature sums run one feature at a time, in a fixed order."""
    n, f = codes.shape
    idx = codes.long().clamp(min=0)
    gathered = log_posterior[torch.arange(f, device=codes.device)[None, :], idx]  # [N, F, C]
    total = torch.zeros((n, log_prior.shape[0]), dtype=torch.float32,
                        device=codes.device)
    for k in range(f):
        total = total + gathered[:, k]
    scores = log_prior[None, :] + total
    if cont_mean.shape[1]:
        x = cont[:, None, :]                     # [N, 1, Fc]
        mu = cont_mean[None, :, :]               # [1, C, Fc]
        sd = torch.clamp(cont_std[None, :, :], min=1e-6)
        logpdf = -0.5 * (((x - mu) / sd) ** 2) - torch.log(sd) - 0.5 * _LOG2PI
        total = torch.zeros_like(scores)
        for k in range(cont_mean.shape[1]):
            total = total + logpdf[:, :, k]
        scores = scores + total
    return scores


def predict_batch(model: NaiveBayesModel, codes: np.ndarray,
                  cont: np.ndarray, device=None) -> Tuple[np.ndarray, np.ndarray]:
    """([N, C] log scores, [N, C] normalized posteriors) — the one scoring
    entry of :meth:`NaiveBayes.predict`."""
    dev = resolve_device(device)
    params = model.scoring_params(dev)
    scores = nb_log_scores(*params, torch.from_numpy(codes).to(dev),
                           torch.from_numpy(cont).to(dev)).cpu().numpy()
    shifted = scores - scores.max(axis=1, keepdims=True)
    expd = np.exp(shifted)
    probs = expd / expd.sum(axis=1, keepdims=True)
    return scores, probs


@dataclass
class PredictionResult:
    log_scores: np.ndarray          # [N, C]
    probs: np.ndarray               # [N, C] normalized posteriors
    predicted: np.ndarray           # [N] class index after arbitration
    ambiguous: Optional[np.ndarray] = None      # [N] bool
    confusion: Optional[ConfusionMatrix] = None
    counters: Counters = dc_field(default_factory=Counters)

    def predicted_labels(self, class_values: Sequence[str]) -> List[str]:
        return [class_values[i] for i in self.predicted]


class NaiveBayes:
    """Estimator facade: ``fit`` over encoded chunks → :class:`NaiveBayesModel`
    → ``predict`` with arbitration; ``device`` defaults to ``cuda``.

    ``mesh``: an optional data mesh (``parallel/mesh.py``, the jobs'
    ``auto_mesh``): each chunk's rows are split over it (−1 pad rows
    count nothing) and every count is taken per shard and summed in shard
    order (``collectives.shard_sum``).  Counts equal the unsharded fit's;
    the Gaussian Σx and Σx² are float64 sums in shard order."""

    def __init__(self, laplace: float = 1.0, mesh=None, device=None):
        self.laplace = laplace
        self.mesh = mesh
        self.device = resolve_device(device)

    def fit(self, data: Union[EncodedDataset, Iterable[EncodedDataset]],
            accumulator: Optional[agg.Accumulator] = None) -> NaiveBayesModel:
        """``accumulator``: an accumulator owned by the caller, possibly
        restored from a snapshot — the streamed job passes its
        ``StreamCheckpointer``'s, so snapshots see the totals."""
        meta, chunks = peek_chunks(data)
        acc = accumulator if accumulator is not None else agg.Accumulator()
        for ds in chunks:
            meta = ds
            if ds.labels is None:
                raise ValueError("fit requires labels (class attribute column)")
            c, b = ds.num_classes, ds.max_bins
            codes, labels, cont = place_batch(self.mesh, self.device,
                                              ds.codes, ds.labels, ds.cont)
            if ds.num_binned:
                acc.add("bin_counts", shard_sum(
                    agg.feature_class_counts, codes, labels, c, b))
            acc.add("class_counts", shard_sum(agg.class_counts, labels, c))
            if ds.num_cont:
                cnt, s1, s2 = shard_sum(agg.class_moments, cont, labels, c)
                acc.add("cont_count", cnt)
                acc.add("cont_sum", s1)
                acc.add("cont_sumsq", s2)
        return model_from_counts(
            class_values=list(meta.class_values),
            n_bins=np.asarray(meta.n_bins, np.int64),
            bin_counts=(acc.get("bin_counts") if "bin_counts" in acc else None),
            class_counts=acc.get("class_counts"),
            cont_count=(acc.get("cont_count") if "cont_count" in acc else None),
            cont_sum=(acc.get("cont_sum") if "cont_sum" in acc else None),
            cont_sumsq=(acc.get("cont_sumsq") if "cont_sumsq" in acc else None),
            laplace=self.laplace,
        )

    def predict(
        self,
        model: NaiveBayesModel,
        ds: EncodedDataset,
        cost: Optional[np.ndarray] = None,
        ambiguity_threshold: Optional[float] = None,
        validate: bool = False,
        pos_class: Optional[str] = None,
    ) -> PredictionResult:
        scores, probs = predict_batch(model, ds.codes, ds.cont, self.device)
        if cost is not None:
            predicted = CostBasedArbitrator(model.class_values, cost).arbitrate(probs)
        else:
            predicted = np.argmax(probs, axis=1).astype(np.int32)
        ambiguous = None
        if ambiguity_threshold is not None:
            top2 = np.sort(probs, axis=1)[:, -2:]
            ambiguous = (top2[:, 1] - top2[:, 0]) < ambiguity_threshold
        result = PredictionResult(log_scores=scores, probs=probs, predicted=predicted, ambiguous=ambiguous)
        if validate:
            if ds.labels is None:
                raise ValueError("validation mode requires labels")
            cm = ConfusionMatrix(model.class_values, pos_class=pos_class)
            cm.add_batch(ds.labels, predicted)
            cm.publish(result.counters)
            result.confusion = cm
        return result


# ---------------------------------------------------------------------------
# model-file serde — the reference's CSV layout (BayesianPredictor.java:186-224)
# ---------------------------------------------------------------------------
#   classVal,featureOrd,bin,count            feature posterior (binned)
#   classVal,featureOrd,,mean,stdDev         feature posterior (continuous)
#   classVal,,,count                         class prior
#   ,featureOrd,bin,count                    feature prior (binned)
#   ,featureOrd,,mean,stdDev                 feature prior (continuous)

def model_to_lines(model: NaiveBayesModel, encoder: DatasetEncoder, delim: str = ",") -> List[str]:
    lines: List[str] = []
    ords = [f.ordinal for f in encoder.binned_fields]
    cont_ords = [f.ordinal for f in encoder.cont_fields]
    # feature posteriors + priors (binned)
    for fi, ordinal in enumerate(ords):
        nb = int(model.n_bins[fi])
        for b in range(nb):
            label = encoder.bin_label(fi, b)
            total = 0
            for ci, cv in enumerate(model.class_values):
                cnt = int(model.bin_counts[fi, b, ci])
                total += cnt
                if cnt:
                    lines.append(delim.join([cv, str(ordinal), label, str(cnt)]))
            if total:
                lines.append(delim.join(["", str(ordinal), label, str(total)]))
    # class priors
    for ci, cv in enumerate(model.class_values):
        lines.append(delim.join([cv, "", "", str(int(model.class_counts[ci]))]))
    # continuous posteriors + priors
    if model.cont_stats is not None:
        mean, std = model.cont_stats
        for fj, ordinal in enumerate(cont_ords):
            for ci, cv in enumerate(model.class_values):
                lines.append(delim.join([cv, str(ordinal), "", repr(float(mean[ci, fj])), repr(float(std[ci, fj]))]))
            cnt = model.cont_count
            tot = max(float(cnt.sum()), 1.0)
            pm = float((cnt * mean[:, fj]).sum() / tot)
            # pooled prior σ from total moments
            s2 = float(model.cont_sumsq[:, fj].sum())
            pv = max(s2 / tot - pm * pm, 1e-12) * (tot / max(tot - 1.0, 1.0))
            lines.append(delim.join(["", str(ordinal), "", repr(pm), repr(float(np.sqrt(pv)))]))
    return lines


def model_from_lines(
    lines: Iterable[str], encoder: DatasetEncoder, laplace: float = 1.0, delim: str = ","
) -> NaiveBayesModel:
    """Rebuild a model from the reference-layout CSV rows.

    Continuous rows carry (mean, std) rather than raw moments, so the moments
    are reconstituted with a nominal count — scoring depends only on
    (mean, std), which round-trips exactly.
    """
    ords = [f.ordinal for f in encoder.binned_fields]
    cont_ords = [f.ordinal for f in encoder.cont_fields]
    ord_to_fi = {o: i for i, o in enumerate(ords)}
    ord_to_cj = {o: j for j, o in enumerate(cont_ords)}
    class_values = list(encoder.class_values)
    cmap = {v: i for i, v in enumerate(class_values)}
    f = len(ords)
    nb = np.array([encoder.n_bins[o] for o in ords], np.int64) if f else np.zeros(0, np.int64)
    bmax = int(nb.max()) if f else 0
    c = len(class_values)
    bin_counts = np.zeros((f, bmax, c))
    class_counts = np.zeros(c)
    fc = len(cont_ords)
    mean = np.zeros((c, fc))
    std = np.ones((c, fc))
    n_nominal = 1000.0
    for line in lines:
        items = line.rstrip("\n").split(delim)
        if not any(items):
            continue
        featur_ord = int(items[1]) if items[1] != "" else -1
        if items[0] == "":
            continue  # feature priors are derivable; skip
        if items[1] == "" and items[2] == "":
            class_counts[cmap[items[0]]] += float(items[3])
        elif items[2] != "":
            fi = ord_to_fi[featur_ord]
            code = encoder.bin_code(fi, items[2])
            bin_counts[fi, code, cmap[items[0]]] += float(items[3])
        else:
            cj = ord_to_cj[featur_ord]
            ci = cmap[items[0]]
            mean[ci, cj] = float(items[3])
            std[ci, cj] = float(items[4])
    cont_count = cont_sum = cont_sumsq = None
    if fc:
        cont_count = np.full(c, n_nominal)
        cont_sum = mean * n_nominal
        # invert the unbiased-σ derivation in cont_stats for round-trip
        var_b = (std ** 2) * ((n_nominal - 1.0) / n_nominal)
        cont_sumsq = (var_b + mean ** 2) * n_nominal
    return NaiveBayesModel(
        class_values=class_values, n_bins=nb, bin_counts=bin_counts,
        class_counts=class_counts, cont_count=cont_count,
        cont_sum=cont_sum, cont_sumsq=cont_sumsq, laplace=laplace,
    )
