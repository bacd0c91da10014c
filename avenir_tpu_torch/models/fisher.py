"""Univariate Fisher discriminant (binary LDA per attribute) — port of
``avenir_tpu/models/fisher.py`` (the reference's
discriminant/FisherDiscriminant.java).

Per (attribute, class) count, mean and variance, then per attribute the
pooled variance, the log-odds of the class priors, and the decision
boundary ``(μ₀+μ₁)/2 − logOdds·σ²_pooled/(μ₀−μ₁)`` (:83-117).  The moments
are ``agg.class_moments`` sums, in float64 on the fit's device (per shard
and summed in shard order under a data ``mesh``); the closed form runs in
float64 numpy on the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, Optional, Union

import numpy as np

from avenir_tpu_torch.core.encoding import EncodedDataset, NoDataError
from avenir_tpu_torch.device import resolve_device
from avenir_tpu_torch.ops import agg
from avenir_tpu_torch.parallel.collectives import shard_sum
from avenir_tpu_torch.parallel.mesh import place_batch


@dataclass
class FisherDiscriminantModel:
    class_values: List[str]              # exactly two
    mean: np.ndarray                     # [2, F]
    var: np.ndarray                      # [2, F] unbiased per-class variance
    count: np.ndarray                    # [2]
    pooled_var: np.ndarray               # [F]
    log_odds: float                      # log(P(c1)/P(c0))
    boundary: np.ndarray                 # [F]

    def to_lines(self, feature_names: Optional[List[str]] = None, delim: str = ",") -> List[str]:
        names = feature_names or [f"f{i}" for i in range(self.mean.shape[1])]
        return [
            delim.join([
                names[f],
                repr(float(self.pooled_var[f])),
                repr(float(self.log_odds)),
                repr(float(self.boundary[f])),
            ])
            for f in range(self.mean.shape[1])
        ]


def model_from_moments(class_values: List[str], cnt: np.ndarray,
                       s1: np.ndarray, s2: np.ndarray) -> FisherDiscriminantModel:
    """:class:`FisherDiscriminantModel` from aggregated per-class
    (count [2], Σx [2, F], Σx² [2, F]) sums, without touching data: the
    finalize step of :meth:`FisherDiscriminant.fit` and of the SharedScan
    consumer."""
    if len(class_values) != 2:
        raise ValueError("Fisher discriminant requires exactly two classes")
    if s1.shape[1] == 0:
        raise ValueError("Fisher discriminant requires continuous features")
    cnt = np.asarray(cnt, np.float64)                 # [2]
    s1 = np.asarray(s1, np.float64)                   # [2, F]
    s2 = np.asarray(s2, np.float64)
    n = np.maximum(cnt, 1.0)[:, None]
    mean = s1 / n
    var_b = np.maximum(s2 / n - mean ** 2, 1e-12)
    var = var_b * (n / np.maximum(n - 1.0, 1.0))      # unbiased, as (n−1) division
    pooled = (((n - 1.0) * var).sum(axis=0) / np.maximum(cnt.sum() - 2.0, 1.0))
    log_odds = float(np.log(max(cnt[1], 1e-9) / max(cnt[0], 1e-9)))
    delta = mean[0] - mean[1]
    safe_delta = np.where(np.abs(delta) > 1e-9, delta, 1e-9)
    boundary = (mean[0] + mean[1]) / 2.0 - log_odds * pooled / safe_delta
    return FisherDiscriminantModel(
        class_values=list(class_values), mean=mean, var=var, count=cnt,
        pooled_var=pooled, log_odds=log_odds, boundary=boundary,
    )


class FisherDiscriminant:
    """Fit on ``device`` (``cuda`` unless the caller asks for the CPU),
    over an optional data ``mesh`` (``parallel/mesh.py``)."""

    def __init__(self, mesh=None, device=None):
        self.mesh = mesh
        self.device = resolve_device(device)

    def fit(self, data: Union[EncodedDataset, Iterable[EncodedDataset]]) -> FisherDiscriminantModel:
        chunks = [data] if isinstance(data, EncodedDataset) else data
        acc = agg.Accumulator()
        meta = None
        for ds in chunks:
            meta = ds
            if ds.labels is None:
                raise ValueError("fit requires labels")
            cont, labels = place_batch(self.mesh, self.device, ds.cont,
                                       ds.labels)
            cnt, s1, s2 = shard_sum(agg.class_moments, cont, labels,
                                    ds.num_classes)
            acc.add("cnt", cnt)
            acc.add("s1", s1)
            acc.add("s2", s2)
        if meta is None:
            raise NoDataError("no data")
        if meta.num_classes != 2:
            raise ValueError("Fisher discriminant requires exactly two classes")
        if meta.num_cont == 0:
            raise ValueError("Fisher discriminant requires continuous features")
        return model_from_moments(list(meta.class_values), acc.get("cnt"),
                                  acc.get("s1"), acc.get("s2"))

    @staticmethod
    def predict(model: FisherDiscriminantModel, values: np.ndarray, attr: int = 0) -> np.ndarray:
        """[N] class index from one attribute's boundary: the side of the
        boundary nearer class 1's mean predicts class 1."""
        b = model.boundary[attr]
        class1_above = model.mean[1, attr] > model.mean[0, attr]
        above = values[:, attr] > b
        return np.where(above == class1_above, 1, 0).astype(np.int32)
