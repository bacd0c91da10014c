"""kNN jobs — the reference's kNN pipeline on the in-process engine; port
of ``avenir_tpu/jobs/knn.py``.

The reference pipeline (resource/knn.sh:16-137): 1) sifarish
SameTypeSimilarity computes all-pairs distances (external); 2-3) optional
BayesianDistribution + BayesianPredictor produce per-record class posteriors;
4) FeatureCondProbJoiner attaches them to neighbor rows; 5) NearestNeighbor
classifies/regresses over the top-k neighbors.  Here the distances come
from ``models/knn.py`` (the B5/B6 kernels on ``cuda``), so:

- :class:`SameTypeSimilarity` emits the (testID, trainID, scaled distance)
  pair file for pipeline compatibility;
- :class:`FeatureCondProbJoiner` performs the same join in memory;
- :class:`NearestNeighbor` runs end-to-end from raw CSVs (train via
  ``training.data.path``), honoring the reference's kernel / weighting /
  arbitration properties — no precomputed distance file needed.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from avenir_tpu_torch.core.config import ConfigError, JobConfig
from avenir_tpu_torch.jobs.base import Job, read_lines, write_output
from avenir_tpu_torch.models import knn as mknn
from avenir_tpu_torch.models import naive_bayes as nb
from avenir_tpu_torch.utils.metrics import Counters


def _train_model(conf: JobConfig, enc=None, need_rows: bool = True):
    train_path = conf.get("training.data.path")
    if not train_path:
        raise ConfigError("training.data.path not set")
    return Job.encode_input(conf, train_path, encoder=enc,
                            need_rows=need_rows)


class SameTypeSimilarity(Job):
    """All-pairs top-k distance job (the external sifarish step the reference
    shells out to, resource/knn.sh:47-60) — (testID, trainID, intDistance)
    rows."""

    name = "SameTypeSimilarity"

    def execute(self, conf: JobConfig, input_path: str, output_path: str,
                counters: Counters) -> None:
        delim = conf.field_delim
        enc, train_ds, _train_rows = _train_model(conf, need_rows=False)
        _enc, test_ds, _test_rows = self.encode_input(
            conf, input_path, with_labels=False, encoder=enc,
            need_rows=False)
        model = mknn.fit_knn(train_ds)
        k = conf.get_int("top.match.count", 10)
        ids = (test_ds.ids if test_ds.ids is not None
               else [str(i) for i in range(test_ds.num_rows)])
        lines = mknn.pairwise_distance_lines(
            model, test_ds, [str(i) for i in ids], k,
            distance_scale=conf.get_int("distance.scale", 1000), delim=delim,
            ref_ids=train_ds.ids, device=self.device)
        write_output(output_path, lines)
        counters.set("Records", "Test", test_ds.num_rows)
        counters.set("Records", "Train", train_ds.num_rows)


class FeatureCondProbJoiner(Job):
    """Join class-conditional posteriors onto neighbor rows
    (knn/FeatureCondProbJoiner.java:153-178): input = distance-pair file,
    ``feature.prob.file.path`` = BayesianPredictor ``output.feature.prob.only``
    rows (id, classVal, prob); output rows gain the train record's per-class
    probs."""

    name = "FeatureCondProbJoiner"

    def execute(self, conf: JobConfig, input_path: str, output_path: str,
                counters: Counters) -> None:
        delim = conf.field_delim
        prob_path = conf.get("feature.prob.file.path")
        if not prob_path:
            raise ConfigError("feature.prob.file.path not set")
        probs: Dict[str, List[str]] = {}
        for ln in read_lines(prob_path):
            rid, cv, p = ln.split(delim)
            probs.setdefault(rid, []).extend([cv, p])
        out = []
        for ln in read_lines(input_path):
            parts = ln.split(delim)
            out.append(delim.join(parts + probs.get(parts[1], [])))
        write_output(output_path, out)
        counters.set("Records", "Joined", len(out))


class NearestNeighbor(Job):
    """Classification/regression over the k nearest neighbors, end-to-end.

    Honored properties (knn/NearestNeighbor.java): ``top.match.count``,
    ``kernel.function`` (none|linearMultiplicative|linearAdditive|gaussian),
    ``kernel.param``, ``class.condition.weighted`` (+ its misspelled twin
    ``class.condtion.weighted``, which the reference also reads),
    ``inverse.distance.weighted``, ``decision.threshold`` +
    ``positive.class.value``, ``use.cost.based.classifier`` + cost props,
    ``validation.mode``, ``prediction.mode`` = regression with
    ``regression.method`` (average|median|linear), ``knn.search.mode``
    (exact|approx: accepted for the reference jobs' configurations; both
    run the exact search).
    """

    name = "NearestNeighbor"

    def execute(self, conf: JobConfig, input_path: str, output_path: str,
                counters: Counters) -> None:
        from avenir_tpu_torch.jobs.bayesian import _cost_matrix
        delim = conf.field_delim
        regression = conf.get("prediction.mode") == "regression"
        validate = conf.get_bool("validation.mode", False)
        mode = conf.get("knn.search.mode", "exact")
        if mode not in ("exact", "approx"):
            raise ConfigError(f"unknown knn.search.mode {mode!r}; use "
                              f"exact|approx")
        enc, train_ds, train_rows = _train_model(conf, need_rows=regression)
        if regression:
            _e, test_ds, test_rows = self.encode_input(
                conf, input_path, with_labels=False, encoder=enc)
            test_lines = None
        else:
            _e, test_ds, test_lines = self.encode_input_with_lines(
                conf, input_path, with_labels=validate, encoder=enc)
            test_rows = None

        class_cond = (conf.get_bool("class.condition.weighted", False)
                      or conf.get_bool("class.condtion.weighted", False))
        class_probs = None
        if class_cond:
            model_path = conf.get("bayesian.model.file.path")
            if not model_path:
                raise ConfigError("class-conditional weighting requires "
                                  "bayesian.model.file.path")
            bayes = nb.model_from_lines(read_lines(model_path), enc, delim=delim)
            class_probs = nb.NaiveBayes(device=self.device).predict(
                bayes, train_ds).probs

        cost = (_cost_matrix(conf, train_ds.class_values)
                if conf.get_bool("use.cost.based.classifier") else None)
        est = mknn.KNN(
            k=conf.get_int("top.match.count", 10),
            kernel=conf.get("kernel.function", "none"),
            kernel_sigma=conf.get_float("kernel.param", 0.3),
            inverse_distance=conf.get_bool("inverse.distance.weighted", False),
            class_cond_weighting=class_cond,
            decision_threshold=conf.get_float("decision.threshold"),
            pos_class=conf.get("positive.class.value"),
            cost=cost,
            device=self.device,
        )
        out: List[str] = []
        if regression:
            target_ord = conf.get_int("regression.target.ordinal")
            if target_ord is None:
                raise ConfigError("regression mode requires regression.target.ordinal")
            values = train_rows[:, target_ord].astype(np.float64)
            model = est.fit(train_ds, values=values)
            method = conf.get("regression.method", "average")
            kwargs = {}
            if method == "linear":
                in_ord = conf.get_int("regression.input.var.ordinal")
                if in_ord is None:
                    raise ConfigError("regression.method=linear requires "
                                      "regression.input.var.ordinal")
                kwargs = dict(
                    input_var=np.asarray([r[in_ord] for r in test_rows], np.float64),
                    ref_input_var=train_rows[:, in_ord].astype(np.float64))
            pred = est.regress(model, test_ds, method=method, **kwargs)
            for row, p in zip(test_rows, pred):
                out.append(delim.join(list(row) + [f"{p:.6f}"]))
        else:
            model = est.fit(train_ds, class_probs=class_probs)
            result = est.predict(model, test_ds, validate=validate)
            for i, line in enumerate(test_lines):
                out.append(delim.join(
                    [line, train_ds.class_values[int(result.predicted[i])]]))
            if result.counters is not None:
                counters.merge(result.counters)
        write_output(output_path, out)
        counters.set("Records", "Processed", test_ds.num_rows)
