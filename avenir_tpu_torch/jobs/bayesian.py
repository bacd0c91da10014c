"""Naive-Bayes jobs — BayesianDistribution (train) and BayesianPredictor
(score) over ``models/naive_bayes.py``; port of the tabular paths of
``avenir_tpu/jobs/bayesian.py`` (bayesian/BayesianDistribution.java,
bayesian/BayesianPredictor.java)."""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from avenir_tpu_torch.core.config import ConfigError, JobConfig
from avenir_tpu_torch.jobs.base import Job, read_lines, write_output
from avenir_tpu_torch.models import naive_bayes as nb
from avenir_tpu_torch.utils.metrics import Counters


def _tabular_only(conf: JobConfig, job: str) -> None:
    if not conf.get_bool("tabular.input", True):
        raise NotImplementedError(
            f"{job}: the text-input path (tabular.input=false) is not ported "
            f"yet (ROADMAP.md, Queue 1)")


class BayesianDistribution(Job):
    """Train: CSV in → model-file CSV rows out (the reference's model layout,
    BayesianPredictor.java:186-224)."""

    name = "BayesianDistribution"

    def execute(self, conf: JobConfig, input_path: str, output_path: str,
                counters: Counters) -> None:
        _tabular_only(conf, self.name)
        nbayes = nb.NaiveBayes(laplace=conf.get_float("laplace.smoothing", 1.0),
                               device=self.device)
        # stream.checkpoint.dir persists (totals, cursor) every N chunks of
        # a stream.chunk.rows stream, so a killed run resumes (--resume)
        ckpt = self.stream_checkpointer(conf)
        enc, data, rows_fn = self.encoded_data_source(
            conf, input_path, counters, checkpointer=ckpt)
        model = nbayes.fit(data, accumulator=ckpt.accumulator if ckpt else None)
        lines = nb.model_to_lines(model, enc, delim=conf.field_delim)
        write_output(output_path, lines)
        if ckpt:
            ckpt.finish()
        counters.set("Records", "Processed", rows_fn())
        counters.set("Model", "Rows", len(lines))


def _cost_matrix(conf: JobConfig, class_values: List[str]) -> Optional[np.ndarray]:
    """Misclassification costs from the reference's property pair
    (``bp.predict.class`` names, ``bp.predict.class.cost`` values —
    BayesianPredictor.java:375-391) or a dense ``misclassification.cost``."""
    names = conf.get_list("bp.predict.class")
    costs = conf.get_float_list("bp.predict.class.cost")
    if names and costs:
        # cost of predicting class v when wrong; scale-invariant under argmin
        per_class = dict(zip(names, costs))
        c = len(class_values)
        mat = np.zeros((c, c))
        for pi, pv in enumerate(class_values):
            for ai in range(c):
                if ai != pi:
                    mat[ai, pi] = per_class.get(pv, 1.0)
        return mat
    flat = conf.get_float_list("misclassification.cost")
    if flat:
        c = len(class_values)
        return np.asarray(flat, np.float64).reshape(c, c)
    return None


class BayesianPredictor(Job):
    """Score: CSV in + model file → rows with predicted class appended.

    Honored properties (reference names): ``bayesian.model.file.path``,
    ``prediction.mode`` (validation → confusion-matrix counters),
    ``class.prob.diff.threshold`` (ambiguity flag,
    BayesianPredictor.java:319-326), ``use.cost.based.classifier`` + cost
    properties (:375-391), ``positive.class.value``,
    ``output.feature.prob.only`` (per-record class posterior rows, :276-286).
    """

    name = "BayesianPredictor"

    def execute(self, conf: JobConfig, input_path: str, output_path: str,
                counters: Counters) -> None:
        delim = conf.field_delim
        model_path = conf.get("bayesian.model.file.path")
        if not model_path:
            raise ConfigError("bayesian.model.file.path not set")
        _tabular_only(conf, self.name)
        validate = conf.get("prediction.mode", "prediction") == "validation"
        prob_only = conf.get_bool("output.feature.prob.only")
        if prob_only:                      # no echo: skip line collection
            enc, ds, _rows = self.encode_input(conf, input_path,
                                               with_labels=validate,
                                               need_rows=False)
            in_lines = None
        else:
            enc, ds, in_lines = self.encode_input_with_lines(
                conf, input_path, with_labels=validate)
        model = nb.model_from_lines(read_lines(model_path), enc, delim=delim)

        threshold = conf.get_float("class.prob.diff.threshold")
        if threshold is not None and threshold > 1.0:
            threshold /= 100.0          # reference thresholds are % ints
        cost = (_cost_matrix(conf, model.class_values)
                if conf.get_bool("use.cost.based.classifier") else None)
        result = nb.NaiveBayes(device=self.device).predict(
            model, ds, cost=cost, ambiguity_threshold=threshold,
            validate=validate, pos_class=conf.get("positive.class.value"))

        out: List[str] = []
        if prob_only:
            # (id or row-index, classVal, posterior) rows for the kNN joiner
            ids = ds.ids if ds.ids is not None else np.arange(ds.num_rows)
            for i in range(ds.num_rows):
                for ci, cv in enumerate(model.class_values):
                    out.append(delim.join(
                        [str(ids[i]), cv, f"{result.probs[i, ci]:.6f}"]))
        else:
            amb = result.ambiguous
            for i, line in enumerate(in_lines):
                items = [line, model.class_values[int(result.predicted[i])]]
                if amb is not None and bool(amb[i]):
                    items.append("ambiguous")
                out.append(delim.join(items))
        write_output(output_path, out)
        counters.set("Records", "Processed", ds.num_rows)
        counters.merge(result.counters)
