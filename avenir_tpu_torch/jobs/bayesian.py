"""Naive-Bayes jobs — BayesianDistribution (train) and BayesianPredictor
(score) over ``models/naive_bayes.py``, tabular and text input; port of
``avenir_tpu/jobs/bayesian.py`` (bayesian/BayesianDistribution.java,
bayesian/BayesianPredictor.java)."""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from avenir_tpu_torch.core.config import ConfigError, JobConfig
from avenir_tpu_torch.jobs.base import Job, input_files, read_lines, write_output
from avenir_tpu_torch.models import naive_bayes as nb
from avenir_tpu_torch.text.analyzer import tokenize
from avenir_tpu_torch.utils.metrics import ConfusionMatrix, Counters


class BayesianDistribution(Job):
    """Train: CSV in → model-file CSV rows out (the reference's model layout,
    BayesianPredictor.java:186-224)."""

    name = "BayesianDistribution"

    def execute(self, conf: JobConfig, input_path: str, output_path: str,
                counters: Counters) -> None:
        if not conf.get_bool("tabular.input", True):
            self._execute_text(conf, input_path, output_path, counters)
            return
        nbayes = nb.NaiveBayes(laplace=conf.get_float("laplace.smoothing", 1.0),
                               mesh=self.auto_mesh(conf), device=self.device)
        # stream.checkpoint.dir persists (totals, cursor) every N chunks of
        # a stream.chunk.rows stream, so a killed run resumes (--resume)
        ckpt = self.stream_checkpointer(conf)
        # in a fleet, chunks are owned round robin, the partial counts are
        # merged once at the end of the stream, and process 0 writes —
        # Hadoop's N-machine run of this job (BayesianDistribution.java:82)
        owner, acc, distributed = self.distributed_plan(conf, ckpt)
        enc, data, rows_fn = self.encoded_data_source(
            conf, input_path, counters, checkpointer=ckpt, mesh=nbayes.mesh,
            owner=owner)
        merged: dict = {}
        if distributed:
            data = self.distributed_stream(data, acc, rows_fn, merged)
            model = self.distributed_fit(
                lambda d: nbayes.fit(d, accumulator=acc), data, acc, merged)
        else:
            model = nbayes.fit(data, accumulator=acc)
        rows = merged["rows"] if distributed else rows_fn()
        lines = (nb.model_to_lines(model, enc, delim=conf.field_delim)
                 if model is not None else [])
        if self.is_output_writer():
            write_output(output_path, lines)
        if ckpt:
            ckpt.finish()
        counters.set("Records", "Processed", rows)
        counters.set("Model", "Rows", len(lines))

    def _execute_text(self, conf: JobConfig, input_path: str, output_path: str,
                      counters: Counters) -> None:
        """``tabular.input=false``: rows are ``text<delim>classVal``; each
        analyzer token becomes a bag-of-words feature under ordinal 1 —
        multinomial NB counts in the same model-row layout
        (BayesianDistribution.java:125-131,185-196; tokenization flags shared
        with WordCounter).  The vocabulary keeps insertion order; the
        class × token table is one flat int64 ``bincount`` on the job's
        device."""
        delim = conf.field_delim_regex
        stop = conf.get_bool("remove.stop.words", True)
        stem = conf.get_bool("stem.words", False)
        vocab: dict = {}
        token_codes: List[int] = []
        token_class: List[int] = []
        class_values: List[str] = []
        cmap: dict = {}
        doc_counts: List[int] = []
        n_rows = 0
        for f in input_files(input_path):
            with open(f) as fh:
                for line in fh:
                    line = line.rstrip("\n")
                    if not line.strip():
                        continue
                    items = line.split(delim)
                    text, cv = items[0], items[1]
                    if cv not in cmap:
                        cmap[cv] = len(class_values)
                        class_values.append(cv)
                        doc_counts.append(0)
                    ci = cmap[cv]
                    doc_counts[ci] += 1
                    n_rows += 1
                    for tok in tokenize(text, stopwords=stop, stem=stem):
                        token_codes.append(vocab.setdefault(tok, len(vocab)))
                        token_class.append(ci)
        c, v = len(class_values), len(vocab)
        if token_codes:
            flat = (np.asarray(token_class, np.int64) * v
                    + np.asarray(token_codes, np.int64))
            cv_counts = torch.bincount(torch.from_numpy(flat).to(self.device),
                                       minlength=c * v).reshape(c, v).cpu().numpy()
        else:
            cv_counts = np.zeros((max(c, 1), 0), np.int64)
        d = conf.field_delim
        lines: List[str] = []
        for ti, tok in enumerate(vocab):
            col = cv_counts[:, ti]
            for ci, cval in enumerate(class_values):
                if col[ci]:
                    lines.append(d.join([cval, "1", tok, str(int(col[ci]))]))
            lines.append(d.join(["", "1", tok, str(int(col.sum()))]))
        for ci, cval in enumerate(class_values):
            lines.append(d.join([cval, "", "", str(doc_counts[ci])]))
        write_output(output_path, lines)
        counters.set("Records", "Processed", n_rows)
        counters.set("Model", "Vocabulary", len(vocab))
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
        if not conf.get_bool("tabular.input", True):
            self._predict_text(conf, input_path, output_path, counters)
            return
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

    def _predict_text(self, conf: JobConfig, input_path: str, output_path: str,
                      counters: Counters) -> None:
        """``tabular.input=false``: multinomial-NB scoring of ``text[,class]``
        rows against a text-mode model, in Python ``math.log`` on the host
        (the reference trains text distributions but ships no text
        predictor; validation uses the second column as the actual class)."""
        delim = conf.field_delim_regex
        stop = conf.get_bool("remove.stop.words", True)
        stem = conf.get_bool("stem.words", False)
        laplace = conf.get_float("laplace.smoothing", 1.0)
        validate = conf.get("prediction.mode", "prediction") == "validation"

        # model rows: (classVal, 1, token, count) posteriors; (classVal,,,n) priors
        token_counts: dict = {}
        class_counts: dict = {}
        for line in read_lines(conf.get("bayesian.model.file.path")):
            items = line.split(delim)
            if len(items) >= 4 and items[0] and items[1] == "1":
                token_counts.setdefault(items[0], {})[items[2]] = float(items[3])
            elif len(items) >= 4 and items[0] and not items[1] and not items[2]:
                class_counts[items[0]] = float(items[3])
        class_values = sorted(class_counts)
        if not class_values:
            raise ValueError("text model has no class-prior rows")
        vocab_size = len({t for d in token_counts.values() for t in d})
        total_docs = sum(class_counts.values())
        class_token_totals = {cv: sum(token_counts.get(cv, {}).values())
                              for cv in class_values}

        d = conf.field_delim
        out: List[str] = []
        cm = ConfusionMatrix(class_values,
                             pos_class=conf.get("positive.class.value")) \
            if validate else None
        n_rows = 0
        unknown_actual = 0
        for f in input_files(input_path):
            with open(f) as fh:
                for line in fh:
                    line = line.rstrip("\n")
                    if not line.strip():
                        continue
                    items = line.split(delim)
                    toks = tokenize(items[0], stopwords=stop, stem=stem)
                    best, best_score = None, -math.inf
                    for cv in class_values:
                        score = math.log(class_counts[cv] / total_docs)
                        denom = class_token_totals[cv] + laplace * max(vocab_size, 1)
                        tc = token_counts.get(cv, {})
                        for t in toks:
                            score += math.log((tc.get(t, 0.0) + laplace) / denom)
                        if score > best_score:
                            best, best_score = cv, score
                    out.append(d.join(items + [best]))
                    n_rows += 1
                    if cm is not None and len(items) > 1:
                        if items[1] in class_values:
                            cm.add(class_values.index(items[1]),
                                   class_values.index(best))
                        else:
                            # actual class absent from the model: counted,
                            # not fatal mid-stream
                            unknown_actual += 1
        write_output(output_path, out)
        counters.set("Records", "Processed", n_rows)
        if cm is not None:
            cm.publish(counters)
            if unknown_actual:
                counters.set("Validation", "UnknownActualClass", unknown_actual)
