"""Model registry — port of ``avenir_tpu/serving/registry.py``: every
trained family servable from parameters resident on one device.

The reference's prediction surface is offline map-only MR jobs
(``BayesianPredictor``, ``ViterbiStatePredictor``, ``NearestNeighbor``): a
trained model can only score a file.  Here each trained artifact becomes a
:class:`ServableModel` whose parameters go to its ``device`` once, at
load, and a :class:`ModelRegistry` maps model names to entries.

Parity contract (tests/test_torch_serving.py): every servable scores
through the model-layer entry its batch job uses
(``models.naive_bayes.predict_batch`` through ``NaiveBayes.predict``,
``models.tree.predict_fn``, ``models.knn.KNN.predict``,
``models.markov.ViterbiStatePredictor``, ``models.logistic.predict_batch``)
and formats its response as the job's output line, so a response is byte
for byte the batch prediction of the same row.  Pad rows the batcher adds
are sliced off before formatting and never reach a response.

``device`` is ``cuda`` unless the caller asks for the CPU.  On ``cuda``
the kNN servable's buckets launch B5 (``csrc/knn_tourney.cu``, a large
reference set) or B6 (``csrc/knn_topk.cu``) once per dispatch through
``ops/knn.search``; there is no plain fallback.  As in the JAX package,
the kNN and Viterbi servables take the batch job's placement,
``jobs/base.py::auto_mesh`` on the servable's own device: a data mesh
over two or more local devices (the references, or the records, split
over it), None on one card.

Compile keys keep the JAX package's meaning as shape keys: PyTorch
compiles nothing here, but a bucket shape outside the warmed set still
counts as a recompile, so "zero recompiles after warmup" stays a checked
invariant of the batcher.

Artifacts load through the jobs' own keys (``bayesian.model.file.path``,
``coeff.file.path``, ``tree.model.file.path``, ``training.data.path``,
``hmm.model.file.path``), so a pipeline stage's output plugs into
``serve.models`` (``serving/replay.py`` is the pipeline stage).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from avenir_tpu_torch.core.config import ConfigError, JobConfig
from avenir_tpu_torch.core.csv_io import read_csv_string
from avenir_tpu_torch.core.encoding import (DatasetEncoder, EncodedDataset,
                                            pad_ballast)
from avenir_tpu_torch.device import resolve_device
from avenir_tpu_torch.jobs.base import Job, auto_mesh, read_lines
from avenir_tpu_torch.serving.errors import RequestError, UnknownModelError


# ---------------------------------------------------------------------------
# shared plumbing
# ---------------------------------------------------------------------------

def _pad_ds(ds: EncodedDataset, pad_to: int) -> EncodedDataset:
    """Pad the batch axis with zero rows up to the bucket size.  The caller
    slices outputs back to the real rows, so a pad row's score is never
    read; ``fill=0`` keeps pad rows in the vocabulary."""
    if pad_to < ds.num_rows:
        raise ValueError(f"batch of {ds.num_rows} rows exceeds bucket {pad_to}")
    return pad_ballast(ds, pad_to, fill=0)


def _blank_ds(enc: DatasetEncoder, n: int) -> EncodedDataset:
    """An all-zeros encoded batch of ``n`` rows in ``enc``'s code space:
    the warmup operand of a bucket shape."""
    return EncodedDataset(
        codes=np.zeros((n, len(enc.binned_fields)), np.int32),
        cont=np.zeros((n, len(enc.cont_fields)), np.float32),
        labels=None, ids=None,
        n_bins=np.array([enc.n_bins[f.ordinal] for f in enc.binned_fields],
                        np.int32),
        class_values=list(enc.class_values),
        binned_ordinals=[f.ordinal for f in enc.binned_fields],
        cont_ordinals=[f.ordinal for f in enc.cont_fields])


def _parse_rows(lines: Sequence[str], delim: str,
                max_ordinal: int) -> np.ndarray:
    """Request payloads → [N, ncols] field array; a data error a batch job
    would throw is raised as a typed :class:`RequestError`.  It fails the
    whole padded batch; the batcher then re-scores each member alone, so
    one bad request never fails its neighbours."""
    try:
        rows = read_csv_string("\n".join(lines), delim=delim)
    except ValueError as e:
        raise RequestError(f"unparseable request rows: {e}") from None
    if rows.shape[0] != len(lines):
        raise RequestError("blank request rows are not servable")
    if rows.shape[1] <= max_ordinal:
        raise RequestError(
            f"request rows carry {rows.shape[1]} fields but the schema "
            f"reads ordinal {max_ordinal}")
    return rows


def _complete_encoder(conf: JobConfig) -> DatasetEncoder:
    """A transform-ready encoder from the schema alone: online scoring has
    no training pass to fit vocabularies from."""
    enc = Job.encoder_for(conf)
    if not enc.schema_complete(with_labels=False) or not enc.class_values:
        raise ConfigError(
            "serving requires a schema-complete encoder (categorical "
            "cardinality / numeric min+max+bucketWidth, and class "
            "cardinality) — online requests cannot fit a vocabulary")
    return enc


class ServableModel:
    """One loaded model: parameters resident on ``device`` and a scorer
    over padded bucket shapes.

    ``compile_keys`` records every (bucket, ...) shape this entry has
    dispatched; the batcher diffs it after each batch to count shapes
    outside the warmed set (zero after warmup is the serving plane's
    invariant)."""

    family: str = ""

    def __init__(self) -> None:
        self.compile_keys: Set[Tuple] = set()

    def score_lines(self, lines: Sequence[str], pad_to: int) -> List[str]:
        """Score ``lines`` (raw CSV request rows) padded to ``pad_to``;
        returns exactly ``len(lines)`` response lines."""
        raise NotImplementedError

    def warmup(self, pad_to: int) -> None:
        """Run the ``pad_to`` bucket shape once on a blank batch."""
        raise NotImplementedError


# ---------------------------------------------------------------------------
# Naive Bayes
# ---------------------------------------------------------------------------

class NaiveBayesServable(ServableModel):
    """BayesianPredictor's scoring path online: response line =
    ``<request row>,<predictedClass>[,ambiguous]``, the job's output row
    (cost-based arbitration and the ambiguity flag included)."""

    family = "naiveBayes"

    def __init__(self, model, encoder: DatasetEncoder, delim: str = ",",
                 cost: Optional[np.ndarray] = None,
                 ambiguity_threshold: Optional[float] = None, device=None):
        from avenir_tpu_torch.models import naive_bayes as nb

        super().__init__()
        self.model = model
        self.enc = encoder
        self.delim = delim
        self.cost = cost
        self.ambiguity_threshold = ambiguity_threshold
        self.device = resolve_device(device)
        self._nb = nb.NaiveBayes(device=self.device)
        model.scoring_params(self.device)     # the upload happens at load

    @classmethod
    def from_conf(cls, conf: JobConfig, device=None) -> "NaiveBayesServable":
        from avenir_tpu_torch.jobs.bayesian import _cost_matrix
        from avenir_tpu_torch.models import naive_bayes as nb

        path = conf.get("bayesian.model.file.path")
        if not path:
            raise ConfigError("serving naiveBayes requires "
                              "bayesian.model.file.path")
        enc = _complete_encoder(conf)
        model = nb.model_from_lines(read_lines(path), enc,
                                    delim=conf.field_delim)
        threshold = conf.get_float("class.prob.diff.threshold")
        if threshold is not None and threshold > 1.0:
            threshold /= 100.0            # reference thresholds are % ints
        cost = (_cost_matrix(conf, model.class_values)
                if conf.get_bool("use.cost.based.classifier") else None)
        return cls(model, enc, delim=conf.field_delim, cost=cost,
                   ambiguity_threshold=threshold, device=device)

    def _score_ds(self, ds: EncodedDataset):
        return self._nb.predict(self.model, ds, cost=self.cost,
                                ambiguity_threshold=self.ambiguity_threshold)

    def score_lines(self, lines: Sequence[str], pad_to: int) -> List[str]:
        rows = _parse_rows(lines, self.delim, self.enc.max_ordinal(False))
        ds = _pad_ds(self.enc.transform(rows, with_labels=False), pad_to)
        self.compile_keys.add((pad_to,))
        result = self._score_ds(ds)
        out = []
        for i, line in enumerate(lines):
            items = [line, self.model.class_values[int(result.predicted[i])]]
            if result.ambiguous is not None and bool(result.ambiguous[i]):
                items.append("ambiguous")
            out.append(self.delim.join(items))
        return out

    def warmup(self, pad_to: int) -> None:
        self.compile_keys.add((pad_to,))
        self._score_ds(_blank_ds(self.enc, pad_to))


# ---------------------------------------------------------------------------
# logistic regression
# ---------------------------------------------------------------------------

class LogisticServable(ServableModel):
    """Online LR scoring from the coefficient-history artifact.  The
    reference had no LR scoring job, so the response format is the JAX
    package's own: ``<request row>,<0|1>,<probability .6f>``."""

    family = "logistic"

    def __init__(self, weights: np.ndarray, encoder: DatasetEncoder,
                 delim: str = ",", threshold: float = 0.5, device=None):
        super().__init__()
        self.enc = encoder
        self.delim = delim
        self.threshold = threshold
        self.device = resolve_device(device)
        self.weights = torch.as_tensor(
            np.asarray(weights, np.float32)).to(self.device)

    @classmethod
    def from_conf(cls, conf: JobConfig, device=None) -> "LogisticServable":
        from avenir_tpu_torch.models import logistic as mlr

        path = conf.get("coeff.file.path")
        if not path:
            raise ConfigError("serving logistic requires coeff.file.path")
        model = mlr.LogisticRegressionModel.from_history_lines(
            read_lines(path), delim=conf.field_delim)
        return cls(model.weights, _complete_encoder(conf),
                   delim=conf.field_delim,
                   threshold=conf.get_float("decision.threshold", 0.5),
                   device=device)

    def _design(self, ds: EncodedDataset) -> torch.Tensor:
        from avenir_tpu_torch.models import logistic as mlr

        x = mlr.design_matrix(ds, device=self.device)
        if x.shape[1] != self.weights.shape[0]:
            raise ConfigError(
                f"design width {x.shape[1]} != coefficient count "
                f"{self.weights.shape[0]} — the schema does not match the "
                f"one the coefficients were trained under")
        return x

    def score_lines(self, lines: Sequence[str], pad_to: int) -> List[str]:
        from avenir_tpu_torch.models import logistic as mlr

        rows = _parse_rows(lines, self.delim, self.enc.max_ordinal(False))
        x = self._design(self.enc.transform(rows, with_labels=False))
        x = torch.nn.functional.pad(x, (0, 0, 0, pad_to - x.shape[0]))
        self.compile_keys.add((pad_to,))
        probs, pred = mlr.predict_batch(self.weights, x,
                                        threshold=self.threshold,
                                        device=self.device)
        return [f"{line}{self.delim}{int(pred[i])}{self.delim}{probs[i]:.6f}"
                for i, line in enumerate(lines)]

    def warmup(self, pad_to: int) -> None:
        from avenir_tpu_torch.models import logistic as mlr

        self.compile_keys.add((pad_to,))
        mlr.predict_batch(self.weights,
                          torch.zeros((pad_to, int(self.weights.shape[0])),
                                      device=self.device),
                          threshold=self.threshold, device=self.device)


# ---------------------------------------------------------------------------
# decision tree
# ---------------------------------------------------------------------------

class TreeServable(ServableModel):
    """DecisionTreeBuilder's scoring mode online: the saved JSON model
    (with its train-time encoder state) drives the node walker over flat
    tensors resident on ``device``; response line =
    ``<fields...>,<predictedClass>`` as ``jobs/tree.py::_predict`` writes
    it.  The compile key carries the walker's padded shape signature, so a
    hot swap onto a retrained tree inside the same buckets counts no new
    shape."""

    family = "tree"

    def __init__(self, model, encoder: DatasetEncoder, delim: str = ",",
                 device=None):
        from avenir_tpu_torch.models import tree as dtree

        super().__init__()
        self.model = model
        self.enc = encoder
        self.delim = delim
        self.device = resolve_device(device)
        self.walk = dtree.predict_fn(model, device=self.device)
        self._shape_sig = dtree.predict_shape_signature(model)

    @classmethod
    def from_conf(cls, conf: JobConfig, device=None) -> "TreeServable":
        import json

        from avenir_tpu_torch.models import tree as dtree

        path = conf.get("tree.model.file.path")
        if not path:
            raise ConfigError("serving tree requires tree.model.file.path")
        model_lines = read_lines(path)
        model = dtree.DecisionTreeModel.from_string(model_lines[0])
        enc = Job.encoder_for(conf)
        if len(model_lines) > 1:
            enc.load_state_dict(json.loads(model_lines[1])["encoder"])
        elif not (enc.schema_complete(with_labels=False) and enc.class_values):
            raise ConfigError(
                "tree model file has no encoder-state line and the schema "
                "does not fully specify the encoding — re-train with this "
                "version to embed encoder state")
        return cls(model, enc, delim=conf.field_delim, device=device)

    def _walk(self, codes: np.ndarray) -> np.ndarray:
        pred, _distr = self.walk(torch.from_numpy(codes).to(self.device))
        return pred.cpu().numpy()

    def score_lines(self, lines: Sequence[str], pad_to: int) -> List[str]:
        rows = _parse_rows(lines, self.delim, self.enc.max_ordinal(False))
        ds = _pad_ds(self.enc.transform(rows, with_labels=False), pad_to)
        self.compile_keys.add((pad_to,) + self._shape_sig)
        pred = self._walk(ds.codes)
        return [self.delim.join(list(r) + [self.model.class_values[int(p)]])
                for r, p in zip(rows, pred[:len(lines)])]

    def warmup(self, pad_to: int) -> None:
        self.compile_keys.add((pad_to,) + self._shape_sig)
        self._walk(_blank_ds(self.enc, pad_to).codes)


# ---------------------------------------------------------------------------
# k nearest neighbors
# ---------------------------------------------------------------------------

class KNNServable(ServableModel):
    """NearestNeighbor classification online: the reference set's packed
    operand and re-rank arrays go to ``device`` once, at load, and each
    bucket scores through the same search and kernel-weighted vote the
    batch job runs — on ``cuda`` one B5 or B6 launch per dispatch (the
    bucket padded to the kernel's tile), then the exact re-rank and the
    certificate.  Every route orders by (exact d², reference index), so a
    row's answer does not depend on its bucket neighbours.  Response line
    = ``<request row>,<predictedClass>``; regression stays batch-only."""

    family = "knn"

    def __init__(self, est, model, encoder: DatasetEncoder, delim: str = ","):
        from avenir_tpu_torch.models import knn as mknn

        super().__init__()
        self.est = est
        self.model = model
        self.enc = encoder
        self.delim = delim
        self.device = est.device
        if mknn.kernel_route(model, est.k, est.metric):
            model.device_packed(self.device)
        model.device_rerank_arrays(self.device)

    @classmethod
    def from_conf(cls, conf: JobConfig, device=None) -> "KNNServable":
        from avenir_tpu_torch.jobs.bayesian import _cost_matrix
        from avenir_tpu_torch.models import knn as mknn
        from avenir_tpu_torch.models import naive_bayes as nb

        train_path = conf.get("training.data.path")
        if not train_path:
            raise ConfigError("serving knn requires training.data.path")
        mode = conf.get("knn.search.mode", "exact")
        if mode not in ("exact", "approx"):
            raise ConfigError(f"unknown knn.search.mode {mode!r}; use "
                              f"exact|approx")
        dev = resolve_device(device)
        enc, train_ds, _rows = Job.encode_input(conf, train_path,
                                                need_rows=False)
        class_cond = (conf.get_bool("class.condition.weighted", False)
                      or conf.get_bool("class.condtion.weighted", False))
        class_probs = None
        if class_cond:
            model_path = conf.get("bayesian.model.file.path")
            if not model_path:
                raise ConfigError("class-conditional weighting requires "
                                  "bayesian.model.file.path")
            bayes = nb.model_from_lines(read_lines(model_path), enc,
                                        delim=conf.field_delim)
            class_probs = nb.NaiveBayes(device=dev).predict(
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
            mesh=auto_mesh(conf, dev),     # the batch job's own placement
            device=dev,
        )
        model = est.fit(train_ds, class_probs=class_probs)
        return cls(est, model, enc, delim=conf.field_delim)

    def score_lines(self, lines: Sequence[str], pad_to: int) -> List[str]:
        rows = _parse_rows(lines, self.delim, self.enc.max_ordinal(False))
        ds = _pad_ds(self.enc.transform(rows, with_labels=False), pad_to)
        self.compile_keys.add((pad_to,))
        result = self.est.predict(self.model, ds)
        return [
            f"{line}{self.delim}"
            f"{self.model.class_values[int(result.predicted[i])]}"
            for i, line in enumerate(lines)]

    def warmup(self, pad_to: int) -> None:
        self.compile_keys.add((pad_to,))
        self.est.predict(self.model, _blank_ds(self.enc, pad_to))


# ---------------------------------------------------------------------------
# Markov / Viterbi
# ---------------------------------------------------------------------------

class ViterbiServable(ServableModel):
    """ViterbiStatePredictor online: request rows are ``id[,...],obs,...``
    sequences (``skip.field.count`` leading id fields), decoded against a
    fixed time axis (``serve.sequence.pad.len``), so every bucket has one
    [bucket, padLen] shape; padded steps are max-plus identities, so paths
    equal the batch job's variable-length decode.  Response line as the
    job's: ``id,state,...`` (or ``obs:state`` pairs under
    ``output.state.only=false``)."""

    family = "viterbi"

    def __init__(self, predictor, delim: str = ",", in_delim: str = ",",
                 skip: int = 1, pad_len: int = 64):
        super().__init__()
        self.predictor = predictor
        self.delim = delim
        self.in_delim = in_delim          # the job's field.delim.regex split
        self.skip = max(int(skip), 1)
        self.pad_len = int(pad_len)
        self.device = predictor.decoder.device
        self._known = set(predictor.decoder.model.observations)

    @classmethod
    def from_conf(cls, conf: JobConfig, device=None) -> "ViterbiServable":
        from avenir_tpu_torch.models import markov as mk

        path = (conf.get("hmm.model.file.path")
                or conf.get("model.file.path"))
        if not path:
            raise ConfigError("serving viterbi requires hmm.model.file.path")
        model = mk.HMMModel.from_lines(read_lines(path),
                                       delim=conf.field_delim)
        predictor = mk.ViterbiStatePredictor(
            model, pair_output=not conf.get_bool("output.state.only", True),
            delim=conf.field_delim, mesh=auto_mesh(conf, device),
            device=device)
        return cls(predictor, delim=conf.field_delim,
                   in_delim=conf.field_delim_regex,
                   skip=conf.get_int("skip.field.count", 1),
                   pad_len=conf.get_int("serve.sequence.pad.len", 64))

    def _rows(self, lines: Sequence[str]) -> List[List[str]]:
        rows = []
        for line in lines:
            parts = line.split(self.in_delim)
            if len(parts) <= self.skip:
                raise RequestError(
                    f"sequence row needs at least {self.skip + 1} fields "
                    f"(ids + one observation): {line!r}")
            seq = [t for t in parts[self.skip:] if t != ""]
            if len(seq) > self.pad_len:
                raise RequestError(
                    f"sequence of {len(seq)} observations exceeds "
                    f"serve.sequence.pad.len={self.pad_len}")
            unknown = [t for t in seq if t not in self._known]
            if unknown:
                raise RequestError(
                    f"unknown observation symbol(s) {unknown[:3]} — model "
                    f"vocabulary has {len(self._known)} symbols")
            rows.append([self.delim.join(parts[:self.skip])] + seq)
        return rows

    def score_lines(self, lines: Sequence[str], pad_to: int) -> List[str]:
        rows = self._rows(lines)
        rows += [[""] for _ in range(pad_to - len(rows))]   # empty-seq pads
        self.compile_keys.add((pad_to, self.pad_len))
        return self.predictor.predict_lines(rows,
                                            pad_to=self.pad_len)[:len(lines)]

    def warmup(self, pad_to: int) -> None:
        self.compile_keys.add((pad_to, self.pad_len))
        self.predictor.predict_lines([[""] for _ in range(pad_to)],
                                     pad_to=self.pad_len)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

FAMILIES: Dict[str, type] = {
    cls.family: cls
    for cls in (NaiveBayesServable, LogisticServable, TreeServable,
                KNNServable, ViterbiServable)
}


class ModelRegistry:
    """name → :class:`ServableModel`, the scoring plane's namespace.

    Entries are versioned: :meth:`swap` replaces a loaded entry and bumps
    its version.  ``get`` hands out the entry object, so a dispatch that
    already resolved the old entry finishes on the old parameters while
    every later ``get`` sees the new ones.  Under a live batcher use
    ``BucketedMicrobatcher.swap``, which warms the incoming entry's bucket
    shapes before publishing it."""

    def __init__(self) -> None:
        self._entries: Dict[str, ServableModel] = {}
        self._versions: Dict[str, int] = {}
        self._lock = threading.Lock()

    def add(self, name: str, entry: ServableModel) -> "ModelRegistry":
        with self._lock:
            self._entries[name] = entry
            self._versions[name] = self._versions.get(name, 0) + 1
        return self

    def get(self, name: str) -> ServableModel:
        entry = self._entries.get(name)
        if entry is None:
            raise UnknownModelError(
                f"unknown model {name!r}; loaded: {sorted(self._entries)}")
        return entry

    def swap(self, name: str, entry: ServableModel) -> int:
        """Replace a loaded entry; returns the new version.  Swapping an
        unknown name raises (new models are published with ``add``)."""
        with self._lock:
            if name not in self._entries:
                raise UnknownModelError(
                    f"cannot swap unknown model {name!r}; loaded: "
                    f"{sorted(self._entries)}")
            self._entries[name] = entry
            self._versions[name] += 1
            return self._versions[name]

    def version(self, name: str) -> int:
        """The entry's version (1 = initial load, +1 per swap)."""
        self.get(name)                    # raises UnknownModelError
        return self._versions[name]

    def names(self) -> List[str]:
        return sorted(self._entries)

    def items(self):
        return sorted(self._entries.items())

    @classmethod
    def from_conf(cls, conf: JobConfig, device=None) -> "ModelRegistry":
        """Load every family named in ``serve.models`` from its job's
        artifact keys onto ``device`` (one entry per family, named by the
        family id)."""
        families = conf.get_list("serve.models")
        if not families:
            raise ConfigError(
                f"serve.models not set — name the families to load "
                f"(known: {sorted(FAMILIES)})")
        registry = cls()
        for family in families:
            loader = FAMILIES.get(family)
            if loader is None:
                raise ConfigError(
                    f"unknown serving family {family!r} in serve.models "
                    f"(known: {sorted(FAMILIES)})")
            registry.add(family, loader.from_conf(conf, device=device))
        return registry

    def warmup(self, buckets: Sequence[int]) -> Dict[str, int]:
        """Run every (model, bucket) shape once; returns the shapes warmed
        per model.  After this, steady-state serving records zero
        recompiles."""
        warmed = {}
        for name, entry in self.items():
            before = len(entry.compile_keys)
            for bucket in buckets:
                entry.warmup(int(bucket))
            warmed[name] = len(entry.compile_keys) - before
        return warmed
