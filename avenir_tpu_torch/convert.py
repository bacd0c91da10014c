"""State carried across from ``avenir_tpu``.

This system has no weights: its state is count tables and model files.

- :func:`accumulator_from_jax` takes the state of a JAX ``agg.Accumulator``
  (``Accumulator.state()``: name → numpy total), including a
  layout-qualified G key such as ``g:fmaj:f11:b12:c2``, and returns the
  port's :class:`~avenir_tpu_torch.ops.agg.Accumulator`.  Both packages lay
  G out by the same ``plan()``/``w_index()``, so a G total is read by the
  port's ``counts_from_cooc`` unchanged.
- NB model files need no conversion: the file ``avenir_tpu``'s
  ``model_to_lines`` writes loads unchanged through the port's
  ``models.naive_bayes.model_from_lines``.
- :func:`tree_model_from_jax` takes a JAX ``DecisionTreeModel.to_string()``
  (the first line of a DecisionTreeBuilder model file) and returns the
  port's :class:`~avenir_tpu_torch.models.tree.DecisionTreeModel`, checked
  for consistency, so a tree grown by either package scores the same rows
  in the other.  The port's ``to_string()`` is the same JSON, so the way
  back is ``from_string`` on the JAX side.
- :func:`knn_model_from_jax` takes a JAX ``KNNModel`` (its numpy arrays:
  the reference set and its normalization range) and returns the port's
  :class:`~avenir_tpu_torch.models.knn.KNNModel`, so that both packages
  score the same reference set.
- :func:`markov_model_from_jax`, :func:`hmm_model_from_jax` and
  :func:`lr_model_from_jax` take a JAX ``MarkovChainModel``, ``HMMModel``
  or ``LogisticRegressionModel`` (its numpy fields), or the lines its
  ``to_lines()`` / ``history_lines()`` writes, and return the port's model,
  checked for shape, so both packages decode or score with the same one.
- :func:`learner_state_from_jax` takes the JSON that the JAX package's
  ``ReinforcementLearnerServer.checkpoint()`` writes (or the dict
  ``get_state()`` returns) and returns the state the port's learner
  restores (``set_state``, or ``ReinforcementLearnerServer.restore`` of
  its JSON), so a server checkpointed in ``avenir_tpu`` resumes in the
  port and emits the same next actions.  The bandit jobs carry their
  state in their ``group,item,count,reward`` rows and need no conversion.
"""

from __future__ import annotations

import json
import re
from typing import Dict, Sequence, Union

import numpy as np

from avenir_tpu_torch.models import knn as mknn
from avenir_tpu_torch.models import logistic as mlr
from avenir_tpu_torch.models import markov as mk
from avenir_tpu_torch.models import tree as dtree
from avenir_tpu_torch.ops import agg, hist

_G_KEY = re.compile(r"g:(fmaj|jmaj|cls|clsb):f(\d+):b(\d+):c(\d+)")


def accumulator_from_jax(state: Dict[str, np.ndarray]) -> agg.Accumulator:
    """The port's Accumulator holding the same totals as a JAX
    ``agg.Accumulator`` state.  Every G key is checked against this
    package's layout for its shape, and its matrix against the padded
    width: a G from another layout (the old bare ``"g"`` key, a packed or
    mesh-qualified key, or a mode this build would not choose) is refused
    rather than read with the wrong indexing."""
    out = {}
    for name, value in state.items():
        arr = np.asarray(value)
        if name == "g" or name.startswith("g:"):
            m = _G_KEY.fullmatch(name)
            if m is None:
                raise ValueError(f"count matrix {name!r} has no layout this "
                                 f"package reads (expected g:<mode>:f<F>:b<B>:c<C>)")
            f, b, c = (int(x) for x in m.groups()[1:])
            if hist.g_key(f, b, c) != name:
                raise ValueError(f"count matrix {name!r} is not laid out as "
                                 f"this package lays out F={f} B={b} C={c} "
                                 f"({hist.g_key(f, b, c)!r})")
            mode, _, wp = hist.plan(f, b, c)
            shape = (c, wp, wp) if mode in ("cls", "clsb") else (wp, wp)
            if arr.shape != shape:
                raise ValueError(f"count matrix {name!r} has shape "
                                 f"{arr.shape}, expected {shape}")
        out[name] = arr
    acc = agg.Accumulator()
    for name, arr in out.items():
        acc.add(name, arr)
    return acc


def tree_model_from_jax(model_string: str) -> dtree.DecisionTreeModel:
    """The port's DecisionTreeModel from a JAX ``to_string()``.  Refuses a
    tree the walker would misread: node ids out of order, a child that is
    not a node, a split whose children or bin table disagree with its
    segment count or the model's bin width, or an unknown algorithm."""
    model = dtree.DecisionTreeModel.from_string(model_string)
    m = len(model.nodes)
    if model.algorithm not in dtree.ALGORITHMS:
        raise ValueError(f"unknown tree algorithm {model.algorithm!r}")
    for i, node in enumerate(model.nodes):
        if node.node_id != i:
            raise ValueError(f"node {i} carries id {node.node_id}")
        if len(node.class_counts) != len(model.class_values):
            raise ValueError(f"node {i} has {len(node.class_counts)} class "
                             f"counts for {len(model.class_values)} classes")
        if node.split is None:
            if node.children:
                raise ValueError(f"leaf {i} has children")
            continue
        sp = node.split
        if len(sp.seg_of_bin) != model.max_bins:
            raise ValueError(f"node {i}: bin table of {len(sp.seg_of_bin)} "
                             f"bins, model has {model.max_bins}")
        if (len(node.children) != sp.num_segments
                or not all(i < ch < m for ch in node.children)
                or sp.seg_of_bin.min() < 0
                or sp.seg_of_bin.max() >= sp.num_segments):
            raise ValueError(f"node {i}: split {sp.key!r} does not match "
                             f"its children {node.children}")
    return model


def knn_model_from_jax(model) -> mknn.KNNModel:
    """The port's KNNModel from a JAX ``KNNModel``, read by attribute (its
    arrays are numpy already).  Refuses arrays whose row counts or widths
    disagree, so a reference set is never scored with another's labels or
    normalization range."""
    def opt(name, dtype):
        v = getattr(model, name)
        return None if v is None else np.asarray(v, dtype)

    codes = np.asarray(model.codes, np.int32)
    cont = np.asarray(model.cont, np.float32)
    out = mknn.KNNModel(
        codes=codes, cont=cont, labels=opt("labels", np.int32),
        values=opt("values", np.float32),
        class_probs=opt("class_probs", np.float32),
        n_bins=np.asarray(model.n_bins, np.int32),
        class_values=[str(v) for v in model.class_values],
        cont_lo=np.asarray(model.cont_lo, np.float32),
        cont_hi=np.asarray(model.cont_hi, np.float32))
    n = out.num_refs
    if codes.ndim != 2 or cont.ndim != 2 or (codes.size and cont.size
                                            and codes.shape[0] != cont.shape[0]):
        raise ValueError(f"codes {codes.shape} and cont {cont.shape} are not "
                         f"row-aligned [N, F] / [N, Fc]")
    if out.n_bins.shape != (codes.shape[1],):
        raise ValueError(f"n_bins {out.n_bins.shape} for {codes.shape[1]} "
                         f"binned features")
    if out.cont_lo.shape != (cont.shape[1],) or out.cont_hi.shape != (cont.shape[1],):
        raise ValueError(f"normalization range {out.cont_lo.shape} for "
                         f"{cont.shape[1]} continuous features")
    for name in ("labels", "values", "class_probs"):
        v = getattr(out, name)
        if v is not None and v.shape[0] != n:
            raise ValueError(f"{name} has {v.shape[0]} rows for {n} references")
    if out.class_probs is not None and out.class_probs.shape[1] != len(out.class_values):
        raise ValueError(f"class_probs has {out.class_probs.shape[1]} columns "
                         f"for {len(out.class_values)} classes")
    return out


def _is_lines(src) -> bool:
    return (isinstance(src, (list, tuple))
            and all(isinstance(x, str) for x in src))


def markov_model_from_jax(src: Union[Sequence[str], object]
                          ) -> mk.MarkovChainModel:
    """The port's MarkovChainModel from a JAX ``MarkovChainModel`` or its
    ``to_lines()`` (read as probabilities, as ``from_lines`` reads them)."""
    if _is_lines(src):
        return mk.MarkovChainModel.from_lines(list(src))
    states = [str(v) for v in src.states]
    counts = np.asarray(src.counts, np.float64)
    if counts.shape != (len(states), len(states)):
        raise ValueError(f"transition counts {counts.shape} for "
                         f"{len(states)} states")
    return mk.MarkovChainModel(states=states, counts=counts,
                               laplace=float(src.laplace), scale=src.scale)


def hmm_model_from_jax(src: Union[Sequence[str], object]) -> mk.HMMModel:
    """The port's HMMModel from a JAX ``HMMModel`` or its ``to_lines()``;
    refuses tables whose shapes disagree with the state and observation
    lists."""
    if _is_lines(src):
        model = mk.HMMModel.from_lines(list(src))
    else:
        model = mk.HMMModel(
            states=[str(v) for v in src.states],
            observations=[str(v) for v in src.observations],
            transition=np.asarray(src.transition, np.float64),
            emission=np.asarray(src.emission, np.float64),
            initial=np.asarray(src.initial, np.float64))
    s, o = len(model.states), len(model.observations)
    for name, shape in (("transition", (s, s)), ("emission", (s, o)),
                        ("initial", (s,))):
        if getattr(model, name).shape != shape:
            raise ValueError(f"{name} {getattr(model, name).shape} for "
                             f"{s} states and {o} observations")
    return model


def lr_model_from_jax(src: Union[Sequence[str], object]
                      ) -> mlr.LogisticRegressionModel:
    """The port's LogisticRegressionModel from a JAX
    ``LogisticRegressionModel`` or its ``history_lines()``; refuses a
    history whose rows differ in width from the weights."""
    if _is_lines(src):
        return mlr.LogisticRegressionModel.from_history_lines(list(src))
    weights = np.asarray(src.weights)
    history = [np.asarray(h) for h in src.history]
    if any(h.shape != weights.shape for h in history):
        raise ValueError(f"history rows of widths "
                         f"{sorted({h.shape for h in history})} for "
                         f"weights {weights.shape}")
    return mlr.LogisticRegressionModel(
        weights=weights, history=history, converged=bool(src.converged),
        iterations=int(src.iterations), n_rows=int(src.n_rows))


def learner_state_from_jax(blob_or_dict: Union[str, bytes, Dict]) -> Dict:
    """The port's online-learner state from a JAX server checkpoint.
    Refuses a state without per-action reward lists, or with an interval
    estimator's annealing fields of the wrong type."""
    state = (json.loads(blob_or_dict) if isinstance(blob_or_dict, (str, bytes))
             else blob_or_dict)
    rewards = state.get("rewards") if isinstance(state, dict) else None
    if not isinstance(rewards, dict):
        raise ValueError("learner state has no per-action 'rewards' mapping")
    out: Dict = {"rewards": {str(a): [float(r) for r in rs]
                             for a, rs in rewards.items()}}
    extra = set(state) - {"rewards"}
    if extra:
        if extra != {"cur_confidence", "last_round"}:
            raise ValueError(f"learner state has unknown fields {sorted(extra)}")
        out["cur_confidence"] = float(state["cur_confidence"])
        if int(state["last_round"]) != state["last_round"]:
            raise ValueError("learner state's last_round is not an integer")
        out["last_round"] = int(state["last_round"])
    return out
