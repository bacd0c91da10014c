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
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np

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
