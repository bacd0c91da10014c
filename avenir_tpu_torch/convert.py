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
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np

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
