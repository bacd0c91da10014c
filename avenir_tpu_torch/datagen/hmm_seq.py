"""Planted Markov-chain and HMM sequences drawn in bulk with numpy — the
sequence workloads of the Markov family at sizes where a per-token draw
(``event_seq.generate_xaction_sequences``) would take minutes.

Every record draws its length, then all records advance one step at a time
by inverse-CDF sampling of their current state's row, so the draw costs
O(T) vectorized steps over R records.  Codes come back as [R, T] int32
arrays padded with −1, the layout ``models/markov.py`` decodes.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def planted_hmm(num_states: int = 6, num_obs: int = 12, seed: int = 0,
                stay: float = 6.0, peak: float = 8.0
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(A [S, S], B [S, O], π [S]): sticky transitions (``stay`` extra mass
    on the diagonal) and each state peaked on two observations of its own,
    over Dirichlet noise."""
    rng = np.random.default_rng(seed)
    s, o = num_states, num_obs
    a = rng.dirichlet(np.ones(s), size=s) + stay * np.eye(s)
    b = rng.dirichlet(np.ones(o), size=s)
    for i in range(s):
        b[i, (2 * i) % o] += peak
        b[i, (2 * i + 1) % o] += peak / 2
    pi = rng.dirichlet(np.ones(s))
    return (a / a.sum(1, keepdims=True), b / b.sum(1, keepdims=True), pi)


def _draw(rng: np.random.Generator, probs: np.ndarray, rows: np.ndarray
          ) -> np.ndarray:
    """One categorical draw per entry of ``rows`` from ``probs[rows]``."""
    cdf = np.cumsum(probs, axis=1)
    u = rng.random(len(rows))[:, None]
    return np.minimum((u > cdf[rows]).sum(1), probs.shape[1] - 1)


def sample_chain(trans: np.ndarray, init: np.ndarray, n: int, min_len: int,
                 max_len: int, seed: int = 0) -> np.ndarray:
    """[n, max_len] int32 state codes of a first-order chain, −1 past each
    record's length (uniform in [min_len, max_len])."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(min_len, max_len + 1, size=n)
    out = np.full((n, max_len), -1, np.int32)
    cur = _draw(rng, init[None, :], np.zeros(n, np.int64))
    out[:, 0] = cur
    for t in range(1, max_len):
        cur = _draw(rng, trans, cur)
        out[:, t] = cur
    out[np.arange(max_len)[None, :] >= lens[:, None]] = -1
    return out


def sample_hmm(a: np.ndarray, b: np.ndarray, pi: np.ndarray, n: int,
               min_len: int, max_len: int, seed: int = 0
               ) -> Tuple[np.ndarray, np.ndarray]:
    """([n, max_len] state codes, [n, max_len] observation codes) of the
    HMM (A, B, π), both −1 past each record's length."""
    states = sample_chain(a, pi, n, min_len, max_len, seed)
    rng = np.random.default_rng(seed + 1)
    valid = states >= 0
    obs = np.full(states.shape, -1, np.int32)
    obs[valid] = _draw(rng, b, states[valid])
    return states, obs


def _check_id_width(n: int, bound: int) -> None:
    """Refuse more rows than the zero-padded row ids have room for."""
    if n > bound:
        raise ValueError(f"{n} rows exceed the {len(str(bound)) - 1}-digit "
                         f"row-id width")


def code_rows(codes: np.ndarray, symbols: List[str], prefix: str = "C"
              ) -> List[List[str]]:
    """Sequence-file rows ``[id, symbol, ...]`` of [R, T] codes."""
    _check_id_width(len(codes), 10 ** 7)
    return [[f"{prefix}{r:07d}"] + [symbols[c] for c in row if c >= 0]
            for r, row in enumerate(codes)]


def tagged_rows(states: np.ndarray, obs: np.ndarray, state_names: List[str],
                obs_names: List[str], sub: str = ":") -> List[List[str]]:
    """Fully tagged rows ``[id, obs:state, ...]``."""
    _check_id_width(len(states), 10 ** 7)
    return [[f"C{r:07d}"] + [f"{obs_names[o]}{sub}{state_names[s]}"
                             for s, o in zip(srow, orow) if s >= 0]
            for r, (srow, orow) in enumerate(zip(states, obs))]


def partial_rows(states: np.ndarray, obs: np.ndarray, state_names: List[str],
                 obs_names: List[str]) -> List[List[str]]:
    """Partially tagged rows ``[id, token, ...]``: the observations, with
    the state's name inline before the first observation of each run of one
    state (the partially tagged HMM builder's input)."""
    _check_id_width(len(states), 10 ** 7)
    rows = []
    for r, (srow, orow) in enumerate(zip(states, obs)):
        toks, prev = [f"C{r:07d}"], -1
        for s, o in zip(srow, orow):
            if s < 0:
                break
            if s != prev:
                toks.append(state_names[s])
                prev = s
            toks.append(obs_names[o])
        rows.append(toks)
    return rows
