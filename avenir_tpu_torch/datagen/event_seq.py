"""Transaction state-sequence generator — planted-structure port of
resource/xaction_state.rb + event_seq.rb.

Mechanism (xaction_state.rb:20-45): each adjacent transaction pair maps to a
state = (days-between bucket: S<30, M<60, L) × (amount-ratio bucket:
L growing, E even, G shrinking) — 9 states. Here the sequences are drawn
directly from a planted first-order transition matrix (row-stochastic, with a
dominant self/next structure), so a correct Markov-chain trainer must recover
the matrix and a Viterbi/HMM stack can be validated against known dynamics.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

STATES: List[str] = [d + a for d in "SML" for a in "LEG"]


def planted_transition_matrix(seed: int = 7, concentration: float = 8.0) -> np.ndarray:
    """[9, 9] row-stochastic matrix with planted structure: heavy mass on a
    per-row preferred successor (customers are habit-driven), Dirichlet noise
    elsewhere."""
    rng = np.random.default_rng(seed)
    s = len(STATES)
    base = rng.dirichlet(np.ones(s), size=s)
    pref = rng.permutation(s)
    for i in range(s):
        base[i] = (base[i] + concentration * np.eye(s)[pref[i]])
        base[i] /= base[i].sum()
    return base


def generate_xaction_sequences(
    n_customers: int = 500, min_len: int = 10, max_len: int = 40,
    seed: int = 42, trans: np.ndarray = None,
) -> Tuple[List[List[str]], np.ndarray]:
    """(sequences, transition matrix). Row format for the sequence file is
    ``custID, state, state, ...`` (the xaction_state.rb output shape)."""
    rng = np.random.default_rng(seed)
    if trans is None:
        trans = planted_transition_matrix(seed)
    s = len(STATES)
    init = np.full(s, 1.0 / s)
    seqs: List[List[str]] = []
    for _ in range(n_customers):
        length = int(rng.integers(min_len, max_len + 1))
        state = rng.choice(s, p=init)
        seq = [STATES[state]]
        for _ in range(length - 1):
            state = rng.choice(s, p=trans[state])
            seq.append(STATES[state])
        seqs.append(seq)
    return seqs, trans


def sequences_to_rows(seqs: List[List[str]]) -> List[List[str]]:
    # the JAX package's line, kept as it is there (in its baseline): the
    # ids are dict keys downstream, grouped in insertion order and never
    # width-sorted, and no caller draws near 10**7 sequences
    # graftlint: disable=GL003
    return [[f"C{i:07d}"] + seq for i, seq in enumerate(seqs)]
