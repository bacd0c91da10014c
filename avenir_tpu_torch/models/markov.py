"""Markov-chain and hidden-Markov sequence models and Viterbi decoding —
port of ``avenir_tpu/models/markov.py`` (the reference's
``org.avenir.markov`` package).

- :class:`MarkovChain` counts adjacent state pairs
  (MarkovStateTransitionModel.java:98-125) and writes the row-normalised,
  Laplace-smoothed transition matrix row by row, in float or int-scaled
  (×``scale``) mode (util/StateTransitionProbability.java:65-126).
- :class:`HMMBuilder` estimates an HMM from fully tagged ``obs:state``
  tokens (HiddenMarkovModelBuilder.java:136-166) or from partially tagged
  sequences, where inline state tokens claim the observations out to the
  midpoint toward their neighbours with the ``window.function`` weights
  (:174-260, the midpoint as the JAX package computes it).
- :class:`HMMModel` keeps the reference file layout: states, observations,
  A rows, B rows, π (HiddenMarkovModel.java:46-70).
- :class:`ViterbiDecoder` decodes in log space (ViterbiDecoder.java:66-143);
  :class:`ViterbiStatePredictor` is the map-only prediction job's model
  (ViterbiStatePredictor.java:114-142).

Sequences pad to [R, T] int32 codes with −1.  Counts are integer
``bincount``s on the device (``ops/agg.py``); the Viterbi recursion is a
loop over time on [R, S] tensors, with padded steps carrying δ unchanged.

A data ``mesh`` of two or more devices splits the pair streams (−1 pads
count nothing, weights pad with 0.0) and the decoder's records (all −1
pad rows, trimmed) over its devices; each shard counts or decodes on its
device and the counts are summed in shard order
(``parallel/collectives.py::shard_sum``).  :func:`viterbi_time_sharded`
splits the time axis of one long sequence instead.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from avenir_tpu_torch.core.encoding import NoDataError
from avenir_tpu_torch.device import resolve_device
from avenir_tpu_torch.ops import agg
from avenir_tpu_torch.parallel.collectives import per_shard, shard_sum
from avenir_tpu_torch.parallel.mesh import (is_wide, maybe_shard_batch,
                                            place_batch)

DELIM = ","


# ---------------------------------------------------------------------------
# sequence encoding
# ---------------------------------------------------------------------------

class SequenceEncoder:
    """Symbol-name ↔ code mapping with padding to rectangular batches."""

    def __init__(self, symbols: Optional[Sequence[str]] = None):
        self.symbols: List[str] = list(symbols) if symbols else []
        self._map: Dict[str, int] = {s: i for i, s in enumerate(self.symbols)}

    def fit(self, seqs: Iterable[Sequence[str]]) -> "SequenceEncoder":
        for seq in seqs:
            for s in seq:
                if s not in self._map:
                    self._map[s] = len(self.symbols)
                    self.symbols.append(s)
        return self

    def encode(self, seqs: Sequence[Sequence[str]],
               pad_to: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """([R, T] codes with −1 pad, [R] lengths); an unknown symbol raises
        KeyError."""
        lens = np.fromiter((len(s) for s in seqs), np.int32, len(seqs))
        t = pad_to if pad_to is not None else int(lens.max(initial=0))
        out = np.full((len(seqs), t), -1, np.int32)
        m = self._map
        flat = np.fromiter((m[s] for seq in seqs for s in seq), np.int32,
                           int(lens.sum()))
        rows = np.repeat(np.arange(len(seqs)), lens)
        cols = np.arange(flat.size) - np.repeat(np.cumsum(lens) - lens, lens)
        out[rows, cols] = flat
        return out, lens

    def decode(self, codes: Sequence[int]) -> List[str]:
        return [self.symbols[c] for c in codes if c >= 0]

    def __len__(self) -> int:
        return len(self.symbols)


def adjacent_pairs(seqs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """[R, T] padded sequences → the (src, dst) adjacent-pair streams; a pair
    touching a pad becomes (−1, −1) and counts nothing."""
    a, b = seqs[:, :-1], seqs[:, 1:]
    valid = (a >= 0) & (b >= 0)
    return np.where(valid, a, -1).ravel(), np.where(valid, b, -1).ravel()


def _pair_counts(a: np.ndarray, b: np.ndarray, num_a: int, num_b: int,
                 device: torch.device, mesh=None) -> torch.Tensor:
    """[num_a, num_b] int32 counts of the pairs (a, b), on ``device`` or
    summed over ``mesh``'s shards."""
    return shard_sum(
        lambda x, y: agg.transition_counts(x, y, num_a, num_b),
        *place_batch(mesh, device, a, b))


# ---------------------------------------------------------------------------
# Markov chain
# ---------------------------------------------------------------------------

@dataclass
class MarkovChainModel:
    states: List[str]
    counts: np.ndarray                   # [S, S] transition counts
    laplace: float = 1.0
    scale: Optional[int] = None          # int-scale mode (×1000); None = float

    def transition_probs(self) -> np.ndarray:
        c = self.counts + self.laplace
        p = c / c.sum(axis=1, keepdims=True)
        if self.scale:
            return np.rint(p * self.scale) / self.scale
        return p

    def to_lines(self, delim: str = DELIM) -> List[str]:
        """Row by row, as StateTransitionProbability writes them."""
        probs = self.transition_probs()
        lines = [delim.join(self.states)]
        for row in probs:
            if self.scale:
                lines.append(delim.join(str(int(v * self.scale)) for v in row))
            else:
                lines.append(delim.join(repr(float(v)) for v in row))
        return lines

    @classmethod
    def from_lines(cls, lines: Sequence[str], delim: str = DELIM,
                   scale: Optional[int] = None) -> "MarkovChainModel":
        states = lines[0].split(delim)
        s = len(states)
        probs = np.array([[float(v) for v in lines[1 + i].split(delim)]
                          for i in range(s)])
        if scale:
            probs = probs / scale
        # probabilities stored as pseudo-counts, laplace 0, so they
        # round-trip
        return cls(states=states, counts=probs, laplace=0.0, scale=None)


class MarkovChain:
    """First-order chain trainer over state-name sequences; transition
    counts are int32 per batch on ``device`` (or per shard of ``mesh``)
    and int64 in the Accumulator."""

    def __init__(self, laplace: float = 1.0, scale: Optional[int] = None,
                 mesh=None, device=None):
        self.laplace = laplace
        self.scale = scale
        self.mesh = mesh          # optional data mesh (parallel/mesh.py)
        self.device = resolve_device(device)

    def fit(self, seqs: Sequence[Sequence[str]],
            encoder: Optional[SequenceEncoder] = None
            ) -> Tuple[MarkovChainModel, SequenceEncoder]:
        enc = encoder if encoder is not None else SequenceEncoder().fit(seqs)
        acc = agg.Accumulator()
        self.accumulate(seqs, enc, acc)
        return self.finalize(enc, acc), enc

    def accumulate(self, seqs: Sequence[Sequence[str]],
                   encoder: SequenceEncoder, acc) -> None:
        """Fold one batch of sequences into ``acc["trans"]``."""
        codes, _ = encoder.encode(seqs)
        s = len(encoder)
        acc.add("trans", _pair_counts(*adjacent_pairs(codes), s, s,
                                      self.device, self.mesh))

    def finalize(self, encoder: SequenceEncoder, acc) -> MarkovChainModel:
        counts = np.asarray(acc.get("trans"), np.float64)
        return MarkovChainModel(states=list(encoder.symbols), counts=counts,
                                laplace=self.laplace, scale=self.scale)

    def fit_chunks(self, chunks: Iterable[Sequence[Sequence[str]]],
                   encoder: SequenceEncoder, accumulator=None
                   ) -> Tuple[MarkovChainModel, SequenceEncoder]:
        """Streaming fit over sequence batches.  ``encoder`` must be built
        beforehand (``model.states``): a vocabulary discovered chunk by
        chunk would give chunk-order-dependent codes.  Raises NoDataError
        on an empty stream."""
        acc = accumulator if accumulator is not None else agg.Accumulator()
        for seqs in chunks:
            self.accumulate(seqs, encoder, acc)
        if "trans" not in acc:
            raise NoDataError("no data")
        return self.finalize(encoder, acc), encoder


# ---------------------------------------------------------------------------
# HMM
# ---------------------------------------------------------------------------

@dataclass
class HMMModel:
    states: List[str]
    observations: List[str]
    transition: np.ndarray       # [S, S] row-normalised A
    emission: np.ndarray         # [S, O] row-normalised B
    initial: np.ndarray          # [S] π

    def to_lines(self, delim: str = DELIM) -> List[str]:
        """states / observations / A rows / B rows / π."""
        lines = [delim.join(self.states), delim.join(self.observations)]
        for row in self.transition:
            lines.append(delim.join(repr(float(v)) for v in row))
        for row in self.emission:
            lines.append(delim.join(repr(float(v)) for v in row))
        lines.append(delim.join(repr(float(v)) for v in self.initial))
        return lines

    @classmethod
    def from_lines(cls, lines: Sequence[str], delim: str = DELIM) -> "HMMModel":
        states = lines[0].split(delim)
        observations = lines[1].split(delim)
        s = len(states)
        cur = 2
        a = np.array([[float(v) for v in lines[cur + i].split(delim)]
                      for i in range(s)])
        cur += s
        b = np.array([[float(v) for v in lines[cur + i].split(delim)]
                      for i in range(s)])
        cur += s
        pi = np.array([float(v) for v in lines[cur].split(delim)])
        return cls(states, observations, a, b, pi)


class HMMBuilder:
    """Supervised HMM estimation from tagged sequences."""

    def __init__(self, laplace: float = 1.0, mesh=None, device=None):
        self.laplace = laplace
        self.mesh = mesh          # optional data mesh (parallel/mesh.py)
        self.device = resolve_device(device)

    def fit_tagged(self, seqs: Sequence[Sequence[Tuple[str, str]]],
                   state_encoder: Optional[SequenceEncoder] = None,
                   obs_encoder: Optional[SequenceEncoder] = None) -> HMMModel:
        """Fully tagged mode: every token is (obs, state)."""
        st_enc = state_encoder or SequenceEncoder().fit(
            [[s for _, s in seq] for seq in seqs])
        ob_enc = obs_encoder or SequenceEncoder().fit(
            [[o for o, _ in seq] for seq in seqs])
        acc = agg.Accumulator()
        self.accumulate_tagged(seqs, st_enc, ob_enc, acc)
        return self.finalize(st_enc, ob_enc, acc)

    def accumulate_tagged(self, seqs, st_enc: SequenceEncoder,
                          ob_enc: SequenceEncoder, acc) -> None:
        """Fold one batch of tagged sequences into ``acc`` (``init``,
        ``trans``, ``emit``: exact counts)."""
        st_codes, _ = st_enc.encode([[s for _, s in seq] for seq in seqs])
        ob_codes, _ = ob_enc.encode([[o for o, _ in seq] for seq in seqs])
        s, o = len(st_enc), len(ob_enc)
        if not st_codes.size:
            return
        first = st_codes[:, 0]
        acc.add("init", np.bincount(first[first >= 0], minlength=s))
        acc.add("trans", _pair_counts(*adjacent_pairs(st_codes), s, s,
                                      self.device, self.mesh))
        valid = (st_codes >= 0) & (ob_codes >= 0)
        acc.add("emit", _pair_counts(np.where(valid, st_codes, -1).ravel(),
                                     np.where(valid, ob_codes, -1).ravel(),
                                     s, o, self.device, self.mesh))

    def finalize(self, st_enc: SequenceEncoder, ob_enc: SequenceEncoder,
                 acc) -> HMMModel:
        s, o = len(st_enc), len(ob_enc)
        get = lambda k, shape: (np.asarray(acc.get(k), np.float64)  # noqa: E731
                                if k in acc else np.zeros(shape))
        return self._normalize(st_enc, ob_enc, get("trans", (s, s)),
                               get("emit", (s, o)), get("init", (s,)))

    def fit_tagged_chunks(self, chunks, state_encoder: SequenceEncoder,
                          obs_encoder: SequenceEncoder,
                          accumulator=None) -> HMMModel:
        """Streaming fully tagged fit; both encoders built beforehand
        (``model.states`` / ``model.observations``)."""
        acc = accumulator if accumulator is not None else agg.Accumulator()
        for seqs in chunks:
            self.accumulate_tagged(seqs, state_encoder, obs_encoder, acc)
        if "trans" not in acc:
            raise NoDataError("no data")
        return self.finalize(state_encoder, obs_encoder, acc)

    def fit_partially_tagged(
        self, token_seqs: Sequence[Sequence[str]], states: Sequence[str],
        window_function: Sequence[float] = (1.0, 0.75, 0.5, 0.25),
        obs_encoder: Optional[SequenceEncoder] = None,
    ) -> HMMModel:
        """Partially tagged mode: state names appear inline among the
        observation tokens; each claims the observations out to the
        midpoint toward its neighbouring states, weighted by distance
        through ``window_function``."""
        state_set = set(states)
        st_enc = SequenceEncoder(list(states))
        ob_enc = obs_encoder or SequenceEncoder().fit(
            [[t for t in seq if t not in state_set] for seq in token_seqs])
        acc = agg.Accumulator()
        self.accumulate_partial(token_seqs, st_enc, ob_enc, window_function,
                                acc)
        return self.finalize(st_enc, ob_enc, acc)

    def fit_partially_tagged_chunks(
        self, chunks, states: Sequence[str], obs_encoder: SequenceEncoder,
        window_function: Sequence[float] = (1.0, 0.75, 0.5, 0.25),
        accumulator=None,
    ) -> HMMModel:
        """Streaming partially tagged fit; ``obs_encoder`` built beforehand.
        ``emit`` sums window weights in float64 across chunks."""
        st_enc = SequenceEncoder(list(states))
        acc = accumulator if accumulator is not None else agg.Accumulator()
        for seqs in chunks:
            self.accumulate_partial(seqs, st_enc, obs_encoder,
                                    window_function, acc)
        if "init" not in acc:
            raise NoDataError("no data")
        return self.finalize(st_enc, obs_encoder, acc)

    def accumulate_partial(self, token_seqs, st_enc: SequenceEncoder,
                           ob_enc: SequenceEncoder,
                           window_function: Sequence[float], acc) -> None:
        """Fold one batch of partially tagged sequences into ``acc``: the
        state runs on the host, the weighted (state, obs) sums on the
        device (or each shard of the mesh, summed in float64 in shard
        order), in chunks under the exact-count cap.  The chunk is a
        multiple of the data axis' size, so the mesh's padding never
        pushes one to the cap."""
        state_set = set(st_enc.symbols)
        s, o = len(st_enc), len(ob_enc)
        init = np.zeros(s, np.int64)
        trans = np.zeros((s, s), np.int64)
        st_list: List[int] = []
        ob_list: List[int] = []
        w_list: List[float] = []
        wf = list(window_function)
        for seq in token_seqs:
            pos = [i for i, t in enumerate(seq) if t in state_set]
            if not pos:
                continue
            init[st_enc._map[seq[pos[0]]]] += 1
            for i in range(len(pos) - 1):
                trans[st_enc._map[seq[pos[i]]],
                      st_enc._map[seq[pos[i + 1]]]] += 1
            for i, p in enumerate(pos):
                left = (p + pos[i - 1]) // 2 + 1 if i > 0 else None
                right = (p + pos[i + 1]) // 2 if i < len(pos) - 1 else None
                if left is None:
                    span = ((right - p) if right is not None
                            else (len(seq) - 1 - p) // 2)
                    left = max(p - span, 0)
                if right is None:
                    span = p - left
                    right = min(p + span, len(seq) - 1)
                sc = st_enc._map[seq[p]]
                for j in range(p - 1, left - 1, -1):
                    if seq[j] in state_set:
                        continue
                    k = p - 1 - j
                    st_list.append(sc)
                    ob_list.append(ob_enc._map[seq[j]])
                    w_list.append(wf[k] if k < len(wf) else wf[-1])
                for j in range(p + 1, right + 1):
                    if seq[j] in state_set:
                        continue
                    k = j - p - 1
                    st_list.append(sc)
                    ob_list.append(ob_enc._map[seq[j]])
                    w_list.append(wf[k] if k < len(wf) else wf[-1])
        emit = np.zeros((s, o))
        if st_list:
            st_all = np.array(st_list, np.int32)
            ob_all = np.array(ob_list, np.int32)
            w_all = np.array(w_list, np.float32)
            d = self.mesh.size("data") if self.mesh is not None else 1
            step = max(((agg.MAX_EXACT_CHUNK_ROWS - 1) // d) * d, d)
            for s0 in range(0, len(st_list), step):
                # one fetch per 2^24-row block by design: each block's counts are
                # exact on the device and summed in float64 on the host
                # graftlint: disable=GL005
                emit += shard_sum(
                    lambda a, b, w: agg.weighted_transition_counts(
                        a, b, w, s, o).double(),
                    *place_batch(self.mesh, self.device, st_all[s0:s0 + step],
                                 ob_all[s0:s0 + step], w_all[s0:s0 + step])
                ).cpu().numpy()
        acc.add("init", init)
        acc.add("trans", trans)
        acc.add("emit", emit)

    def _normalize(self, st_enc, ob_enc, trans, emit, init) -> HMMModel:
        lam = self.laplace
        a = (trans + lam) / (trans + lam).sum(axis=1, keepdims=True)
        b = (emit + lam) / (emit + lam).sum(axis=1, keepdims=True)
        pi = (init + lam) / (init + lam).sum()
        return HMMModel(list(st_enc.symbols), list(ob_enc.symbols), a, b, pi)


# ---------------------------------------------------------------------------
# Viterbi
# ---------------------------------------------------------------------------

def _init_delta(log_b: torch.Tensor, log_pi: torch.Tensor,
                obs: torch.Tensor) -> torch.Tensor:
    """δ₀ [R, S]: log π + log B[:, o₀], or zeros for an empty record."""
    o0 = obs[:, 0]
    d0 = log_pi[None, :] + log_b.t()[o0.clamp(min=0).long()]
    return torch.where((o0 >= 0)[:, None], d0, torch.zeros_like(d0))


def _backtrack(ptrs: torch.Tensor, last: torch.Tensor,
               obs: torch.Tensor) -> torch.Tensor:
    """Follow ``ptrs`` [T-1, R, S] back from ``last`` [R] → [R, T] path,
    −1 on the pads."""
    r, t = obs.shape
    path = torch.empty((r, t), dtype=torch.int64, device=obs.device)
    path[:, t - 1] = last
    for i in range(t - 2, -1, -1):
        path[:, i] = ptrs[i].gather(1, path[:, i + 1:i + 2]).squeeze(1)
    return torch.where(obs >= 0, path, torch.full_like(path, -1))


def _viterbi_batch(log_a: torch.Tensor, log_b: torch.Tensor,
                   log_pi: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
    """obs [R, T] (−1 pad) → [R, T] int64 best state path (−1 on pads).

    Forward max-product over time with backpointers, all records at once;
    a padded step carries δ and points each state at itself.  Ties go to
    the lowest previous state, as ``jnp.argmax`` breaks them."""
    r, t = obs.shape
    s = log_a.shape[0]
    if t == 0:
        return torch.empty((r, 0), dtype=torch.int64, device=obs.device)
    delta = _init_delta(log_b, log_pi, obs)
    log_bt = log_b.t()                                   # [O, S]
    ptrs = torch.empty((max(t - 1, 0), r, s), dtype=torch.int64,
                       device=obs.device)
    keep = torch.arange(s, device=obs.device).expand(r, s)
    for i in range(1, t):
        ot = obs[:, i]
        valid = (ot >= 0)[:, None]
        best_val, best_prev = torch.max(delta[:, :, None] + log_a[None], dim=1)
        best_val = best_val + log_bt[ot.clamp(min=0).long()]
        delta = torch.where(valid, best_val, delta)
        ptrs[i - 1] = torch.where(valid, best_prev, keep)
    return _backtrack(ptrs, torch.argmax(delta, dim=1), obs)


_NEG = -1.0e30          # the max-plus "-inf", kept finite


def _step_matrices(log_a: torch.Tensor, log_b: torch.Tensor,
                   obs: torch.Tensor) -> torch.Tensor:
    """obs [R, T] → [R, T-1, S, S] max-plus step matrices
    M_t[i, j] = A[i, j] + B[j, o_t] for t ≥ 1; a padded step is the
    max-plus identity (0 on the diagonal, −BIG elsewhere)."""
    s = log_a.shape[0]
    ot = obs[:, 1:]
    steps = log_a[None, None] + log_b.t()[ot.clamp(min=0).long()][:, :, None, :]
    eye = torch.full((s, s), _NEG, dtype=log_a.dtype, device=log_a.device)
    eye.fill_diagonal_(0.0)
    return torch.where((ot >= 0)[:, :, None, None], steps, eye)


def _maxplus(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a ⊗ b)[i, j] = max_k a[i, k] + b[k, j], batched over leading axes."""
    return (a[..., :, :, None] + b[..., None, :, :]).amax(dim=-2)


def _maxplus_prefix(steps: torch.Tensor) -> torch.Tensor:
    """[R, n, S, S] → the inclusive max-plus prefix products along axis 1
    (M_1, M_1 ⊗ M_2, …) by log₂ n doubling steps, earlier factors on the
    left."""
    prefix = steps
    d = 1
    while d < steps.shape[1]:
        prefix = torch.cat([prefix[:, :d],
                            _maxplus(prefix[:, :-d], prefix[:, d:])], dim=1)
        d *= 2
    return prefix


def _viterbi_assoc_batch(log_a: torch.Tensor, log_b: torch.Tensor,
                         log_pi: torch.Tensor, obs: torch.Tensor
                         ) -> torch.Tensor:
    """Log-depth Viterbi: an inclusive max-plus prefix product of the step
    matrices (log₂ T doubling steps), δ_t = δ₀ ⊗ prefix_t for every t at
    once, backpointers recomputed from the δ's in parallel.  O(T·S³) work
    for O(log T) depth.  The products regroup float32 additions, so paths
    equal the scan's wherever no two candidates tie to rounding."""
    r, t = obs.shape
    if t == 0:
        return torch.empty((r, 0), dtype=torch.int64, device=obs.device)
    delta0 = _init_delta(log_b, log_pi, obs)                    # [R, S]
    steps = _step_matrices(log_a, log_b, obs)                   # [R, T-1, S, S]
    prefix = _maxplus_prefix(steps)
    deltas = (delta0[:, None, :, None] + prefix).amax(dim=2)    # [R, T-1, S]
    all_deltas = torch.cat([delta0[:, None], deltas], dim=1)    # [R, T, S]
    ptrs = torch.argmax(all_deltas[:, :-1, :, None] + steps, dim=2)
    return _backtrack(ptrs.permute(1, 0, 2), torch.argmax(all_deltas[:, -1],
                                                          dim=1), obs)


def viterbi_time_sharded(log_a: torch.Tensor, log_b: torch.Tensor,
                         log_pi: torch.Tensor, obs_row, mesh,
                         axis: str = "data") -> np.ndarray:
    """One long sequence with its time axis split over ``mesh``'s
    ``axis``: obs_row [T] (−1 pad; T divisible by the axis size) → [T]
    int32 state path (−1 on the pads).

    Shard i holds positions [i·L, (i+1)·L): it builds the step matrices
    of its positions with the previous shard's last observation in front
    (shard 0's first step is the identity: position 0 has no incoming
    transition) and takes their local max-plus prefix.  The [D, S, S]
    shard totals are gathered onto the first device and scanned into
    exclusive offsets in shard order; each shard rebases its prefix on
    its offset, takes δ_t = δ₀ ⊗ prefix_t and the backpointers
    ψ_t = argmax_i δ_{t−1}[i] + M_t[i, ·] (δ_{t−1} of its first position
    read from the previous shard), and one backtrack runs on the first
    device.  Every step is a float32 add or max, so a device gives the
    same bits as the CPU; the regrouped sums may flip an argmax at a
    near-tie against the sequential decoder."""
    d = mesh.size(axis)
    obs = torch.as_tensor(np.asarray(obs_row, np.int64)) \
        if not isinstance(obs_row, torch.Tensor) else obs_row.long().cpu()
    t = obs.shape[0]
    if t % d:
        raise ValueError(f"sequence length {t} is not divisible by the "
                         f"{axis!r} axis size {d}")
    n = t // d
    devs = mesh.axis_devices(axis)
    params = [tuple(p.to(dev) for p in (log_a, log_b, log_pi))
              for dev in devs]
    s = log_a.shape[0]
    steps, prefix = [], []
    for i, dev in enumerate(devs):
        la, lb, _lpi = params[i]
        o_ext = obs[max(i * n - 1, 0):(i + 1) * n].to(dev)
        if i == 0:                 # a stand-in in front, replaced below
            o_ext = torch.cat([o_ext[:1], o_ext])
        m = _step_matrices(la, lb, o_ext[None])                 # [1, L, S, S]
        if i == 0:
            eye = torch.full((s, s), _NEG, dtype=la.dtype, device=dev)
            m[0, 0] = eye.fill_diagonal_(0.0)
        steps.append(m)
        prefix.append(_maxplus_prefix(m))
    first = devs[0]
    offsets = []
    carry = torch.full((s, s), _NEG, dtype=log_a.dtype,
                       device=first).fill_diagonal_(0.0)
    for p in prefix:                       # exclusive, in shard order
        offsets.append(carry)
        carry = _maxplus(carry, p[0, -1].to(first))
    _la0, lb0, lpi0 = params[0]
    delta0 = _init_delta(lb0, lpi0, obs[None, :1].to(first))[0]      # [S]
    deltas = []
    for i, dev in enumerate(devs):
        rebased = _maxplus(offsets[i].to(dev)[None], prefix[i][0])  # [L,S,S]
        deltas.append((delta0.to(dev)[None, :, None] + rebased).amax(dim=1))
    psi = []
    for i, dev in enumerate(devs):
        before = delta0 if i == 0 else deltas[i - 1][-1]
        prev = torch.cat([before.to(dev)[None], deltas[i][:-1]])    # [L, S]
        psi.append(torch.argmax(prev[:, :, None] + steps[i][0], dim=1))
    all_deltas = torch.cat([x.to(first) for x in deltas])            # [T, S]
    ptrs = torch.cat([x.to(first) for x in psi])[1:, None]   # [T-1, 1, S]
    obs_f = obs[None].to(first)
    path = _backtrack(ptrs, torch.argmax(all_deltas[-1:], dim=1), obs_f)
    return path[0].to(torch.int32).cpu().numpy()


class ViterbiDecoder:
    """Batch Viterbi decoding over an HMM model on ``device``.

    ``method``: ``"scan"`` (a loop over time, O(T·S²) work, the default)
    or ``"assoc"`` (a log-depth max-plus prefix product, O(T·S³) work, for
    long sequences; memory grows as R·T·S³, so batch records).  A data
    ``mesh`` of two or more devices splits the records over its devices;
    :func:`viterbi_time_sharded` splits one sequence's time axis."""

    def __init__(self, model: HMMModel, method: str = "scan", mesh=None,
                 device=None):
        if method not in ("scan", "assoc"):
            raise ValueError(f"unknown viterbi method {method!r}")
        self.model = model
        self.method = method
        self.mesh = mesh          # optional data mesh: records shard over it
        self.device = resolve_device(device)
        eps = 1e-12
        as_log = lambda m: torch.from_numpy(  # noqa: E731
            np.log(np.maximum(m, eps)).astype(np.float32)).to(self.device)
        self._log_a = as_log(model.transition)
        self._log_b = as_log(model.emission)
        self._log_pi = as_log(model.initial)
        self._obs_map = {o: i for i, o in enumerate(model.observations)}

    def decode_codes(self, obs) -> np.ndarray:
        """[R, T] obs codes (−1 pad; numpy, or a tensor) → [R, T] int32
        state codes (−1 pad).  Under a data mesh the records split over
        its devices, each shard decodes its rows on its device and the
        paths are gathered in shard order; the all −1 pad rows are
        trimmed.  A row's path does not depend on the other rows, so the
        paths are the single-device ones bit for bit."""
        fn = _viterbi_batch if self.method == "scan" else _viterbi_assoc_batch
        o = (obs if isinstance(obs, torch.Tensor)
             else torch.from_numpy(np.asarray(obs, np.int32)))
        if is_wide(self.mesh):
            blocks = maybe_shard_batch(self.mesh, o.numpy(force=True))[0]
            paths = per_shard(lambda la, lb, lpi, ob: fn(la, lb, lpi,
                                                         ob.long()),
                              self._log_a, self._log_b, self._log_pi, blocks)
            return torch.cat([p.cpu() for p in paths.parts])[:o.shape[0]] \
                .to(torch.int32).numpy()
        path = fn(self._log_a, self._log_b, self._log_pi,
                  o.to(self.device).long())
        return path.to(torch.int32).cpu().numpy()

    def decode(self, obs_seqs: Sequence[Sequence[str]],
               pad_to: Optional[int] = None) -> List[List[str]]:
        """``pad_to`` pins the time axis instead of the batch maximum; the
        path of each record is the same for any ``pad_to`` ≥ its length,
        and a longer sequence raises."""
        t = max((len(s) for s in obs_seqs), default=0)
        if pad_to is not None:
            if t > pad_to:
                raise ValueError(
                    f"sequence of length {t} exceeds pad_to={pad_to}")
            t = pad_to
        codes, _ = SequenceEncoder(self.model.observations).encode(
            obs_seqs, pad_to=t)
        paths = self.decode_codes(codes)
        states = self.model.states
        return [[states[c] for c in row if c >= 0] for row in paths]


class ViterbiStatePredictor:
    """The map-only prediction job: rows of (id, obs...) → decoded states,
    or ``obs:state`` pairs with ``pair_output``."""

    def __init__(self, model: HMMModel, pair_output: bool = False,
                 delim: str = DELIM, mesh=None, device=None):
        """``mesh`` splits the records over its data axis
        (:meth:`ViterbiDecoder.decode_codes`)."""
        self.decoder = ViterbiDecoder(model, mesh=mesh, device=device)
        self.pair_output = pair_output
        self.delim = delim

    def predict_lines(self, rows: Sequence[Sequence[str]],
                      pad_to: Optional[int] = None) -> List[str]:
        ids = [r[0] for r in rows]
        seqs = [list(r[1:]) for r in rows]
        paths = self.decoder.decode(seqs, pad_to=pad_to)
        out = []
        for rid, seq, path in zip(ids, seqs, paths):
            if self.pair_output:
                body = self.delim.join(f"{o}:{s}" for o, s in zip(seq, path))
            else:
                body = self.delim.join(path)
            out.append(f"{rid}{self.delim}{body}")
        return out
