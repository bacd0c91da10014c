"""Batch multi-armed bandits, vectorised over groups; port of
``avenir_tpu/models/bandits.py``.

Capability parity with the reference's round-based MR bandit jobs (input
rows ``group,item,count,reward``; one batch of selections per group per
round, with an external loop updating rewards and bumping
``current.round.num`` — resource/price_optimize_tutorial.txt:42-78):

- ``GreedyRandomBandit.java`` — ε-greedy with linear ε·c/t or log-linear
  ε·c·ln t/t decay (:196-224) and the AuerGreedy variant with
  ε_t = min(1, d·K/(Δ²·t)) (:232-274), exploring with probability ε_t as
  the algorithm intends (the reference inverts it at :263; the JAX package
  documents the same deliberate fix).
- ``AuerDeterministic.java`` — UCB1: value = r̄/r̄_max + √(2·ln t / n_i)
  (:200-223), untried items first (:191-196).
- ``SoftMaxBandit.java`` — Boltzmann sampling ∝ exp((r/r_max)/τ) (:182-198).
- ``RandomFirstGreedyBandit.java`` — explore-first with budget =
  factor·K (simple) or the PAC bound 4/Δ² + ln(2K/δ) (:138-147), a rolling
  exploration window over item indices (ExplorationCounter.java:52-77),
  then greedy.

Group state is dense [G, K] count/reward arrays with a ``valid`` mask for
ragged groups.  The random draws are the JAX package's, taken on the host
by ``utils/prng.py`` from the same keys; the [G, K] arithmetic and the
argmaxes run in float32 on the state's device, so one call serves 100
products × 12 arms or 1M groups alike.  ``cuda`` and the CPU select the
same arms: the draws are the same host numbers and every device operation
is correctly rounded (UCB1's ``log t`` is taken in float64 and rounded
once, so that neither device's float32 ``log`` decides a near-tie).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np
import torch

from avenir_tpu_torch.device import resolve_device
from avenir_tpu_torch.utils import prng

NEG = -1e30


def _masked_argmax(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    return torch.argmax(torch.where(valid, x, NEG), dim=-1)


def _random_valid(key: np.ndarray, valid: torch.Tensor) -> torch.Tensor:
    """Uniform pick among valid arms per group. valid [G, K] → [G]."""
    g = torch.from_numpy(prng.gumbel(key, tuple(valid.shape))).to(valid.device)
    return _masked_argmax(g, valid)


def mean_reward(counts: torch.Tensor, rewards: torch.Tensor) -> torch.Tensor:
    """Inputs are (trial count, average reward) per arm as in the
    reference's data files, so the mean is the reward column itself; arms
    never tried report 0."""
    return torch.where(counts > 0, rewards, torch.zeros_like(rewards))


def _first_untried(counts: torch.Tensor, valid: torch.Tensor):
    """(any untried valid arm [G], the first one [G]); ``torch.argmax``
    takes no bool, and over 0/1 its first maximum is the first untried."""
    untried = valid & (counts == 0)
    return untried.any(dim=1), torch.argmax(untried.to(torch.uint8), dim=1)


def _group_max_reward(rbar: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    best = torch.where(valid, rbar, torch.zeros_like(rbar)).amax(dim=1, keepdim=True)
    return torch.clamp(best, min=1e-9)


def epsilon_greedy_select(key: np.ndarray, counts: torch.Tensor,
                          rewards: torch.Tensor, valid: torch.Tensor,
                          epsilon: torch.Tensor) -> torch.Tensor:
    """[G] int32 arm: explore uniformly with prob ε, else argmax mean
    reward.  ``epsilon`` is float32 [G] on the state's device."""
    kx, ke = prng.split(key)
    u = torch.from_numpy(prng.uniform(ke, (counts.shape[0],))).to(counts.device)
    explore = u < epsilon
    rand = _random_valid(kx, valid)
    greedy = _masked_argmax(mean_reward(counts, rewards), valid)
    return torch.where(explore, rand, greedy).to(torch.int32)


def ucb1_select(key: np.ndarray, counts: torch.Tensor, rewards: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """UCB1 on r̄ normalized by the group max (AuerDeterministic.java:212)."""
    del key
    t = torch.clamp(torch.where(valid, counts, torch.zeros_like(counts))
                    .sum(dim=1, keepdim=True), min=1.0)
    rbar = mean_reward(counts, rewards)
    rmax = _group_max_reward(rbar, valid)
    log_t = torch.log(t.to(torch.float64)).to(torch.float32)
    bonus = torch.sqrt(2.0 * log_t / torch.clamp(counts, min=1.0))
    value = rbar / rmax + bonus
    any_untried, first_untried = _first_untried(counts, valid)
    return torch.where(any_untried, first_untried,
                       _masked_argmax(value, valid)).to(torch.int32)


def softmax_select(key: np.ndarray, counts: torch.Tensor, rewards: torch.Tensor,
                   valid: torch.Tensor, tau: float) -> torch.Tensor:
    """Boltzmann: P(i) ∝ exp((r̄_i/r̄_max)/τ) over valid arms; untried arms
    first (cold-start guard — at low τ a pure Boltzmann draw locks onto the
    first arm sampled).  The draw is ``prng.categorical`` with its argmax
    on the device."""
    rbar = mean_reward(counts, rewards)
    rmax = _group_max_reward(rbar, valid)
    temp = torch.tensor(max(np.float32(tau), np.float32(1e-6)), dtype=torch.float32,
                        device=counts.device)
    logits = torch.where(valid, (rbar / rmax) / temp, NEG)
    g = torch.from_numpy(prng.gumbel(key, tuple(logits.shape))).to(logits.device)
    drawn = torch.argmax(g + logits, dim=-1)
    any_untried, first_untried = _first_untried(counts, valid)
    return torch.where(any_untried, first_untried, drawn).to(torch.int32)


def _epsilon_for_round(algorithm: str, round_num: int, batch_size: int,
                       epsilon: float, c: float, auer_d: float,
                       k: int, reward_diff: float) -> float:
    t = max((round_num - 1) * batch_size + 1, 1)
    if algorithm == "linear":
        return min(epsilon * c / t, epsilon)
    if algorithm == "logLinear":
        return min(epsilon * c * np.log(max(t, 2)) / t, epsilon)
    if algorithm == "auer":
        return min(auer_d * k / (max(reward_diff, 1e-6) ** 2 * t), 1.0)
    raise ValueError(f"unknown algorithm {algorithm!r}")


def _state_tensors(counts, rewards, valid, device):
    return (torch.as_tensor(np.asarray(counts, np.float32), device=device),
            torch.as_tensor(np.asarray(rewards, np.float32), device=device),
            torch.as_tensor(np.asarray(valid, bool), device=device))


class GreedyRandomBandit:
    """ε-greedy family with decay schedules (incl. AuerGreedy ε_t)."""

    def __init__(self, algorithm: str = "linear", epsilon: float = 1.0,
                 prob_reduction_constant: float = 1.0, auer_constant: float = 1.0,
                 batch_size: int = 1, device=None):
        if algorithm not in ("linear", "logLinear", "auer"):
            raise ValueError(f"unknown algorithm {algorithm!r}")
        self.algorithm = algorithm
        self.epsilon = epsilon
        self.c = prob_reduction_constant
        self.auer_d = auer_constant
        self.batch_size = batch_size
        self.device = resolve_device(device)

    def select(self, key, counts: np.ndarray, rewards: np.ndarray,
               valid: np.ndarray, round_num: int) -> np.ndarray:
        rbar = np.where(counts > 0, rewards, 0.0)
        if self.algorithm == "auer":
            # per-group Δ = (max − second max)/max of mean rewards
            top2 = np.sort(np.where(valid, rbar, -np.inf), axis=1)[:, -2:]
            diff = np.where(top2[:, 1] > 0,
                            (top2[:, 1] - np.maximum(top2[:, 0], 0)) / np.maximum(top2[:, 1], 1e-9),
                            1.0)
            eps = np.array([
                _epsilon_for_round("auer", round_num, self.batch_size, self.epsilon,
                                   self.c, self.auer_d, valid.shape[1], float(d))
                for d in diff])
        else:
            e = _epsilon_for_round(self.algorithm, round_num, self.batch_size,
                                   self.epsilon, self.c, self.auer_d, valid.shape[1], 1.0)
            eps = np.full(counts.shape[0], e)
        c, r, v = _state_tensors(counts, rewards, valid, self.device)
        eps_t = torch.as_tensor(eps.astype(np.float32), device=self.device)
        return epsilon_greedy_select(key, c, r, v, eps_t).cpu().numpy()


class AuerDeterministicBandit:
    """UCB1 (deterministic)."""

    def __init__(self, device=None):
        self.device = resolve_device(device)

    def select(self, key, counts, rewards, valid, round_num: int) -> np.ndarray:
        del round_num
        return ucb1_select(key, *_state_tensors(counts, rewards, valid,
                                                self.device)).cpu().numpy()


class SoftMaxBandit:
    def __init__(self, tau: float = 0.1, device=None):
        self.tau = tau
        self.device = resolve_device(device)

    def select(self, key, counts, rewards, valid, round_num: int) -> np.ndarray:
        del round_num
        return softmax_select(key, *_state_tensors(counts, rewards, valid,
                                                   self.device),
                              self.tau).cpu().numpy()


class RandomFirstGreedyBandit:
    """Explore-first: sweep arms round-robin for the exploration budget, then
    pure greedy.  The window is numpy on the host; only the greedy masked
    argmax runs on the device."""

    def __init__(self, strategy: str = "simple", exploration_count_factor: int = 3,
                 reward_diff: float = 0.5, prob_diff: float = 0.1, batch_size: int = 1,
                 device=None):
        if strategy not in ("simple", "pac"):
            raise ValueError(f"unknown strategy {strategy!r}")
        self.strategy = strategy
        self.factor = exploration_count_factor
        self.reward_diff = reward_diff
        self.prob_diff = prob_diff
        self.batch_size = batch_size
        self.device = resolve_device(device)

    def exploration_count(self, k: int) -> int:
        if self.strategy == "simple":
            return self.factor * k
        return int(4.0 / (self.reward_diff ** 2) + np.log(2.0 * k / self.prob_diff))

    def select(self, key, counts, rewards, valid, round_num: int) -> np.ndarray:
        n_arms = valid.sum(axis=1)
        expl = np.array([self.exploration_count(int(ka)) for ka in n_arms])
        consumed = (round_num - 1) * self.batch_size
        remaining = expl - consumed
        # rolling window position (ExplorationCounter.java:52-77)
        idx = np.where(n_arms > 0, remaining % np.maximum(n_arms, 1), 0).astype(np.int64)
        c, r, v = _state_tensors(counts, rewards, valid, self.device)
        greedy = _masked_argmax(mean_reward(c, r), v).cpu().numpy()
        return np.where(remaining > 0, idx, greedy).astype(np.int32)


ALGORITHM_REGISTRY = {
    "greedyRandomLinear": lambda **kw: GreedyRandomBandit("linear", **kw),
    "greedyRandomLogLinear": lambda **kw: GreedyRandomBandit("logLinear", **kw),
    "auerGreedy": lambda **kw: GreedyRandomBandit("auer", **kw),
    "auerDeterministic": lambda **kw: AuerDeterministicBandit(**kw),
    "softMax": lambda **kw: SoftMaxBandit(**kw),
    "randomFirstGreedy": lambda **kw: RandomFirstGreedyBandit(**kw),
}


# ---------------------------------------------------------------------------
# the job facade over group,item,count,reward rows
# ---------------------------------------------------------------------------

@dataclass
class GroupState:
    """Dense per-group arm state built from the reference's row format."""

    groups: List[str]
    items: List[List[str]]               # per group arm ids
    counts: np.ndarray                   # [G, K]
    rewards: np.ndarray                  # [G, K] mean reward
    valid: np.ndarray                    # [G, K] bool

    @classmethod
    def from_rows(cls, rows: Iterable[Sequence[str]], count_ord: int = 2,
                  reward_ord: int = 3) -> "GroupState":
        """``count_ord``/``reward_ord`` mirror the reference's
        ``count.ordinal``/``reward.ordinal`` config — the RunningAggregator
        loop feeds 5-column ``group,item,count,sum,avg`` rows with
        count.ordinal=2 / reward.ordinal=4
        (resource/price_optimize_tutorial.txt:70-90)."""
        by_group: Dict[str, List[Tuple[str, float, float]]] = {}
        for r in rows:
            by_group.setdefault(str(r[0]), []).append(
                (str(r[1]), float(r[count_ord]), float(r[reward_ord])))
        groups = sorted(by_group)
        k = max(len(v) for v in by_group.values())
        g = len(groups)
        counts = np.zeros((g, k), np.float64)
        rewards = np.zeros((g, k), np.float64)
        valid = np.zeros((g, k), bool)
        items: List[List[str]] = []
        for gi, grp in enumerate(groups):
            arms = by_group[grp]
            items.append([a for a, _, _ in arms])
            for ai, (_, cnt, rew) in enumerate(arms):
                counts[gi, ai] = cnt
                rewards[gi, ai] = rew
                valid[gi, ai] = True
        return cls(groups, items, counts, rewards, valid)

    def update(self, group: str, item: str, reward: float) -> None:
        gi = self.groups.index(group)
        ai = self.items[gi].index(item)
        c = self.counts[gi, ai]
        self.rewards[gi, ai] = (self.rewards[gi, ai] * c + reward) / (c + 1)
        self.counts[gi, ai] = c + 1

    def to_rows(self) -> List[List[str]]:
        out = []
        for gi, grp in enumerate(self.groups):
            for ai, item in enumerate(self.items[gi]):
                out.append([grp, item, str(int(self.counts[gi, ai])),
                            str(self.rewards[gi, ai])])
        return out


class BanditJob:
    """Round driver: rows in → per-group selection lines out (the MR job's
    CSV contract, minus the cluster).  ``device`` is ``cuda`` unless the
    caller asks for ``cpu``."""

    def __init__(self, algorithm: str, seed: int = 0, device=None, **kwargs):
        try:
            make = ALGORITHM_REGISTRY[algorithm]
        except KeyError:
            raise ValueError(f"unknown bandit algorithm {algorithm!r}; "
                             f"known: {sorted(ALGORITHM_REGISTRY)}") from None
        self.bandit = make(device=device, **kwargs)
        self.key = prng.prng_key(seed)

    def select(self, state: GroupState, round_num: int) -> List[Tuple[str, str]]:
        self.key, sub = prng.split(self.key)
        arm = self.bandit.select(sub, state.counts, state.rewards, state.valid, round_num)
        return [(g, state.items[gi][int(arm[gi])]) for gi, g in enumerate(state.groups)]

    def select_lines(self, rows: Iterable[Sequence[str]], round_num: int,
                     delim: str = ",", count_ord: int = 2,
                     reward_ord: int = 3) -> List[str]:
        state = GroupState.from_rows(rows, count_ord=count_ord,
                                     reward_ord=reward_ord)
        return [f"{g}{delim}{item}" for g, item in self.select(state, round_num)]
