"""Online reinforcement learners — the real-time serving brain.

Capability parity with the reference's online learner library (no Hadoop
imports; used by the Storm bolt):

- ``ReinforcementLearner.java`` — abstract base with ``withActions``,
  ``withBatchSize``, ``initialize(config)``, ``nextActions(round)``,
  ``setReward(action, reward)`` (:28-86);
- ``ReinforcementLearnerFactory.java`` — name → instance (:35-46);
- ``IntervalEstimator.java`` — per-action reward histogram, select the max
  upper-confidence-bound arm, confidence limit annealed from
  ``confidence.limit`` toward ``min.confidence.limit`` by
  ``confidence.limit.reduction.step`` every
  ``confidence.limit.reduction.round.interval`` rounds (:78-149); random
  until every action has ``min.reward.distr.sample`` samples (:83-105);
- ``SampsonSampler.java`` — Thompson-style draw from the empirical reward
  sample, random up to ``max.reward`` below the minimum sample count
  (:56-79); ``OptimisticSampsonSampler.java`` — draw floored at the action
  mean (:49-52);
- ``RandomGreedyLearner.java`` — online ε-greedy with linear/log-linear
  decay (:50-78);
- ``GroupedItems.java`` (:94-141) and ``ExplorationCounter.java`` (:52-77)
  pool utilities.

These run on the host by design — per-event latency beats batch throughput
here, matching the reference's per-bolt-instance in-memory state. The batch
versions of the same policies, on the device, live in
:mod:`avenir_tpu_torch.models.bandits`; learner state is plain Python and
checkpointable (the capability the reference lacks — its bolt state dies on
restart, SURVEY.md §3.5).

A copy of the JAX package's ``models/online_rl.py`` (pure Python): the same
``random.Random(seed)`` streams and ``np.percentile`` give the same actions,
and the state of ``get_state`` is the JSON the JAX package's server
checkpoints (``convert.learner_state_from_jax``).
"""

from __future__ import annotations

import random as _random
from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional, Sequence

import numpy as np


class ReinforcementLearner:
    """Abstract online learner with the reference's builder-style API."""

    def __init__(self):
        self.actions: List[str] = []
        self.batch_size: int = 1
        self.rng = _random.Random(0)

    def with_actions(self, actions: Sequence[str]) -> "ReinforcementLearner":
        self.actions = list(actions)
        return self

    def with_batch_size(self, batch_size: int) -> "ReinforcementLearner":
        self.batch_size = batch_size
        return self

    def with_seed(self, seed: int) -> "ReinforcementLearner":
        self.rng = _random.Random(seed)
        return self

    def initialize(self, config: Dict) -> "ReinforcementLearner":
        return self

    def next_actions(self, round_num: int) -> List[str]:
        raise NotImplementedError

    def set_reward(self, action: str, reward: float) -> None:
        raise NotImplementedError

    # -- checkpointing (absent in the reference — bolt restart loses state) --
    def get_state(self) -> Dict:
        raise NotImplementedError

    def set_state(self, state: Dict) -> None:
        raise NotImplementedError


@dataclass
class _ActionStat:
    rewards: List[float] = dc_field(default_factory=list)

    @property
    def count(self) -> int:
        return len(self.rewards)

    @property
    def mean(self) -> float:
        return float(np.mean(self.rewards)) if self.rewards else 0.0


class IntervalEstimator(ReinforcementLearner):
    """Histogram upper-confidence-bound learner with annealed confidence."""

    def initialize(self, config: Dict) -> "IntervalEstimator":
        self.bin_width = float(config.get("bin.width", 1.0))
        self.confidence_limit = float(config.get("confidence.limit", 95.0))
        self.min_confidence_limit = float(config.get("min.confidence.limit", 50.0))
        self.reduction_step = float(config.get("confidence.limit.reduction.step", 5.0))
        self.reduction_interval = int(config.get("confidence.limit.reduction.round.interval", 50))
        self.min_distr_sample = int(config.get("min.reward.distr.sample", 10))
        self.cur_confidence = self.confidence_limit
        self.last_round = 0
        self.stats: Dict[str, _ActionStat] = {a: _ActionStat() for a in self.actions}
        return self

    def _upper_bound(self, stat: _ActionStat) -> float:
        """Upper bound of the reward histogram at the current confidence
        percentile (chombo HistogramStat.getConfidenceBounds equivalent:
        symmetric percentile bounds around the median of the empirical
        distribution)."""
        if not stat.rewards:
            return 0.0
        return float(np.percentile(stat.rewards, min(self.cur_confidence, 100.0)))

    def _adjust(self, round_num: int) -> None:
        if self.cur_confidence > self.min_confidence_limit:
            steps = (round_num - self.last_round) // max(self.reduction_interval, 1)
            if steps > 0:
                self.cur_confidence = max(self.cur_confidence - steps * self.reduction_step,
                                          self.min_confidence_limit)
                self.last_round = round_num

    def next_actions(self, round_num: int) -> List[str]:
        low_sample = any(self.stats[a].count < self.min_distr_sample for a in self.actions)
        out = []
        for _ in range(self.batch_size):
            if low_sample:
                out.append(self.rng.choice(self.actions))
            else:
                self._adjust(round_num)
                out.append(max(self.actions, key=lambda a: self._upper_bound(self.stats[a])))
        return out

    def set_reward(self, action: str, reward: float) -> None:
        self.stats[action].rewards.append(float(reward))

    def get_state(self) -> Dict:
        return {"rewards": {a: list(s.rewards) for a, s in self.stats.items()},
                "cur_confidence": self.cur_confidence, "last_round": self.last_round}

    def set_state(self, state: Dict) -> None:
        for a, r in state["rewards"].items():
            self.stats[a] = _ActionStat(list(r))
        self.cur_confidence = state["cur_confidence"]
        self.last_round = state["last_round"]


class SampsonSampler(ReinforcementLearner):
    """Thompson-style sampler over the empirical reward sample."""

    def initialize(self, config: Dict) -> "SampsonSampler":
        self.min_sample = int(config.get("min.sample", 10))
        self.max_reward = float(config.get("max.reward", 100.0))
        self.stats: Dict[str, _ActionStat] = {a: _ActionStat() for a in self.actions}
        return self

    def sample_reward(self, action: str) -> float:
        stat = self.stats[action]
        if stat.count < self.min_sample:
            return self.rng.uniform(0.0, self.max_reward)
        return stat.rewards[self.rng.randrange(stat.count)]

    def next_actions(self, round_num: int) -> List[str]:
        return [max(self.actions, key=self.sample_reward) for _ in range(self.batch_size)]

    def set_reward(self, action: str, reward: float) -> None:
        self.stats[action].rewards.append(float(reward))

    def get_state(self) -> Dict:
        return {"rewards": {a: list(s.rewards) for a, s in self.stats.items()}}

    def set_state(self, state: Dict) -> None:
        for a, r in state["rewards"].items():
            self.stats[a] = _ActionStat(list(r))


class OptimisticSampsonSampler(SampsonSampler):
    """Sampled reward floored at the action's mean (:49-52)."""

    def sample_reward(self, action: str) -> float:
        drawn = super().sample_reward(action)
        return max(drawn, self.stats[action].mean)


class RandomGreedyLearner(ReinforcementLearner):
    """Online ε-greedy with decaying exploration."""

    def initialize(self, config: Dict) -> "RandomGreedyLearner":
        self.epsilon = float(config.get("random.selection.prob", 1.0))
        self.decay = str(config.get("prob.reduction.algorithm", "linear"))
        self.c = float(config.get("prob.reduction.constant", 1.0))
        self.stats: Dict[str, _ActionStat] = {a: _ActionStat() for a in self.actions}
        return self

    def _epsilon(self, round_num: int) -> float:
        t = max(round_num, 1)
        if self.decay == "linear":
            return min(self.epsilon * self.c / t, self.epsilon)
        if self.decay == "logLinear":
            return min(self.epsilon * self.c * np.log(max(t, 2)) / t, self.epsilon)
        return self.epsilon

    def next_actions(self, round_num: int) -> List[str]:
        eps = self._epsilon(round_num)
        out = []
        for _ in range(self.batch_size):
            if self.rng.random() < eps:
                out.append(self.rng.choice(self.actions))
            else:
                out.append(max(self.actions, key=lambda a: self.stats[a].mean))
        return out

    def set_reward(self, action: str, reward: float) -> None:
        self.stats[action].rewards.append(float(reward))

    def get_state(self) -> Dict:
        return {"rewards": {a: list(s.rewards) for a, s in self.stats.items()}}

    def set_state(self, state: Dict) -> None:
        for a, r in state["rewards"].items():
            self.stats[a] = _ActionStat(list(r))


LEARNER_REGISTRY = {
    "intervalEstimator": IntervalEstimator,
    "sampsonSampler": SampsonSampler,
    "optimisticSampsonSampler": OptimisticSampsonSampler,
    "randomGreedy": RandomGreedyLearner,
}


def create_learner(name: str, actions: Sequence[str], config: Optional[Dict] = None,
                   batch_size: int = 1, seed: int = 0) -> ReinforcementLearner:
    """The factory (ReinforcementLearnerFactory.java:35-46)."""
    try:
        cls = LEARNER_REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown learner {name!r}; known: {sorted(LEARNER_REGISTRY)}") from None
    return (cls().with_actions(actions).with_batch_size(batch_size)
            .with_seed(seed).initialize(config or {}))


# ---------------------------------------------------------------------------
# pool utilities (API parity with GroupedItems / ExplorationCounter)
# ---------------------------------------------------------------------------

@dataclass
class Item:
    item_id: str
    count: int = 0
    reward: float = 0.0


class GroupedItems:
    """Arm-pool ops: not-tried collection, random select, max reward."""

    def __init__(self, items: Optional[Sequence[Item]] = None, seed: int = 0):
        self.items: List[Item] = list(items or [])
        self.rng = _random.Random(seed)

    def add(self, item: Item) -> None:
        self.items.append(item)

    def size(self) -> int:
        return len(self.items)

    def collect_items_not_tried(self, batch_size: int) -> List[Item]:
        return [it for it in self.items if it.count == 0][:batch_size]

    def select_random(self) -> Item:
        return self.items[self.rng.randrange(len(self.items))]

    def get_max_reward_item(self) -> Item:
        return max(self.items, key=lambda it: it.reward)


class ExplorationCounter:
    """Rolling exploration-window math over the item indices."""

    def __init__(self, count: int, batch_size: int, exploration_count: int):
        self.count = count
        self.batch_size = batch_size
        self.exploration_count = exploration_count
        self.selections: List[range] = []

    def select_next_round(self, round_num: int) -> None:
        remaining = self.exploration_count - (round_num - 1) * self.batch_size
        self.selections = []
        if remaining > 0:
            beg = remaining % self.count
            end = beg + self.batch_size - 1
            if end >= self.count:
                self.selections = [range(beg, self.count), range(0, end - self.count + 1)]
            else:
                self.selections = [range(beg, end + 1)]

    def in_exploration(self) -> bool:
        return bool(self.selections)

    def selected_indices(self) -> List[int]:
        return [i for r in self.selections for i in r]
