"""Lead-generation simulator — planted-structure port of resource/lead_gen.py.

Mechanism (lead_gen.py:12-15): three landing pages with Gaussian
click-through distributions — page1 (30, 12), page2 (60, 30), page3 (80, 10)
— so page3 is the best arm. The reference runs this as a live closed loop
against the Storm topology through Redis queues; here the same loop drives
:class:`avenir_tpu_torch.pipeline.streaming.ReinforcementLearnerServer`
through in-process queues, asserting the learner converges to page3.  A
copy of the JAX package's simulator: ``uuid5`` event ids and one seeded
numpy generator, so its runs are deterministic.
"""

from __future__ import annotations

import uuid
from typing import Dict, List, Optional, Tuple

import numpy as np

CTR_DISTR: Dict[str, Tuple[float, float]] = {
    "page1": (30.0, 12.0),
    "page2": (60.0, 30.0),
    "page3": (80.0, 10.0),
}
BEST_ACTION = "page3"


class LeadGenSimulator:
    """Event source + reward oracle, one object closing the loop.

    Implements the EventSource/RewardReader protocols of the serving loop:
    each ``next_event`` is a session visit; each action selection gets a
    CTR draw from that page's Gaussian banked as its reward.
    """

    def __init__(self, n_events: int, seed: int = 0,
                 ctr: Optional[Dict[str, Tuple[float, float]]] = None):
        self.rng = np.random.default_rng(seed)
        self.remaining = n_events
        self.round = 0
        self.ctr = dict(ctr or CTR_DISTR)
        self._pending_rewards: List[Tuple[str, float]] = []
        self.selections: Dict[str, int] = {a: 0 for a in self.ctr}

    @property
    def actions(self) -> List[str]:
        return list(self.ctr)

    # -- EventSource ---------------------------------------------------------
    def next_event(self) -> Optional[Tuple[str, int]]:
        if self.remaining <= 0:
            return None
        self.remaining -= 1
        self.round += 1
        return str(uuid.uuid5(uuid.NAMESPACE_OID, str(self.round))), self.round

    # -- RewardReader --------------------------------------------------------
    def read_rewards(self) -> List[Tuple[str, float]]:
        out, self._pending_rewards = self._pending_rewards, []
        return out

    # -- ActionWriter --------------------------------------------------------
    def write(self, event_id: str, actions: List[str]) -> None:
        for a in actions:
            mu, sd = self.ctr[a]
            click_rate = float(np.clip(self.rng.normal(mu, sd), 0.0, 100.0))
            self._pending_rewards.append((a, click_rate))
            self.selections[a] += 1

    def best_selected(self) -> str:
        return max(self.selections, key=self.selections.get)
