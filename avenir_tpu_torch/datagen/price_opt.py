"""Price-optimization generator — planted-structure port of
resource/price_opt.py; a copy of the JAX package's (numpy only), the
revenue oracle of the tutorial's round loop.

Mechanism (price_opt.py:6-27): each product draws ``num_price`` in 6–11
(``randrange(6, 12)``-style exclusive top, price_opt.py:11) and gets
``num_price − 1`` (i.e. 5–10) candidate price points on an arithmetic grid —
mirroring the reference generator's own 1-based loop (price_opt.py:17) —
with a concave revenue curve: revenue climbs by
``rev_delta`` per step up to a halfway point, then falls, so exactly one
price is revenue-optimal. A correct bandit must converge its per-product
selection to that price (the price_optimize_tutorial round loop).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np


@dataclass
class Product:
    product_id: str
    prices: List[int]
    mean_revenue: List[float]
    noise_sd: float

    @property
    def optimal_price(self) -> int:
        return self.prices[int(np.argmax(self.mean_revenue))]


@dataclass
class PriceOptSimulator:
    """Closed-loop revenue oracle: products with concave revenue curves."""

    products: Dict[str, Product] = field(default_factory=dict)
    rng: np.random.Generator = field(default_factory=lambda: np.random.default_rng(0))

    def reward(self, product_id: str, price: str) -> float:
        """Noisy revenue draw for selecting ``price`` on ``product_id``."""
        p = self.products[product_id]
        i = p.prices.index(int(price))
        return float(max(self.rng.normal(p.mean_revenue[i], p.noise_sd), 0.0))

    def initial_rows(self) -> List[List[str]]:
        """(group, item, count, reward) rows — the bandit-job input with no
        pulls yet (the tutorial's bootstrap state)."""
        return [[pid, str(price), "0", "0"]
                for pid, p in self.products.items() for price in p.prices]


def generate_price_opt(n_products: int = 20, seed: int = 42) -> PriceOptSimulator:
    rng = np.random.default_rng(seed)
    sim = PriceOptSimulator(rng=np.random.default_rng(seed + 1))
    for _ in range(n_products):
        pid = str(rng.integers(1_000_000, 8_000_000))
        num_price = int(rng.integers(6, 12))
        price_delta = int(rng.integers(2, 4))
        price = int(rng.integers(10, 80))
        rev = float(rng.integers(10_000, 30_000))
        rev_delta = float(rng.integers(500, 1500))
        halfway = num_price // 2 + int(rng.integers(-2, 2))
        prices, revs = [], []
        for step in range(1, num_price):
            prices.append(price)
            revs.append(rev)
            price += price_delta
            if step < halfway:
                rev += rev_delta + float(rng.integers(-20, 20))
            else:
                rev -= rev_delta + float(rng.integers(-20, 20))
        sim.products[pid] = Product(pid, prices, revs, noise_sd=200.0)
    return sim
