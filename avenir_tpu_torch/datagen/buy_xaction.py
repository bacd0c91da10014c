"""Customer-transaction generators for the Markov-chain marketing runbook.

Ports the last three reference synthesizers (SURVEY §4 "port the
generators"): ``buy_xaction.rb`` (history-dependent purchase stream),
``xaction_seq.rb`` (transactions → per-customer state-symbol sequences, the
input of ``MarkovStateTransitionModel``), and ``mark_plan.rb`` (transactions
+ transition-count model → next-contact marketing plan). The planted
structure is the reference's own: purchase amount depends on recency and
size of the previous purchase (buy_xaction.rb:34-44), so the derived
(daysDiff, amountDiff) state sequences carry real transition signal for the
Markov jobs to learn.

Vectorized numpy per day (the reference loops per transaction); output rows
and state alphabet match the reference byte-for-byte in layout.
"""

from __future__ import annotations

import datetime
from typing import Dict, List, Optional, Sequence

import numpy as np

# dd ∈ {S,M,L} (days since previous) × ad ∈ {L,E,G} (prev vs current amount)
# — the 9-state alphabet shared by xaction_seq.rb and mark_plan.rb
STATES = ["SL", "SE", "SG", "ML", "ME", "MG", "LL", "LE", "LG"]

_EPOCH = datetime.date(2013, 1, 1)


def _id(rng: np.random.Generator, n: int = 10) -> str:
    return "".join(rng.choice(list("0123456789"), size=n))


def generate_buy_xactions(cust_count: int, days_count: int,
                          visitor_percent: float = 0.1,
                          seed: int = 0) -> List[str]:
    """``custID,xid,date,amount`` rows (buy_xaction.rb layout).

    Per day, ~visitor_percent of customers (±15%) transact; a customer's
    amount depends on days since and size of their previous purchase —
    recent small purchases are followed by ~50, old ones by ~180
    (buy_xaction.rb:34-44) — planting the Markov structure the
    state-sequence jobs recover."""
    rng = np.random.default_rng(seed)
    cust_ids = [_id(rng) for _ in range(cust_count)]
    last_day: Dict[int, int] = {}
    last_amt: Dict[int, int] = {}
    rows: List[str] = []
    xid = 1_400_000_000
    for day in range(days_count):
        n = int(visitor_percent * cust_count * (85 + rng.integers(30)) / 100)
        picks = rng.integers(0, cust_count, size=n)
        date = _EPOCH + datetime.timedelta(days=day)
        for c in picks:
            c = int(c)
            if c in last_day:
                nd = day - last_day[c]
                la = last_amt[c]
                if nd < 30:
                    amount = (50 + int(rng.integers(20)) - 10 if la < 40
                              else 30 + int(rng.integers(10)) - 5)
                elif nd < 60:
                    amount = (100 + int(rng.integers(40)) - 20 if la < 80
                              else 60 + int(rng.integers(20)) - 10)
                else:
                    amount = (180 + int(rng.integers(60)) - 30 if la < 150
                              else 120 + int(rng.integers(40)) - 20)
            else:
                amount = 40 + int(rng.integers(180))
            last_day[c] = day
            last_amt[c] = amount
            xid += 1
            rows.append(f"{cust_ids[c]},{xid},{date.isoformat()},{amount}")
    return rows


def _state(days_diff: int, prev_amt: int, amt: int,
           short_days: int, long_days: int) -> str:
    dd = "S" if days_diff < short_days else ("M" if days_diff < long_days
                                             else "L")
    if prev_amt < 0.9 * amt:
        ad = "L"
    elif prev_amt < 1.1 * amt:
        ad = "E"
    else:
        ad = "G"
    return dd + ad


def _group_by_customer(xaction_rows: Sequence[str]):
    by_cust: Dict[str, List[List[str]]] = {}
    for line in xaction_rows:
        items = line.split(",")
        by_cust.setdefault(items[0], []).append(items[2:])
    return by_cust


def xactions_to_sequences(xaction_rows: Sequence[str],
                          short_days: int = 15,
                          long_days: int = 60) -> List[str]:
    """``custID,state,state,...`` rows (xaction_seq.rb) — the training input
    of the MarkovStateTransitionModel job. Customers with fewer than two
    transitions are dropped, like the reference (seq.size > 1)."""
    out: List[str] = []
    for cid, xs in _group_by_customer(xaction_rows).items():
        seq: List[str] = []
        for prev, cur in zip(xs, xs[1:]):
            days = (datetime.date.fromisoformat(cur[0]) -
                    datetime.date.fromisoformat(prev[0])).days
            seq.append(_state(days, int(prev[1]), int(cur[1]),
                              short_days, long_days))
        if len(seq) > 1:
            out.append(cid + "," + ",".join(seq))
    return out


def marketing_plan(xaction_rows: Sequence[str],
                   model_rows: Sequence[Sequence[int]],
                   states: Optional[List[str]] = None) -> List[str]:
    """``custID, next_contact_date`` rows (mark_plan.rb): each customer's
    LAST observed state row of the transition-count model picks (argmax)
    the expected next state; S/M/L next states map to +15/+45/+90 days
    after the last transaction. Note the reference uses 30/60-day
    thresholds here (mark_plan.rb:55-61), not xaction_seq's 15/60."""
    states = states or STATES
    model = [list(map(int, r)) for r in model_rows]
    out: List[str] = []
    for cid, xs in _group_by_customer(xaction_rows).items():
        seq: List[str] = []
        last_date = _EPOCH
        for prev, cur in zip(xs, xs[1:]):
            d_cur = datetime.date.fromisoformat(cur[0])
            last_date = d_cur
            days = (d_cur - datetime.date.fromisoformat(prev[0])).days
            seq.append(_state(days, int(prev[1]), int(cur[1]), 30, 60))
        if not seq:
            continue
        row = model[states.index(seq[-1])]
        next_state = states[int(np.argmax(row))]
        delta = {"S": 15, "M": 45, "L": 90}[next_state[0]]
        nd = last_date + datetime.timedelta(days=delta)
        out.append(f"{cid}, {nd.isoformat()}")
    return out
