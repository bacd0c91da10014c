"""The GraftPool device arbiter — weighted deficit-round-robin fair
queueing plus tenant-scoped admission control at the dispatch seam; port of
``avenir_tpu/tenancy/arbiter.py``, line for line.

One device pool, N tenants, one arbiter: every device dispatch the
framework makes — a batch SharedScan chunk fold, a stream pane fold
(both through ``pipeline/scan.py::ChunkFolder.fold``), a serving batch
(``serving/batcher.py``) — acquires a :meth:`GraftPool.slot` before it
runs.  On ``cuda`` a fold's slot covers the kernel launch AND the host
accumulation's wait for the device (``Accumulator.add`` synchronizes once a
chunk), and a serving dispatch's slot covers the whole ``score_lines`` call,
so a slot is held for as long as the card works for that tenant.  The
arbiter decides who goes next when the pool is contended:

- **weighted DRR** (deficit round robin): each tenant's deficit grows by
  its contracted ``share`` per round and one unit of deficit buys one
  dispatch, so BACKLOGGED tenants split device time in share proportion
  — a flooding tenant cannot starve the others.  Like every
  work-conserving fair queue, shares bind only while a tenant has work
  WAITING: two closed-loop tenants each keeping one dispatch outstanding
  alternate 1:1 regardless of share (neither demands more than half, and
  favoring one would idle the device), which is the correct non-idling
  outcome — the noisy-tenant drill floods with many concurrent
  dispatches precisely because that is the shape shares pace;
- **strict priority tiers**: among quota-eligible waiting tenants only
  the highest ``priority`` tier is served; shares arbitrate WITHIN a
  tier (a latency-critical serving tenant outranks batch backfill);
- **in-flight quota**: ``max.inflight`` bounds a tenant's concurrently
  granted slots regardless of deficit;
- **tenant-scoped admission control**: a tenant whose waiting queue is at
  ``queue.depth``, or whose queued dispatch ages past its deadline,
  sheds with a typed
  :class:`~avenir_tpu_torch.serving.errors.TenantShedError` naming the tenant
  and the quota that fired — shedding tenant A never sheds tenant B,
  because every bound is per-tenant by construction.

Every transition journals golden-schema'd events — ``tenant.admitted``
(once per tenant per journal), ``tenant.throttled`` (latched per
excursion, like ``slo.violation``), ``tenant.shed`` — and per-tenant
``Tenant.<id>`` counters (granted/shed/throttled) book the arbitration,
so isolation is a measured artifact.

Off-is-free: the module singleton is a disabled pool until
:func:`configure` finds a ``tenant.<id>.share`` contract; disabled (or
for work outside any tenant scope) ``slot()`` returns a shared null
context — one attribute check on the hot path, the tracer discipline.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional

from avenir_tpu_torch.telemetry import spans as tel
from avenir_tpu_torch.tenancy.contract import (TenantContract,
                                              contracts_from_conf)
from avenir_tpu_torch.utils.metrics import Counters

# shared inert context manager: the disabled/unmanaged fast path (a
# nullcontext instance is stateless, hence reusable across threads)
_NULL = contextlib.nullcontext()

# bounds on the queue-drain estimate a shed reports (Retry-After must be
# neither 0 — "hammer me again" — nor unbounded); ONE policy shared by
# every shed path (the arbiter here, the serving door in
# serving/batcher.py) so the header means the same thing everywhere
RETRY_AFTER_MIN_S = 0.05
RETRY_AFTER_MAX_S = 600.0
# EWMA weight for the per-tenant slot-hold estimate the drain math uses
_HOLD_ALPHA = 0.2
# how often a queued waiter with an ``on_wait`` hook is woken to tick its
# caller's liveness signal (the serving dispatcher's heartbeat refresh)
_WAIT_TICK_S = 0.25


def tenant_scope(tenant: Optional[str]):
    """Run a workload as ``tenant``: every journal event it emits carries
    the label and every dispatch slot it acquires is arbitrated under the
    tenant's contract.  ``None``/empty = a no-op scope (unmanaged)."""
    return tel.label_scope(tenant=tenant or None)


class _Ticket:
    __slots__ = ("cost", "granted", "enqueued")

    def __init__(self, cost: float, now: float):
        self.cost = cost
        self.granted = False
        self.enqueued = now


class _TenantState:
    __slots__ = ("contract", "queue", "inflight", "deficit", "throttled",
                 "hold_ewma", "grants")

    def __init__(self, contract: TenantContract):
        self.contract = contract
        self.queue: Deque[_Ticket] = deque()
        self.inflight = 0
        self.deficit = 0.0
        self.throttled = False           # the per-excursion event latch
        self.hold_ewma = 0.0             # mean slot hold (drain estimate)
        self.grants = 0


class GraftPool:
    """The tenant arbiter over one device pool (see module docstring).

    ``capacity`` is how many dispatch slots exist pool-wide
    (``tenant.pool.concurrency``, default 1 — one accelerator serializes
    dispatches anyway; raise it for multi-device rigs where concurrent
    dispatches genuinely overlap)."""

    def __init__(self, contracts: Dict[str, TenantContract],
                 capacity: int = 1, counters: Optional[Counters] = None):
        if not contracts:
            raise ValueError("GraftPool needs at least one TenantContract")
        self.enabled = True
        self.capacity = max(int(capacity), 1)
        self.counters = counters if counters is not None else Counters()
        self._states = {t: _TenantState(c) for t, c in
                        sorted(contracts.items())}
        self._rr: List[str] = list(self._states)     # stable round order
        self._rr_pos = 0             # the DRR round pointer (persistent:
        #                              a capacity-1 pool grants one slot
        #                              per engine call, so the round must
        #                              survive across calls or weighting
        #                              degenerates to plain round-robin)
        self._credited: set = set()  # tenants credited in the current round
        self._in_use = 0
        self._cond = threading.Condition()

    @property
    def contracts(self) -> Dict[str, TenantContract]:
        return {t: st.contract for t, st in self._states.items()}

    # -- the dispatch slot (any thread) --------------------------------------
    def slot(self, tenant: Optional[str] = None, cost: float = 1.0,
             timeout_s: Optional[float] = None, on_wait=None):
        """A context manager holding one arbitrated device slot.

        ``tenant`` defaults to the ambient ``tenant`` label
        (:func:`tenant_scope`); work outside any tenant — or under a
        tenant with no contract — passes through unmanaged (the shared
        null context), so un-tenanted deployments never pay arbitration.
        ``timeout_s`` bounds the queued wait (default: the contract's
        ``queue.timeout.ms``; None = wait for the share).  ``on_wait``
        (optional, no-arg) is invoked at least every ``_WAIT_TICK_S``
        while the caller is queued — the liveness hook a caller with its
        own watchdog needs (the serving dispatcher refreshes its
        heartbeat through it, so a tenant replica merely being PACED is
        never mistaken for a wedged one and reaped).  Raises
        :class:`~avenir_tpu_torch.serving.errors.TenantShedError` when the
        tenant's queue share is full or the deadline passes."""
        if tenant is None:
            tenant = tel.current_label("tenant")
        state = self._states.get(tenant) if tenant else None
        if state is None:
            return _NULL
        return self._slot_cm(tenant, state, float(cost), timeout_s, on_wait)

    @contextlib.contextmanager
    def _slot_cm(self, tenant: str, state: _TenantState, cost: float,
                 timeout_s: Optional[float], on_wait):
        t0 = self._acquire(tenant, state, cost, timeout_s, on_wait)
        try:
            yield tenant
        finally:
            self._release(tenant, state, t0)

    def _acquire(self, tenant: str, state: _TenantState, cost: float,
                 timeout_s: Optional[float], on_wait=None) -> float:
        c = state.contract
        tel.tracer().event_once(
            "tenant.admitted", key=tenant, tenant=tenant, share=c.share,
            priority=c.priority, max_inflight=c.max_inflight,
            queue_depth=c.queue_depth)
        if timeout_s is None:
            timeout_s = c.queue_timeout_s
        now = time.monotonic()
        deadline = now + timeout_s if timeout_s is not None else None
        # journal writes happen OUTSIDE the arbiter lock: a shed storm's
        # file I/O must never serialize other tenants' grants behind it
        # (fires = deferred tenant.throttled events; shed = the deferred
        # tenant.shed + typed error)
        fires: List[tuple] = []
        shed = None
        with self._cond:
            if len(state.queue) >= c.queue_depth:
                shed = self._shed_locked(tenant, state, "queue.depth")
            else:
                ticket = _Ticket(cost, now)
                state.queue.append(ticket)
                try:
                    if len(state.queue) > max(c.max_inflight, 1):
                        # backlog beyond what the tenant's quota can ever
                        # run concurrently: it is being paced — the
                        # deterministic throttle signal a capacity-1 pool
                        # can emit (the grant engine's quota/priority/
                        # share marks need spare capacity to observe a
                        # pass-over)
                        self._throttle_locked(tenant, state, "backlog",
                                              fires)
                    self._grant_locked(fires)
                    while not ticket.granted:
                        remaining = None
                        if deadline is not None:
                            remaining = deadline - time.monotonic()
                            if remaining <= 0:
                                state.queue.remove(ticket)
                                shed = self._shed_locked(tenant, state,
                                                         "deadline")
                                break
                        if on_wait is not None:
                            self._cond.wait(
                                _WAIT_TICK_S if remaining is None
                                else min(remaining, _WAIT_TICK_S))
                            on_wait()
                        else:
                            self._cond.wait(remaining)
                except BaseException:
                    # the ticket must never outlive its owner: an
                    # exception escaping here (KeyboardInterrupt in the
                    # wait, an error out of on_wait) would otherwise
                    # leave a queued ticket the engine later grants with
                    # nobody to release it — a one-way slot leak that
                    # wedges a capacity-1 pool
                    if ticket.granted:
                        state.inflight -= 1
                        self._in_use -= 1
                        self._grant_locked(fires)
                        self._cond.notify_all()
                    elif ticket in state.queue:
                        state.queue.remove(ticket)
                    raise
        self._emit_fires(fires)
        if shed is not None:
            err, fields = shed
            tel.tracer().event("tenant.shed", **fields)
            raise err
        return time.monotonic()

    def _release(self, tenant: str, state: _TenantState, t0: float) -> None:
        hold = time.monotonic() - t0
        fires: List[tuple] = []
        with self._cond:
            state.inflight -= 1
            self._in_use -= 1
            state.hold_ewma = (hold if state.hold_ewma == 0.0 else
                               (1.0 - _HOLD_ALPHA) * state.hold_ewma
                               + _HOLD_ALPHA * hold)
            self._grant_locked(fires)
            self._cond.notify_all()
        self._emit_fires(fires)

    @staticmethod
    def _emit_fires(fires: List[tuple]) -> None:
        tracer = tel.tracer()
        for ev, fields in fires:
            tracer.event(ev, **fields)

    # -- the grant engine (lock held) ----------------------------------------
    def _grant_locked(self, fires: List[tuple]) -> None:
        """Hand free slots to waiting tenants: strict priority tiers over
        the quota-eligible set, weighted DRR within the winning tier.
        Tenants passed over on POLICY (quota, priority, exhausted
        deficit) while work was waiting are marked throttled (latched —
        one ``tenant.throttled`` per excursion)."""
        # classic DRR over a persistent round: the pointer stays on a
        # tenant while its deficit buys dispatches, each tenant is
        # credited (+= share) once per round, and a full fruitless pass
        # starts a new round — so deficits always grow toward the next
        # grant (liveness) and grants converge to share proportion over
        # any contended interval, at ANY capacity (a capacity-1 pool
        # grants one slot per engine call; the round state carries the
        # weighting across calls)
        n = len(self._rr)
        while self._in_use < self.capacity:
            eligible = set()
            any_waiting = False
            for t in self._rr:
                st = self._states[t]
                if not st.queue:
                    continue
                any_waiting = True
                quota = st.contract.max_inflight
                if quota and st.inflight >= quota:
                    self._throttle_locked(t, st, "quota", fires)
                else:
                    eligible.add(t)
            if not any_waiting or not eligible:
                break
            top = max(self._states[t].contract.priority for t in eligible)
            tier = set()
            for t in eligible:
                if self._states[t].contract.priority == top:
                    tier.add(t)
                else:
                    self._throttle_locked(t, self._states[t], "priority",
                                          fires)
            granted = False
            scanned = 0
            while scanned < n and self._in_use < self.capacity:
                t = self._rr[self._rr_pos]
                st = self._states[t]
                quota = st.contract.max_inflight
                if t in tier and st.queue and \
                        not (quota and st.inflight >= quota):
                    if t not in self._credited:
                        self._credited.add(t)
                        st.deficit += st.contract.share
                    if st.deficit >= st.queue[0].cost:
                        ticket = st.queue.popleft()
                        st.deficit -= ticket.cost
                        ticket.granted = True
                        st.inflight += 1
                        st.grants += 1
                        self._in_use += 1
                        granted = True
                        if st.throttled:
                            st.throttled = False   # excursion over: re-arm
                        if not st.queue:
                            st.deficit = 0.0       # DRR: idle forfeits
                        else:
                            continue   # deficit may buy another dispatch
                    else:
                        # share exhausted this round with work waiting:
                        # the tenant is being paced
                        self._throttle_locked(t, st, "share", fires)
                self._rr_pos = (self._rr_pos + 1) % n
                scanned += 1
            if scanned >= n and not granted:
                # a full fruitless pass: new round — every tenant earns
                # fresh credit, so some deficit crosses its cost next pass
                self._credited.clear()
        self._cond.notify_all()

    def _throttle_locked(self, tenant: str, state: _TenantState,
                         reason: str, fires: List[tuple]) -> None:
        """Latch the tenant's throttle excursion; the journal event is
        DEFERRED into ``fires`` (emitted after the lock drops — file I/O
        inside the arbiter's critical section would let one tenant's
        throttle storm stall every other tenant's grants)."""
        if state.throttled:
            return
        state.throttled = True
        self.counters.increment(f"Tenant.{tenant}", "throttled")
        fires.append(("tenant.throttled",
                      dict(tenant=tenant, reason=reason,
                           waiting=len(state.queue),
                           inflight=state.inflight)))

    def _shed_locked(self, tenant: str, state: _TenantState,
                     quota: str) -> tuple:
        """Book the shed and BUILD the typed error + journal payload —
        the caller emits and raises after releasing the lock, so a shed
        storm's journal writes never serialize other tenants' slots."""
        from avenir_tpu_torch.serving.errors import TenantShedError

        retry_after = self.drain_estimate_s(tenant, locked=True)
        self.counters.increment(f"Tenant.{tenant}", "shed")
        fields = dict(tenant=tenant, quota=quota,
                      waiting=len(state.queue), inflight=state.inflight,
                      retry_after_ms=round(retry_after * 1e3, 1))
        err = TenantShedError(
            f"tenant {tenant!r} shed at the pool door: {quota} "
            f"(waiting={len(state.queue)}, inflight={state.inflight}, "
            f"retry after ~{retry_after:.2f}s) — other tenants keep "
            f"their share",
            tenant=tenant, quota=quota, retry_after_s=retry_after)
        return err, fields

    # -- observability --------------------------------------------------------
    def drain_estimate_s(self, tenant: str, locked: bool = False) -> float:
        """How long this tenant's backlog needs to drain at its
        contracted share of the pool — the ``Retry-After`` a shed
        carries.  Backlog × mean slot hold ÷ the tenant's slice of
        capacity, bounded to a sane window (no samples yet reads as one
        nominal 100 ms hold)."""
        ctx = contextlib.nullcontext() if locked else self._cond
        with ctx:
            state = self._states[tenant]
            backlog = len(state.queue) + state.inflight
            hold = state.hold_ewma or 0.1
            total_share = sum(st.contract.share
                              for st in self._states.values())
            slice_ = self.capacity * state.contract.share / total_share
        est = (backlog + 1) * hold / max(slice_, 1e-6)
        return min(max(est, RETRY_AFTER_MIN_S), RETRY_AFTER_MAX_S)

    def queue_depths(self) -> Dict[str, int]:
        """Per-tenant waiting dispatches — the ``tenant.queue.<id>``
        gauges a soak publishes."""
        with self._cond:
            return {t: len(st.queue) for t, st in self._states.items()}

    def stats(self) -> Dict[str, dict]:
        """Per-tenant arbitration snapshot (grants/inflight/waiting plus
        the booked shed/throttle counters)."""
        groups = self.counters.as_dict()
        with self._cond:
            return {t: {
                "share": st.contract.share,
                "priority": st.contract.priority,
                "grants": st.grants,
                "inflight": st.inflight,
                "waiting": len(st.queue),
                "shed": groups.get(f"Tenant.{t}", {}).get("shed", 0),
                "throttled": groups.get(f"Tenant.{t}", {}).get(
                    "throttled", 0),
            } for t, st in self._states.items()}

class _DisabledPool:
    """The zero-cost default: no contracts configured, every slot is the
    shared null context."""

    enabled = False
    capacity = 0
    contracts: Dict[str, TenantContract] = {}

    def slot(self, tenant: Optional[str] = None, cost: float = 1.0,
             timeout_s: Optional[float] = None, on_wait=None):
        return _NULL

    def queue_depths(self) -> Dict[str, int]:
        return {}

    def stats(self) -> Dict[str, dict]:
        return {}


_DISABLED = _DisabledPool()
_POOL = _DISABLED
_POOL_LOCK = threading.Lock()


def pool():
    """The process arbiter (disabled, hence free, until configured)."""
    return _POOL


def configure(conf):
    """Arm the process arbiter from ``tenant.*`` conf keys; a no-op —
    and one props scan — when no ``tenant.<id>.share`` contract exists.
    Idempotent like the tracer: the first enabling conf wins (a driver,
    its jobs and a serving plane all call this with the same conf)."""
    global _POOL
    if _POOL.enabled:
        return _POOL
    contracts = contracts_from_conf(conf)
    if not contracts:
        return _POOL
    with _POOL_LOCK:
        if not _POOL.enabled:
            _POOL = GraftPool(
                contracts,
                capacity=conf.get_int("tenant.pool.concurrency", 1))
    return _POOL


def reset() -> None:
    """Drop the process arbiter (tests, run teardown)."""
    global _POOL
    with _POOL_LOCK:
        _POOL = _DISABLED
