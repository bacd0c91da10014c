"""Streaming serving loop — the Storm/Redis topology's counterpart; port
of ``avenir_tpu/pipeline/streaming.py``.

Capability parity with the reference's real-time path
(``reinforce/ReinforcementLearnerTopology.java`` builds RedisSpout →
shuffle → learner bolt :42-85; ``RedisSpout.java`` rpop's
``(eventID, roundNum)`` events :86-100; ``ReinforcementLearnerBolt.java``
drains the reward queue into ``learner.setReward`` then calls
``learner.nextActions(round)`` and writes to the action queue :93-125;
pluggable queue I/O via ``ActionWriter`` / ``RewardReader`` interfaces with
Redis impls — lpush actions ``RedisActionWriter.java:46-49``, lindex walk of
the reward list ``RedisRewardReader.java:72-86``).

The topology collapses into an in-process event loop around the learner
(``models/online_rl.py``, on the host by design) — the queue abstraction
survives (bounded in-process deques for tests and embedding; Redis
transports over the package's stdlib RESP client, ``pipeline/resp.py``,
for drop-in use against the reference's own simulators — no external
redis package).  Learner state is checkpointable between events.  A fleet
of groups runs on threads (:class:`ShardedServingFleet`) or forked
processes (:class:`ProcessServingFleet`).
"""

from __future__ import annotations

import json
import time
from collections import deque
from typing import Callable, Iterable, List, Optional, Protocol, Tuple

from avenir_tpu_torch.models.online_rl import ReinforcementLearner
from avenir_tpu_torch.utils.metrics import Counters, LatencyTracker, serving_stats


# ---------------------------------------------------------------------------
# queue transports
# ---------------------------------------------------------------------------

class QueueFullError(RuntimeError):
    """Typed backpressure: a push against a bounded queue at its depth cap.

    The in-proc analog of the scoring plane's ShedError — load is rejected
    at the door with a type the producer can catch (drop, block, or shed
    upstream), instead of the queue growing without bound until the process
    OOMs mid-stream."""


class InProcQueue:
    """Deque-backed FIFO with the push/pop surface the Redis impls use.

    Bounded: ``depth`` (``stream.queue.depth``, default 65536) caps the
    backlog; a push past the cap raises :class:`QueueFullError`.
    ``depth=0`` disables the cap — only for tests that model an external
    broker's durability, never for a production in-proc hop."""

    DEFAULT_DEPTH = 65536

    def __init__(self, depth: int = DEFAULT_DEPTH):
        self._q = deque()
        self.depth = max(int(depth), 0)

    def push(self, msg: str) -> None:
        # len+appendleft is not atomic across threads, so a concurrent
        # producer pair can land at depth+1 — the cap bounds GROWTH (its
        # job), it is not an exact high-water mark
        if self.depth and len(self._q) >= self.depth:
            raise QueueFullError(
                f"in-proc queue at depth cap {self.depth} — consumer is "
                f"not keeping up; shed, block, or raise stream.queue.depth")
        self._q.appendleft(msg)

    def push_all(self, msgs: Iterable[str]) -> None:
        """All-or-nothing batch push: either every message is enqueued or
        none is (:class:`QueueFullError`).  Same growth-bound (not exact
        high-water) concurrency caveat as :meth:`push`."""
        batch = list(msgs)
        if self.depth and len(self._q) + len(batch) > self.depth:
            raise QueueFullError(
                f"in-proc queue cannot take {len(batch)} messages within "
                f"depth cap {self.depth} — consumer is not keeping up; "
                f"shed, block, or raise stream.queue.depth")
        for m in batch:
            self._q.appendleft(m)

    def pop(self) -> Optional[str]:
        return self._q.pop() if self._q else None

    def drain(self) -> List[str]:
        # pop-loop, not snapshot+clear: a concurrent push landing between a
        # snapshot and the clear would be silently lost (deque.pop/append
        # are individually atomic, so this drains every element exactly
        # once even with a producer on another thread)
        out: List[str] = []
        while True:
            try:
                out.append(self._q.pop())
            except IndexError:
                return out

    def __len__(self) -> int:
        return len(self._q)


class EventSource(Protocol):
    def next_event(self) -> Optional[Tuple[str, int]]: ...


class RewardReader(Protocol):
    def read_rewards(self) -> List[Tuple[str, float]]: ...


class ActionWriter(Protocol):
    def write(self, event_id: str, actions: List[str]) -> None: ...


class QueueEventSource:
    """Events are ``eventID,roundNum`` lines (RedisSpout.java:86-100)."""

    def __init__(self, queue: InProcQueue, delim: str = ","):
        self.queue = queue
        self.delim = delim

    def next_event(self) -> Optional[Tuple[str, int]]:
        msg = self.queue.pop()
        if msg is None:
            return None
        event_id, _, round_num = msg.partition(self.delim)
        return event_id, int(round_num)


class QueueRewardReader:
    """Rewards are ``action,reward`` lines."""

    def __init__(self, queue: InProcQueue, delim: str = ","):
        self.queue = queue
        self.delim = delim

    def read_rewards(self) -> List[Tuple[str, float]]:
        out = []
        for msg in self.queue.drain():
            action, _, reward = msg.partition(self.delim)
            out.append((action, float(reward)))
        return out


class QueueActionWriter:
    """Actions are written as ``eventID,action`` (RedisActionWriter.java:46-49)."""

    def __init__(self, queue: InProcQueue, delim: str = ","):
        self.queue = queue
        self.delim = delim

    def write(self, event_id: str, actions: List[str]) -> None:
        msgs = [f"{event_id}{self.delim}{a}" for a in actions]
        push_all = getattr(self.queue, "push_all", None)
        if push_all is not None:
            # all-or-nothing on bounded queues: the serving loop's shed
            # path treats QueueFullError as "this event's actions dropped",
            # so a multi-action selection must never publish a partial set
            push_all(msgs)
        else:
            # uncapped broker transports (Redis LPUSH) never shed
            for m in msgs:
                self.queue.push(m)


# Redis transports — the reference's spout/reader/writer contract
# (RedisSpout.java rpop events; RedisActionWriter.java lpush actions;
# RedisRewardReader.java reward-list reads) over the package's stdlib RESP
# client (pipeline/resp.py). Rewards are consumed destructively (rpop
# drain), matching the serving loop's read-once semantics; the reference's
# non-destructive lindex walk with a running offset is equivalent for a
# single reader.

def _redis_queue(queue, host, port, db):
    from avenir_tpu_torch.pipeline.resp import RedisListQueue
    return RedisListQueue(queue, host=host, port=port, db=db)


class RedisEventSource(QueueEventSource):
    def __init__(self, host="localhost", port=6379, db=0, queue="eventQueue", delim=","):
        super().__init__(_redis_queue(queue, host, port, db), delim=delim)


class RedisRewardReader(QueueRewardReader):
    def __init__(self, host="localhost", port=6379, db=0, queue="rewardQueue", delim=","):
        super().__init__(_redis_queue(queue, host, port, db), delim=delim)


class RedisActionWriter(QueueActionWriter):
    def __init__(self, host="localhost", port=6379, db=0, queue="actionQueue", delim=","):
        super().__init__(_redis_queue(queue, host, port, db), delim=delim)


# ---------------------------------------------------------------------------
# the serving loop (the bolt, minus Storm)
# ---------------------------------------------------------------------------

class ReinforcementLearnerServer:
    """Per event: drain rewards → update learner → emit next actions
    (ReinforcementLearnerBolt.java:93-125).

    Observability is the JAX package's serving schema: a
    ``Serving.<model_name>`` counter group plus a :class:`LatencyTracker`,
    published through :meth:`stats` (``utils/metrics.serving_stats``).  The
    RL loop
    dispatches one event at a time, so its whole size histogram lands in
    ``bucket.1``.  Pass shared ``counters``/``latency`` objects to
    aggregate several servers (e.g. a fleet's per-group learners) into one
    report.
    """

    def __init__(
        self,
        learner: ReinforcementLearner,
        events: EventSource,
        rewards: RewardReader,
        actions: ActionWriter,
        log_interval: int = 0,
        on_log: Optional[Callable[[int], None]] = None,
        counters: Optional[Counters] = None,
        latency: Optional[LatencyTracker] = None,
        model_name: str = "rl",
    ):
        self.learner = learner
        self.events = events
        self.rewards = rewards
        self.actions = actions
        self.log_interval = log_interval
        self.on_log = on_log
        self.processed = 0
        self.model_name = model_name
        self.counters = counters if counters is not None else Counters()
        self.latency = latency if latency is not None else LatencyTracker()

    def handle(self, event_id: str, round_num: int) -> None:
        """The per-event body (drain rewards → update → emit actions) —
        shared by :meth:`process_one` and the ShardedServingFleet workers."""
        t0 = time.monotonic()
        for action, reward in self.rewards.read_rewards():
            self.learner.set_reward(action, reward)
        selected = self.learner.next_actions(round_num)
        try:
            self.actions.write(event_id, selected)
        except QueueFullError:
            # bounded action queue + lagging consumer: SHED this event's
            # actions (counted) and keep serving — the deployed
            # ``replay.failed.message=false`` drop semantics; the learner
            # update above already happened, and dying mid-serve or
            # growing the queue without bound are both worse
            self.counters.increment(f"Serving.{self.model_name}", "shed")
        self.processed += 1
        self.latency.record(time.monotonic() - t0)
        group = f"Serving.{self.model_name}"
        self.counters.increment(group, "requests")
        self.counters.increment(group, "batches")
        self.counters.increment(group, "bucket.1")
        if self.log_interval and self.on_log and self.processed % self.log_interval == 0:
            self.on_log(self.processed)

    def stats(self) -> dict:
        """The scoring plane's stats schema (utils/metrics.serving_stats)."""
        return serving_stats(self.counters, {self.model_name: self.latency})

    def process_one(self) -> bool:
        """Handle one event; False when the event queue is empty."""
        ev = self.events.next_event()
        if ev is None:
            return False
        self.handle(*ev)
        return True

    def run(self, max_events: Optional[int] = None) -> int:
        n = 0
        while max_events is None or n < max_events:
            if not self.process_one():
                break
            n += 1
        return n

    # -- learner-state checkpointing ----------------------------------------
    def checkpoint(self) -> str:
        return json.dumps(self.learner.get_state())

    def restore(self, blob: str) -> None:
        self.learner.set_state(json.loads(blob))


# ---------------------------------------------------------------------------
# parallel serving — the Storm executor-scaling analog
# ---------------------------------------------------------------------------

class ShardedServingFleet:
    """Multi-worker event dispatch with per-group learner state — the
    capacity analog of Storm's topology scaling
    (ReinforcementLearnerTopology.java:42-85: ``num.bolt.threads`` bolt
    executors fed by a shuffle, ``num.workers`` JVMs, ``max.spout.pending``
    backpressure).

    Events carry a group key (the reference reaches the same effect with
    one topology per engagement group); ``hash(group) % num_workers`` pins
    every group to one worker — Storm's fieldsGrouping — so each learner
    updates single-threaded (no lock on the hot path) while distinct groups
    process concurrently. Each worker owns the servers for its groups,
    created on first event via ``server_factory(group)``. A bounded
    per-worker queue (``max_pending``) applies backpressure to the
    dispatcher exactly like ``max.spout.pending`` caps in-flight tuples.

    ``dispatch`` blocks when the target worker's queue is full; ``close``
    drains and joins the workers. Results (event_id → actions) flow through
    each server's own ActionWriter, so any transport (in-proc, Redis)
    works unchanged.
    """

    def __init__(self, server_factory: Callable[[str], "ReinforcementLearnerServer"],
                 num_workers: int = 2, max_pending: int = 128):
        import queue as _qmod
        import threading

        self.server_factory = server_factory
        self.num_workers = max(num_workers, 1)
        self._queues = [_qmod.Queue(maxsize=max(max_pending, 1))
                        for _ in range(self.num_workers)]
        self._servers: List[dict] = [{} for _ in range(self.num_workers)]
        self._errors: List[BaseException] = []
        self._closed = False
        self._threads = []
        for w in range(self.num_workers):
            t = threading.Thread(target=self._work, args=(w,), daemon=True)
            t.start()
            self._threads.append(t)

    @property
    def processed(self) -> int:
        """Events handled across all workers — summed from the per-server
        counters each worker owns alone, so the hot path stays lock-free."""
        return sum(srv.processed for servers in self._servers
                   for srv in servers.values())

    def _work(self, w: int) -> None:
        q = self._queues[w]
        servers = self._servers[w]
        while True:
            item = q.get()
            if item is None:
                return
            group, event_id, round_num = item
            try:
                srv = servers.get(group)
                if srv is None:
                    srv = servers[group] = self.server_factory(group)
                srv.handle(event_id, round_num)
            except BaseException as e:       # surfaced on close()
                self._errors.append(e)

    def dispatch(self, group: str, event_id: str, round_num: int) -> None:
        """Route one event to its group's worker (blocks on backpressure)."""
        if self._closed:
            # a dispatch after close() would silently enqueue to a dead
            # worker and, once the bounded queue fills, block forever
            raise RuntimeError("dispatch() after close()")
        self._queues[hash(group) % self.num_workers].put(
            (group, event_id, round_num))

    def close(self) -> None:
        """Flush queues, stop workers, re-raise the first worker error."""
        self._closed = True
        for q in self._queues:
            q.put(None)
        for t in self._threads:
            t.join()
        if self._errors:
            raise self._errors[0]

    def checkpoints(self) -> dict:
        """group → learner-state JSON for every group across workers (call
        after close(), or accept in-flight staleness)."""
        out = {}
        for servers in self._servers:
            for group, srv in servers.items():
                out[group] = srv.checkpoint()
        return out


# ---------------------------------------------------------------------------
# process-backed serving — the Storm num.workers (multi-JVM) analog
# ---------------------------------------------------------------------------

class _ForwardingActionWriter:
    """Tees a server's action writes to the parent's result queue (the
    caller-provided transport still runs in the worker — a Redis writer's
    effects are globally visible; an in-proc queue's are not, which is why
    the parent needs the forwarded copy)."""

    def __init__(self, inner, group: str, out_q):
        self.inner = inner
        self.group = group
        self.out_q = out_q

    def write(self, event_id: str, actions: List[str]) -> None:
        self.inner.write(event_id, actions)
        self.out_q.put(("act", self.group, event_id, list(actions)))


def _fleet_worker(worker_id: int, server_factory, in_q, out_q) -> None:
    servers: dict = {}
    while True:
        item = in_q.get()
        if item is None:
            out_q.put(("ckpt", worker_id,
                       [(g, srv.checkpoint()) for g, srv in servers.items()]))
            return
        group, event_id, round_num = item
        try:
            srv = servers.get(group)
            if srv is None:
                srv = servers[group] = server_factory(group)
                srv.actions = _ForwardingActionWriter(srv.actions, group,
                                                      out_q)
            srv.handle(event_id, round_num)
        except BaseException as e:     # surfaced on close()
            out_q.put(("err", worker_id, repr(e)))


class ProcessServingFleet:
    """Multi-PROCESS event dispatch with per-group learner state — the
    capacity analog of Storm's ``num.workers`` (one JVM per worker,
    ReinforcementLearnerTopology.java:42-85), where
    :class:`ShardedServingFleet` mirrors ``num.bolt.threads`` (executors
    inside one JVM).

    Same contract as the thread fleet: ``hash(group) % num_workers`` pins
    each group to one worker (fieldsGrouping — learners update
    single-threaded), bounded per-worker queues apply ``max.spout.pending``
    backpressure, ``close()`` drains and re-raises the first worker error.
    Because workers are processes, CPU-bound learner updates scale past the
    GIL on multi-core hosts (thread workers cannot).

    Process-boundary additions:
    - action writes are forwarded to the parent (``actions()`` after
      ``close()`` — per-group streams in dispatch order); the factory's own
      transport still runs in the worker, so Redis-backed writers behave
      exactly as in the thread fleet;
    - learner state is collected at shutdown (``checkpoints()``), matching
      the thread fleet's post-close semantics;
    - ``server_factory`` is transferred via fork at worker start, so it may
      be a closure; workers are started eagerly in ``__init__``.  The
      learners run on the host by design and the workers never touch CUDA;
      a forked child that does fails loudly in torch ("Cannot re-initialize
      CUDA in forked subprocess") once the parent has initialised CUDA —
      nothing re-routes it.
    """

    def __init__(self, server_factory: Callable[[str], ReinforcementLearnerServer],
                 num_workers: int = 2, max_pending: int = 128,
                 mp_context: str = "fork"):
        import multiprocessing as mp

        ctx = mp.get_context(mp_context)
        self.num_workers = max(num_workers, 1)
        self._in_qs = [ctx.Queue(maxsize=max(max_pending, 1))
                       for _ in range(self.num_workers)]
        self._out_q = ctx.Queue()
        self._procs = [
            ctx.Process(target=_fleet_worker,
                        args=(w, server_factory, self._in_qs[w], self._out_q),
                        daemon=True)
            for w in range(self.num_workers)
        ]
        for p in self._procs:
            p.start()
        self._closed = False
        self._actions: List[Tuple[str, str, List[str]]] = []
        self._checkpoints: dict = {}
        self._errors: List[str] = []
        self.dispatched = 0

    def dispatch(self, group: str, event_id: str, round_num: int) -> None:
        """Route one event to its group's worker (blocks on backpressure)."""
        import queue as _qmod

        if self._closed:
            raise RuntimeError("dispatch() after close()")
        w = hash(group) % self.num_workers
        while True:
            try:
                self._in_qs[w].put((group, event_id, round_num), timeout=1.0)
                break
            except _qmod.Full:
                # backpressure against a DEAD worker would block forever
                if not self._procs[w].is_alive():
                    raise RuntimeError(
                        f"serving worker {w} died (exitcode "
                        f"{self._procs[w].exitcode}); queue full")
        self.dispatched += 1

    def _drain_out(self, expect_ckpts: int, deadline: float = 60.0) -> None:
        import queue as _qmod
        import time as _time

        remaining = expect_ckpts
        t_end = _time.monotonic() + deadline
        empty_after_dead = 0
        while remaining:
            try:
                kind, *rest = self._out_q.get(timeout=1.0)
            except _qmod.Empty:
                # a worker killed without sending its ckpt (OOM, segfault in
                # native code) must not hang close() on a get() that can
                # never be satisfied
                dead = sum(1 for p in self._procs if not p.is_alive())
                if dead >= remaining:
                    # a just-exited worker's queue feeder thread may still be
                    # flushing its ckpt/act payload into the pipe, so require
                    # several consecutive empty polls before declaring the
                    # handshake lost (each get() above already waited 1 s)
                    empty_after_dead += 1
                    if empty_after_dead >= 3:
                        self._errors.append(
                            f"{dead} serving worker(s) died without shutdown "
                            f"handshake (exitcodes "
                            f"{[p.exitcode for p in self._procs]})")
                        return
                else:
                    # live-but-wedged worker (hung in handle()): bound the
                    # IDLE time so close() terminates it instead of hanging —
                    # t_end resets on every received message, so a fleet
                    # draining a deep backlog slowly but steadily never trips
                    if _time.monotonic() > t_end:
                        self._errors.append(
                            f"{remaining} serving worker(s) idle without "
                            f"shutdown handshake for {deadline:.0f}s "
                            f"(wedged in handle()?); terminating")
                        return
                continue
            empty_after_dead = 0
            t_end = _time.monotonic() + deadline
            if kind == "act":
                group, event_id, actions = rest
                self._actions.append((group, event_id, actions))
            elif kind == "err":
                self._errors.append(rest[1])
            elif kind == "ckpt":
                for group, blob in rest[1]:
                    self._checkpoints[group] = blob
                remaining -= 1

    def close(self) -> None:
        """Flush queues, stop workers, re-raise the first worker error."""
        import queue as _qmod

        if self._closed:
            return
        self._closed = True
        import time as _time
        for w, q in enumerate(self._in_qs):
            t_end = _time.monotonic() + 30.0     # per-worker budget
            while True:
                try:
                    q.put(None, timeout=1.0)
                    break
                except _qmod.Full:
                    if not self._procs[w].is_alive():
                        break          # dead worker: nothing to hand-shake
                    if _time.monotonic() > t_end:
                        # wedged worker holding a full queue: give up on the
                        # sentinel, let the drain deadline + terminate below
                        # reclaim it (DeviceFeeder.close bounds the same way)
                        self._errors.append(
                            f"serving worker {w} input queue still full at "
                            f"close deadline; skipping shutdown sentinel")
                        break
        self._drain_out(expect_ckpts=self.num_workers)
        for p in self._procs:
            p.join(timeout=30.0)
            if p.is_alive():           # wedged worker: don't hang close()
                p.terminate()
        if self._errors:
            raise RuntimeError(f"serving worker failed: {self._errors[0]}")

    def actions(self) -> List[Tuple[str, str, List[str]]]:
        """(group, event_id, actions) in per-group dispatch order (call
        after close())."""
        return list(self._actions)

    def checkpoints(self) -> dict:
        """group → learner-state JSON collected at worker shutdown (call
        after close())."""
        return dict(self._checkpoints)


# ---------------------------------------------------------------------------
# supervision — the Storm worker-restart analog
# ---------------------------------------------------------------------------

class ServerSupervisor:
    """Failure detection + elastic restart for the serving loop.

    Storm restarts a crashed bolt worker but the reference's learner state is
    per-bolt-instance in-memory and unreplicated, so a restart loses it
    (SURVEY.md §3.5); replay of the in-flight message is governed by
    ``replay.failed.message`` (the spout's fail hook is stubbed empty,
    RedisSpout.java:103-106). Here the supervisor owns both halves properly:

    - learner state is checkpointed every ``checkpoint_interval`` events and
      restored into a fresh learner on restart (no state loss);
    - a persistent crash loop is detected and surfaced after
      ``max_restarts`` crashes *within one unstable window*: sustained
      progress (``restart_reset_after`` consecutive events since the last
      crash) resets the budget, so sporadic transient faults spread over a
      long-lived loop never masquerade as a crash loop (elastic recovery,
      not infinite flapping);
    - the failed event itself is dropped, matching the deployed
      ``replay.failed.message=false`` semantics — queue transports hand an
      event over exactly once, so replay would need producer cooperation.

    ``server_factory`` builds a fresh server (learner + queue bindings);
    the supervisor restores the last checkpoint into it before resuming,
    journaling ``checkpoint.save`` / ``checkpoint.restore`` /
    ``server.restart`` as the JAX package does (with tracing on).
    """

    def __init__(self, server_factory: Callable[[], ReinforcementLearnerServer],
                 checkpoint_interval: int = 64, max_restarts: int = 3,
                 restart_reset_after: int = 1000):
        self.server_factory = server_factory
        self.checkpoint_interval = max(checkpoint_interval, 1)
        self.max_restarts = max_restarts
        self.restart_reset_after = max(restart_reset_after, 1)
        self.restarts = 0
        self.events_processed = 0
        self.last_checkpoint: Optional[str] = None
        self._server: Optional[ReinforcementLearnerServer] = None
        self._events_since_crash = 0

    @property
    def server(self) -> ReinforcementLearnerServer:
        if self._server is None:
            self._server = self.server_factory()
            if self.last_checkpoint is not None:
                self._server.restore(self.last_checkpoint)
                from avenir_tpu_torch.telemetry import spans as tel

                tel.tracer().event("checkpoint.restore", scope="rl",
                                   events=self.events_processed)
        return self._server

    def run(self, max_events: Optional[int] = None) -> int:
        """Drive the serving loop to queue exhaustion (or ``max_events``),
        restarting from the last checkpoint on crashes. Returns events
        processed across all incarnations; raises the last error once
        ``max_restarts`` is exceeded (crash-loop detection)."""
        done = 0
        while max_events is None or done < max_events:
            srv = self.server
            try:
                if not srv.process_one():
                    break
                done += 1
                self.events_processed += 1
                self._events_since_crash += 1
                if self._events_since_crash >= self.restart_reset_after:
                    self.restarts = 0      # stable again: refill the budget
                if self.events_processed % self.checkpoint_interval == 0:
                    self.last_checkpoint = srv.checkpoint()
                    from avenir_tpu_torch.telemetry import spans as tel

                    tel.tracer().event("checkpoint.save", scope="rl",
                                       events=self.events_processed)
            except Exception as exc:
                self.restarts += 1
                self._events_since_crash = 0
                self._server = None        # next access builds + restores
                from avenir_tpu_torch.telemetry import spans as tel

                tel.tracer().event("server.restart", scope="rl",
                                   restarts=self.restarts,
                                   error=type(exc).__name__)
                if self.restarts > self.max_restarts:
                    raise
        # final checkpoint so a subsequent supervisor resumes precisely
        if self._server is not None:
            self.last_checkpoint = self._server.checkpoint()
        return done
