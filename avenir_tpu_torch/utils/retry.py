"""Task retry and fault injection — port of ``avenir_tpu/utils/retry.py``
(all but ``FaultPlan`` and ``HeartbeatMonitor``, which wait for stream
durability).

The reference leaves failure handling to Hadoop, which re-runs a failed
map task on its input split up to ``mapred.map.max.attempts`` times
(resource/knn.properties:5-6 sets 2).  Here the unit of work is one chunk:
its read, parse and encode (``jobs/base.py::_iter_chunks_retrying``) re-run
from the chunk's byte offset, so a retry is idempotent.  The attempts,
failures and exhaustions are published as ``Task`` counters, as Hadoop
publishes task retries.

:class:`FaultInjector` raises on scheduled calls, so tests can show that a
transient fault is retried and a persistent one exhausts the policy.
"""

from __future__ import annotations

import logging
import random
import time
from dataclasses import dataclass
from typing import Callable, Iterable, List, Optional, Sequence, Tuple, TypeVar

from avenir_tpu_torch.utils.metrics import Counters

log = logging.getLogger(__name__)

T = TypeVar("T")
R = TypeVar("R")

# counter names (the observability channel, as Hadoop publishes task retries)
ATTEMPTS = ("Task", "attempts")
FAILURES = ("Task", "failed.attempts")
EXHAUSTED = ("Task", "exhausted")


@dataclass(frozen=True)
class RetryPolicy:
    """Chunk/task retry policy.

    ``max_attempts`` defaults to 2, the reference deployment's
    ``mapred.map.max.attempts`` value. ``backoff_s`` is the sleep before
    each re-attempt (0 for in-process compute retries; nonzero for I/O).
    ``retryable`` filters which exception types are retried — anything else
    propagates immediately (a schema error will not pass on attempt 2).

    ``jitter`` (default on, ``retry.jitter``): decorrelated jitter on the
    backoff, so replicas that failed on one shared resource re-arrive
    spread out.  Each sleep draws uniformly from ``[backoff_s,
    3·previous_sleep]``, capped at ``backoff_cap_s`` (default 16× base).
    Off, every sleep is ``backoff_s``.
    """

    max_attempts: int = 2
    backoff_s: float = 0.0
    retryable: Tuple[type, ...] = (Exception,)
    non_retryable: Tuple[type, ...] = ()
    jitter: bool = True
    backoff_cap_s: float = 0.0           # 0 = 16 × backoff_s
    # injectable uniform(a, b) draw — tests pin the distribution bounds
    # through it; random.uniform in production
    uniform: Callable[[float, float], float] = random.uniform

    @property
    def cap_s(self) -> float:
        # never below base: an inverted cap (cap < base) would silently
        # break the documented [base, cap] floor
        if self.backoff_cap_s > 0:
            return max(self.backoff_cap_s, self.backoff_s)
        return 16.0 * self.backoff_s

    def next_backoff(self, prev_sleep_s: float) -> float:
        """The sleep before the next attempt given the previous sleep
        (pass 0 before the first retry).  With jitter on:
        ``min(cap, uniform(base, 3·max(prev, base)))`` — the AWS
        "decorrelated jitter" recipe, bounded to ``[base, cap]``."""
        if self.backoff_s <= 0:
            return 0.0
        if not self.jitter:
            return self.backoff_s
        upper = 3.0 * max(prev_sleep_s, self.backoff_s)
        return min(self.cap_s, self.uniform(self.backoff_s, upper))

    @classmethod
    def from_conf(cls, conf) -> "RetryPolicy":
        """Read the reference's property name (``mapred.map.max.attempts``)
        with the framework name ``task.max.attempts`` as an alias.

        Deterministic configuration errors (:class:`ConfigError` — e.g. a
        schema too incomplete for streaming encode) are non-retryable: the
        same attempt would fail the same way, and wrapping the clear error
        in a TaskExhaustedError would bury it."""
        from avenir_tpu_torch.core.config import ConfigError

        attempts = int(conf.get("task.max.attempts",
                                conf.get("mapred.map.max.attempts", 2)))
        backoff = float(conf.get("task.retry.backoff.sec", 0.0))
        return cls(max_attempts=max(attempts, 1), backoff_s=backoff,
                   non_retryable=(ConfigError,),
                   jitter=conf.get_bool("retry.jitter", True),
                   backoff_cap_s=conf.get_float(
                       "task.retry.backoff.cap.sec", 0.0))


class TaskExhaustedError(RuntimeError):
    """A task failed on every attempt; carries the last underlying error."""

    def __init__(self, task: str, attempts: int, last: BaseException):
        super().__init__(
            f"task {task!r} failed after {attempts} attempts: {last!r}")
        self.task = task
        self.attempts = attempts
        self.last = last


def run_with_retry(fn: Callable[[], R], *, policy: RetryPolicy,
                   counters: Optional[Counters] = None,
                   task: str = "task") -> R:
    """Run ``fn`` under the retry policy; raises TaskExhaustedError after the
    final failed attempt. ``fn`` must be safe to re-run (pure, or idempotent
    against external state)."""
    last: Optional[BaseException] = None
    sleep_s = 0.0
    for attempt in range(1, policy.max_attempts + 1):
        if counters is not None:
            counters.increment(*ATTEMPTS)
        try:
            return fn()
        except policy.retryable as e:          # noqa: PERF203 — retry loop
            if isinstance(e, policy.non_retryable):
                raise                          # deterministic: fail fast
            last = e
            if counters is not None:
                counters.increment(*FAILURES)
            log.warning("task %s attempt %d/%d failed: %r",
                        task, attempt, policy.max_attempts, e)
            if attempt < policy.max_attempts and policy.backoff_s > 0:
                sleep_s = policy.next_backoff(sleep_s)
                time.sleep(sleep_s)
    if counters is not None:
        counters.increment(*EXHAUSTED)
    assert last is not None
    raise TaskExhaustedError(task, policy.max_attempts, last)


def process_chunks(chunks: Iterable[T], step: Callable[[T], R], *,
                   policy: Optional[RetryPolicy] = None,
                   counters: Optional[Counters] = None,
                   task: str = "chunk") -> List[R]:
    """Run ``step`` over each chunk with per-chunk retry — the MR task-retry
    analog (a failed map task re-runs on its split; a failed chunk step
    re-runs on its chunk). Returns the per-chunk results in order."""
    policy = policy or RetryPolicy()
    out: List[R] = []
    for i, chunk in enumerate(chunks):
        out.append(run_with_retry(
            lambda c=chunk: step(c), policy=policy, counters=counters,
            task=f"{task}[{i}]"))
    return out


class InjectedFault(RuntimeError):
    """Raised by FaultInjector on scheduled invocations."""


class FaultInjector:
    """Deterministic fault injection for tests and chaos drills.

    Wraps a callable; raises :class:`InjectedFault` on the 1-based
    invocation numbers in ``fail_on`` — the deterministic analog of a flaky
    worker. A single scheduled number models a transient fault (the retry
    then succeeds); consecutive numbers model a persistent fault that
    defeats an N-attempt policy.
    """

    def __init__(self, fn: Callable[..., R], fail_on: Sequence[int],
                 exc: Callable[[], BaseException] = lambda: InjectedFault("injected")):
        self._fn = fn
        self._fail_on = frozenset(fail_on)
        self._exc = exc
        self.calls = 0
        self.faults_fired = 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        if self.calls in self._fail_on:
            self.faults_fired += 1
            raise self._exc()
        return self._fn(*args, **kwargs)
