"""Typed serving-plane errors — port of ``avenir_tpu/serving/errors.py``,
all eight types (the tenant-scoped shed is raised by the tenancy arbiter
and a tenanted batcher's door; the worker-process error by the serving
fleet's router, ``serving/global_pool.py``).

Every failure mode a client can observe has its own type, so front ends map
them to distinct transport codes (HTTP status / RESP error tag) and callers
can retry intelligently: shed and timeout are load signals (retry elsewhere
or later), unknown-model and bad-request are permanent for that request.
"""

from __future__ import annotations


class ServingError(RuntimeError):
    """Base of every scoring-plane failure."""

    code = "ERR"


class UnknownModelError(ServingError):
    """Request names a model the registry never loaded."""

    code = "UNKNOWN_MODEL"


class ShedError(ServingError):
    """Queue-depth backpressure: the model's pending queue is full, the
    request was rejected at submit (never enqueued) — the scoring-plane
    analog of Storm's ``max.spout.pending`` refusing new tuples."""

    code = "SHED"


class TenantShedError(ShedError):
    """Tenant-scoped admission refusal (the tenancy arbiter's): the TENANT's
    contract fired — its queue share is full (``quota="queue.depth"``),
    its in-flight quota blocked past the deadline (``quota="deadline"``),
    or its serving door filled (``quota="serve.queue.depth"``) — so only
    THIS tenant's work is refused; every other tenant keeps its share of
    the pool.  Carries the attribution the client needs to back off
    intelligently: ``tenant``, ``quota`` (which contract limit fired) and
    ``retry_after_s`` (the shedding tenant's queue drain estimate — the
    HTTP frontend renders it as a ``Retry-After`` header)."""

    code = "TENANT_SHED"

    def __init__(self, message: str, tenant: str = "", quota: str = "",
                 retry_after_s: float = 0.0):
        super().__init__(message)
        self.tenant = tenant
        self.quota = quota
        self.retry_after_s = retry_after_s


class RequestTimeout(ServingError):
    """The request aged past ``serve.request.timeout.ms`` before a batch
    picked it up (sustained overload past what backpressure absorbs)."""

    code = "TIMEOUT"


class RequestError(ServingError):
    """The request payload itself is unservable (wrong column count,
    unknown sequence symbol, sequence longer than the padded length, ...)."""

    code = "BAD_REQUEST"


class ReplicaDownError(ServingError):
    """The replica holding this request died (injected kill, crashed
    dispatcher, missed heartbeat deadline) before the request scored.
    RETRYABLE by construction: a request only carries this error if its
    score never completed, so the pool may re-enqueue it on a survivor
    without risking a double score (``serving/pool.py`` failover)."""

    code = "REPLICA_DOWN"


class WorkerDownError(ReplicaDownError):
    """The multi-process pool's (``serving/global_pool.py``): the worker PROCESS
    holding this request died or stopped answering before a response
    landed — a refused/reset connection, or a worker-side 503 whose body
    carries the retryable ``REPLICA_DOWN`` code.  Subclasses
    :class:`ReplicaDownError` so the transport status (503) and the
    retryability contract are inherited: the router only raises this when
    no response arrived (or the worker itself vouched the request never
    scored), so a failover re-send cannot double-score.  ``worker`` names
    the process for client-side triage."""

    code = "WORKER_DOWN"

    def __init__(self, message: str, worker: str = ""):
        super().__init__(message)
        self.worker = worker
