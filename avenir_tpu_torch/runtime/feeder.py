"""Device feeder — chunk i+1 read, encoded and copied to the card while
chunk i is counted; port of ``avenir_tpu/runtime/feeder.py`` (without its
sharded stage).

A worker thread pulls the source (whose lazy readers do the parse and
encode), stages each item, and hands it over through a bounded queue of
``depth`` items.  On ``cuda`` the default stage copies each array from
pinned host memory with ``non_blocking=True`` on a stream of the feeder's
own and records an event; the consumer's stream waits on that event before
it reads the chunk, and each staged tensor is marked as used on the
consumer's stream (``record_stream``), so the caching allocator cannot hand
its memory to a later chunk while the consumer's work is queued.  Without
the pinned source the copy would run synchronously, and without the side
stream it would queue behind the counts.  On ``cpu`` the stage is the
identity.

With tracing on, each staged item is a retroactive ``feeder.stage`` span
(the source pull, where the lazy readers parse and encode, plus the copy,
waited for), parented to the span current where the feeder was built;
under ``profile.on`` each stage samples the device's memory.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
import weakref
from typing import Callable, Iterable, Iterator, Optional, TypeVar

import numpy as np
import torch

from avenir_tpu_torch.core.encoding import EncodedDataset
from avenir_tpu_torch.device import resolve_device

T = TypeVar("T")

_SENTINEL = object()


def _put_guarded(q: "queue.Queue", stop: threading.Event, item) -> bool:
    """Bounded put that gives up when the consumer is gone."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            continue
    return False


def _produce(it: Iterator, stage: Callable, q: "queue.Queue",
             stop: threading.Event, err_box: dict,
             device: torch.device) -> None:
    try:
        if device.type == "cuda":
            torch.cuda.set_device(device)
        for item in it:
            if stop.is_set():
                return
            if not _put_guarded(q, stop, stage(item)):
                return
    except BaseException as e:         # propagate to the consumer
        err_box["err"] = e
    finally:
        _put_guarded(q, stop, _SENTINEL)


def _indexed(device) -> torch.device:
    """``device`` with its index: a bare ``cuda`` is the current device,
    which the worker thread must select explicitly."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def map_arrays(item, fn):
    """``item`` with ``fn`` applied to each numeric array in it: an
    EncodedDataset's codes, cont and labels (ids stay on the host), the
    members of a tuple or list, or the item itself."""
    if isinstance(item, EncodedDataset):
        return dataclasses.replace(
            item, codes=fn(item.codes), cont=fn(item.cont),
            labels=None if item.labels is None else fn(item.labels))
    if isinstance(item, (tuple, list)):
        return type(item)(map_arrays(x, fn) for x in item)
    if isinstance(item, torch.Tensor) or (
            isinstance(item, np.ndarray) and item.dtype.kind in "biuf"):
        return fn(item)
    return item


@dataclasses.dataclass
class Staged:
    """An item the cuda stage copied, and the event its copies end at."""
    item: object
    event: torch.cuda.Event


class CudaStage:
    """The default stage on a CUDA device: each array copied from pinned
    host memory on the feeder's own stream, then an event recorded there.
    The numpy source is copied into pinned memory first, so the caller may
    overwrite its buffer as soon as the stage returns."""

    def __init__(self, device: torch.device):
        self.device = _indexed(device)
        self.stream = torch.cuda.Stream(self.device)

    def _copy(self, x) -> torch.Tensor:
        src = x if isinstance(x, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(x))
        if src.device.type == "cpu":
            src = src.pin_memory()
        return src.to(self.device, non_blocking=True)

    def __call__(self, item) -> Staged:
        with torch.cuda.stream(self.stream):
            staged = map_arrays(item, self._copy)
            event = torch.cuda.Event()
            event.record(self.stream)
        return Staged(staged, event)


def _identity(item):
    return item


def _traced_pipeline(source, stage, device: torch.device):
    """(source, stage) wrapped for telemetry, or returned as they are when
    tracing and profiling are off (no wrapper frame on the hot path).

    With tracing on, each item is a retroactive ``feeder.stage`` span
    covering the source pull and the stage, with the staged copies
    waited for before the close (the copy is asynchronous: an unsynced
    span would time the enqueue).  The worker thread never holds the
    consumer's context, so the parent is captured here, on the
    constructing thread.  Pull and stage run one after the other on the
    one worker thread, so the shared time box needs no lock.  Under
    ``profile.on`` the stage also samples ``device``'s memory."""
    from avenir_tpu_torch.telemetry import profile as _profile
    from avenir_tpu_torch.telemetry import spans as tel

    tracer = tel.tracer()
    prof = _profile.profiler()
    if not tracer.enabled and not prof.enabled:
        return source, stage
    inner = stage or _identity
    if not tracer.enabled:
        def profiled_stage(item):
            out = inner(item)
            prof.sample_device_memory("feeder", [device])
            return out

        return source, profiled_stage
    parent = tracer.current()
    box = {"t0": None, "chunk": 0}

    def timed_source():
        it = iter(source)
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            box["t0"] = t0
            yield item

    def traced_stage(item):
        out = inner(item)
        if isinstance(out, Staged):
            out.event.synchronize()
        t0 = box["t0"] if box["t0"] is not None else time.perf_counter()
        box["t0"] = None
        tracer.emit_span("feeder.stage", time.perf_counter() - t0,
                         parent=parent, attrs={"chunk": box["chunk"]})
        box["chunk"] += 1
        if prof.enabled:
            prof.sample_device_memory("feeder", [device])
        return out

    return timed_source(), traced_stage


def _tensors(item):
    """The tensors of a staged item."""
    found = []
    map_arrays(item, found.append)
    return found


class DeviceFeeder:
    """Prefetching iterator: pulls from ``source`` on a worker thread,
    applies ``stage`` (default: :class:`CudaStage` on ``cuda``, the
    identity on ``cpu``), and hands off through a bounded queue (``depth``
    items in flight).  ``device`` is ``cuda`` unless the caller asks for
    the CPU.

    Abandoning the iterator mid-stream (the consumer raised, dropped the
    feeder, or called :meth:`close`) stops the worker, and staged items are
    dropped rather than kept for the life of the process."""

    def __init__(self, source: Iterable[T], depth: int = 2,
                 stage: Optional[Callable[[T], T]] = None, device=None):
        self.device = _indexed(resolve_device(device))
        if stage is None and self.device.type == "cuda":
            stage = CudaStage(self.device)
        source, stage = _traced_pipeline(source, stage, self.device)
        self._q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
        self._err_box: dict = {}
        self._stop = threading.Event()
        self._done = False
        # the worker holds no reference to self, so the finalizer below can
        # fire while it runs; the finalizer must not reference self either
        self._thread = threading.Thread(
            target=_produce,
            args=(iter(source), stage or _identity, self._q,
                  self._stop, self._err_box, self.device),
            daemon=True)
        self._finalizer = weakref.finalize(self, self._stop.set)
        self._thread.start()

    def close(self) -> None:
        """Stop the worker and drop any staged-but-unconsumed items."""
        self._stop.set()
        self._done = True
        self._drain()
        # a put blocked past its stop check can still land one item after
        # the first drain; once the worker has exited nothing else can be
        # enqueued, so join-then-drain makes the drop reliable.  A worker
        # wedged in a copy is polled for at most 60 s, then left: it is a
        # daemon thread, so at worst one staged item lives until exit.
        self._thread.join(timeout=10.0)
        self._drain()
        deadline = time.monotonic() + 60.0
        while self._thread.is_alive() and time.monotonic() < deadline:
            self._thread.join(timeout=1.0)
            self._drain()
        if self._thread.is_alive():
            import logging
            logging.getLogger("avenir_tpu_torch").warning(
                "DeviceFeeder worker still alive 60s after close(); "
                "up to one staged item may stay until exit")

    def _drain(self) -> None:
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        item = self._q.get()
        if item is _SENTINEL:
            self._done = True
            self._thread.join()
            err = self._err_box.pop("err", None)
            if err is not None:
                raise err
            raise StopIteration
        if isinstance(item, Staged):
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(item.event)
            for t in _tensors(item.item):
                t.record_stream(stream)
            item = item.item
        return item


def prefetch_encoded(path: str, encoder, ncols: int, delim: str = ",",
                     chunk_bytes: int = 64 << 20, with_labels: bool = True,
                     depth: int = 2, device=None) -> DeviceFeeder:
    """Native-parse a CSV file in chunks of about ``chunk_bytes`` and stage
    each EncodedDataset's arrays on ``device``."""
    from avenir_tpu_torch.runtime import native

    source = native.iter_encoded_native(
        path, encoder, ncols, delim=delim, chunk_bytes=chunk_bytes,
        with_labels=with_labels)
    return DeviceFeeder(source, depth=depth, device=device)
