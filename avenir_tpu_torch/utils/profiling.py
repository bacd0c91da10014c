"""Tracing and timing hooks; port of ``avenir_tpu/utils/profiling.py``.

- :func:`device_sync` waits for the CUDA work behind a value's tensors
  (the JAX package's host fetch of one scalar per shard).
- :func:`trace` records a device trace of a region with
  ``torch.profiler`` where the JAX package runs ``jax.profiler``: a Chrome
  trace ``<log_dir>/<stamp>.pt.trace.json`` (CPU activity, plus CUDA
  kernels and copies when the region runs on a CUDA device) in place of
  XProf's ``<log_dir>/plugins/profile/<stamp>/*.xplane.pb``.  Open it in
  ``chrome://tracing`` or Perfetto.  The whole region is one range named
  for ``log_dir``'s last component (the pipeline's stage name), and
  :func:`region` marks ranges inside it (``scan``), so a reader can take
  the device's busy share of either window.
- :class:`StepTimer` keeps per-step walls with percentile summaries,
  synchronized on the step's device output.
- :func:`get_logger` honours the reference's per-job ``debug.on`` flag.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Dict, List, Optional

import torch


def _leaves(value):
    """The tensors in a value: a tensor, or the members of a tuple, list
    or dict (recursively), or the array fields of an EncodedDataset."""
    if isinstance(value, torch.Tensor):
        yield value
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _leaves(v)
    elif isinstance(value, dict):
        for v in value.values():
            yield from _leaves(v)
    elif hasattr(value, "codes") and hasattr(value, "labels"):
        for v in (value.codes, value.labels, getattr(value, "cont", None)):
            yield from _leaves(v)


def device_sync(value):
    """Wait for the device work behind ``value``: one
    ``torch.cuda.synchronize`` for each CUDA device among the tensors in
    its leaves; CPU tensors and other values need no wait.  Returns
    ``value`` unchanged."""
    devices = {t.device for t in _leaves(value) if t.is_cuda}
    for dev in sorted(devices, key=lambda d: d.index or 0):
        torch.cuda.synchronize(dev)
    return value


def region(name: str):
    """A named range in the trace of an open :func:`trace` (a
    ``torch.profiler.record_function``); with no profiler running, a null
    context — one check, no allocation."""
    if not torch.autograd._profiler_enabled():
        return _NULL
    return torch.profiler.record_function(name)


_NULL = contextlib.nullcontext()


@contextlib.contextmanager
def trace(log_dir: Optional[str], device=None):
    """Record ``torch.profiler`` activity of the region into a Chrome trace
    ``<log_dir>/<stamp>.pt.trace.json`` (no-op when ``log_dir`` is None),
    the region being one range named ``basename(log_dir)``.  CUDA activity
    is recorded when CUDA is available and ``device`` is a CUDA device (or
    None); the region's CUDA work is synchronized before the range and
    the trace stop, so every kernel it launched is in both."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available() and (
        device is None or torch.device(device).type == "cuda")
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    stamp = time.strftime("%Y_%m_%d_%H_%M_%S") + f".{os.getpid()}"
    label = os.path.basename(os.path.normpath(log_dir))
    with profile(activities=activities) as prof, record_function(label):
        try:
            yield
        finally:
            if cuda:
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, f"{stamp}.pt.trace.json"))


class StepTimer:
    """Wall-clock step timing with device synchronization.

    Register the step's device output via :meth:`block_on` — CUDA
    launches are asynchronous, so without it the recorded time would
    cover only the launch, not the step::

        timer = StepTimer()
        with timer.step("fit") as t:
            out = t.block_on(step_fn(batch))   # synced at step exit
        timer.summary()["fit"]["p50_ms"]
    """

    def __init__(self):
        self.samples: Dict[str, List[float]] = {}
        self._pending = None

    @contextlib.contextmanager
    def step(self, name: str):
        start = time.perf_counter()
        self._pending = None
        yield self
        if self._pending is not None:
            device_sync(self._pending)
            self._pending = None
        self.samples.setdefault(name, []).append(
            (time.perf_counter() - start) * 1e3)

    def block_on(self, value):
        """Register the step's device output; synced at step exit."""
        self._pending = value
        return value

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per-step percentile rows (``utils.metrics.percentile_summary``:
        count, mean, p50/p95/p99, max)."""
        from avenir_tpu_torch.utils.metrics import percentile_summary

        return {name: percentile_summary(ms)
                for name, ms in self.samples.items()}


def get_logger(name: str = "avenir_tpu_torch",
               debug_on: bool = False) -> logging.Logger:
    """Per-job logger honoring the reference's ``debug.on`` flag
    (e.g. CramerCorrelation.java:106-109)."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s"))
        logger.addHandler(handler)
    logger.setLevel(logging.DEBUG if debug_on else logging.INFO)
    return logger
