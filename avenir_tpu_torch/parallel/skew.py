"""Straggler attribution for the sharded SharedScan — port of
``avenir_tpu/parallel/skew.py``.

The sharded fold reduces every shard's partial into one total, so its wall
says "this chunk was slow", never "shard 3 made it slow".  Under
``profile.on`` a sampled probe times each shard's gram on its own device,
with no reduction, and publishes:

- a ``Shard::skew.pct`` gauge counter (the latest max/min ratio × 100)
  and a ``shard.skew.ratio`` journal gauge;
- one ``shard.skew`` journal event per sampled chunk with the per-shard
  ms, ``flagged`` when max/min exceeds ``shard.skew.threshold`` (and a
  ``Shard::skew.flagged`` count), rendered by ``python -m
  avenir_tpu_torch.telemetry skew <journal>``.

Each shard is timed on its own device: CUDA events around its launch on
that device's stream on ``cuda``, ``time.perf_counter`` around its plain
version on the CPU.  A shard that fails raises; it is never recorded as
0 ms, which would read as the fastest.  The probe is an extra gram per
sampled chunk, so its absolute ms is a shard's gram in isolation; the
ratio is the signal.

``shard.skew.fault.device`` / ``shard.skew.fault.ms`` add a synthetic
straggler after the measurement (the ``stream.fault.*`` discipline), so
the flag → journal → CLI path can be driven where every shard runs on
the same silicon.
"""

from __future__ import annotations

import time
from typing import List, Optional

import torch

from avenir_tpu_torch.parallel.mesh import Mesh, shard_parts


def skew_probe_step(mesh: Mesh, num_bins: int, num_classes: int,
                    data_axis: str = "data"):
    """fn(codes, labels) → [ms per shard]: each shard's gram over its own
    rows (the fold's wrapper and shapes, so its time is representative),
    reduced to an int32 checksum on its device and timed there, with no
    cross-shard reduction."""
    from avenir_tpu_torch.ops import hist
    from avenir_tpu_torch.parallel.collectives import check_placement

    def timed_cuda(codes, labels) -> List[float]:
        marks = []
        for c, y in zip(shard_parts(codes), shard_parts(labels)):
            with torch.cuda.device(c.device):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                hist.cooc_counts(c, y, num_bins, num_classes).sum(
                    dtype=torch.int32)
                end.record()
            marks.append((start, end))
        out = []
        for start, end in marks:
            end.synchronize()
            out.append(start.elapsed_time(end))
        return out

    def timed_cpu(codes, labels) -> List[float]:
        out = []
        for c, y in zip(shard_parts(codes), shard_parts(labels)):
            t0 = time.perf_counter()
            hist.cooc_counts(c, y, num_bins, num_classes).sum(
                dtype=torch.int32)
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    def step(codes, labels) -> List[float]:
        check_placement(mesh, data_axis, codes, labels)
        if mesh.axis_devices(data_axis)[0].type == "cuda":
            return timed_cuda(codes, labels)
        return timed_cpu(codes, labels)

    return step


def publish_skew(device_ms: List[float], chunk: int, threshold: float,
                 device_labels: List[str], counters=None,
                 fault_device: int = -1, fault_ms: float = 0.0) -> dict:
    """Publish one probe's per-shard times: gauge, counters and the
    ``shard.skew`` event (``flagged`` when max/min exceeds ``threshold``),
    the JAX package's emission line for line."""
    from avenir_tpu_torch.telemetry import spans as tel

    device_ms = [float(ms) for ms in device_ms]
    if fault_ms > 0 and 0 <= fault_device < len(device_ms):
        # the synthetic straggler, added after the real measurement
        device_ms[fault_device] += float(fault_ms)
    floor = 1e-6
    mx = max(device_ms)
    mn = max(min(device_ms), floor)
    ratio = mx / mn
    slowest = int(device_ms.index(mx))
    flagged = ratio > threshold
    if counters is not None:
        counters.set("Shard", "skew.pct", int(round(ratio * 100)))
        if flagged:
            counters.increment("Shard", "skew.flagged")
    tracer = tel.tracer()
    tracer.gauge("shard.skew.ratio", round(ratio, 4))
    tracer.event(
        "shard.skew", chunk=int(chunk),
        device_ms=[round(ms, 3) for ms in device_ms],
        max_ms=round(mx, 3), min_ms=round(min(device_ms), 3),
        ratio=round(ratio, 4), threshold=float(threshold),
        slowest=(device_labels[slowest]
                 if slowest < len(device_labels) else str(slowest)),
        flagged=bool(flagged))
    return {"device_ms": device_ms, "ratio": ratio, "slowest": slowest,
            "flagged": flagged}


class DeviceSkewProbe:
    """Sampled per-shard probe beside the sharded fold.  ``ChunkFolder``
    builds it on the first fold under ``profile.on``; off, the fold pays
    one attribute check.  :meth:`maybe_probe` runs every
    ``shard.skew.sample``-th call."""

    def __init__(self, spec, num_bins: int, num_classes: int, counters=None):
        self.spec = spec
        self.counters = counters
        self.threshold = float(spec.skew_threshold)
        self.sample_every = max(int(spec.skew_sample), 1)
        self.step = skew_probe_step(spec.mesh, num_bins, num_classes,
                                    data_axis=spec.data_axis)
        self._n = 0

    def maybe_probe(self, codes, labels) -> Optional[dict]:
        """Probe this chunk when its index lands on the sampling stride;
        returns the published record or None.  ``codes`` / ``labels`` are
        the fold's staged blocks, so each shard times its own rows."""
        n = self._n
        self._n += 1
        if n % self.sample_every:
            return None
        times = self.step(codes, labels)
        return publish_skew(times, chunk=n, threshold=self.threshold,
                            device_labels=self.spec.mesh.axis_labels(
                                self.spec.data_axis),
                            counters=self.counters,
                            fault_device=self.spec.skew_fault_device,
                            fault_ms=self.spec.skew_fault_ms)
