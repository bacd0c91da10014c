"""The program registry and device-memory gauges; port of
``avenir_tpu/telemetry/profile.py``.  Free until ``profile.on``.

- :class:`CompiledProgramRegistry` — the process-wide program table.
  Every dispatch seam that feeds a
  :class:`~avenir_tpu_torch.telemetry.spans.CompileKeyMonitor` (the
  streamed chunk source) or registers itself (``scan.chunk``,
  ``tree.level``) journals one ``program.compiled`` event per new
  ``(site, key)``.  Where the JAX package lowers the jitted program and
  reads XLA's cost analysis, the port has no program to lower: a site
  whose dispatch is a hand-written kernel carries the kernel's work as
  :func:`kernel_cost` counts it (``source: "analytic"``, the bytes and
  operations of PERF.md §6's bound), and every other site records its
  shapes with null costs (``source: "shapes"``), as the JAX package does
  on a backend without cost analysis.  Per-dispatch host walls
  accumulate per program and flush as cumulative ``program.profile``
  events (every ``_FLUSH_EVERY`` samples, at each job's and pipeline's
  end, and at ``Tracer.disable``).  The device's own view of the same
  run is ``trace.xla.dir``'s per-stage ``torch.profiler`` trace
  (``utils/profiling.trace``).
- **Device memory gauges** — :meth:`Profiler.sample_device_memory` reads
  ``torch.cuda.memory_allocated`` / ``max_memory_allocated`` of each
  CUDA device at chunk and staging boundaries, journals ``device.memory``
  events labelled ``cuda:<i>`` and keeps the gauge table; on the CPU it
  does nothing, as the JAX package on its CPU transport.
- ``configure(conf)`` — reached through ``telemetry.spans.configure``.

Program identity is ``(site, key)``: the key is the dispatch's shapes
(``CompileKeyMonitor.shape_key``, dtypes by numpy's names) plus the
site's routing, so a program id equals the JAX package's for the same
shapes and route.  Stdlib-only at import: torch and the kernel plans
are imported inside the paths that need them, so the journal CLI runs
without torch.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Any, Dict, List, Optional, Tuple

from avenir_tpu_torch.telemetry import spans as tel

_FLUSH_EVERY = 64          # journal a cumulative program.profile this often


def program_id(site: str, key) -> str:
    """Stable short id for a ``(site, key)`` program — what span
    ``program=`` attrs and journal events carry instead of the raw
    (arbitrarily long) shape tuple."""
    digest = hashlib.sha1(f"{site}|{key!r}".encode()).hexdigest()[:10]
    return f"p{digest}"


def kernel_cost(site: str, num_feat: int, num_bins: int, num_classes: int,
                rows: int, num_cont: int = 0
                ) -> Optional[Dict[str, Optional[float]]]:
    """The analytic cost of one dispatch of a hand-written kernel's site,
    or None for a site that has none.

    ``scan.chunk`` on the kernel route folds a chunk of ``rows`` rows
    through the pair histogram (B1, or B2/B3 in the per-class modes):
    ``bytes_accessed`` and ``flops`` are ``ops.hist.gram_work``'s bytes
    and operations (PERF.md §6's bound counts the same), ``output_bytes``
    is G.  With ``num_cont`` continuous columns the chunk is
    ``hist.gram_moments``: the float32 values read once, the float64
    (count, Σx, Σx²) written once, and a multiply and add for each of Σx
    and Σx² per value.  ``temp_bytes`` is null: the kernel keeps its
    partial tables in shared memory."""
    if site != "scan.chunk":
        return None
    from avenir_tpu_torch.ops import hist

    g_cells, used = hist.gram_cells(num_feat, num_bins, num_classes)
    nbytes, ops = hist.gram_work(num_feat, rows, g_cells, used, rows)
    if num_cont:
        nbytes += 4 * rows * num_cont + 8 * num_classes * (1 + 2 * num_cont)
        ops += 4 * rows * num_cont
    return {"flops": float(ops), "bytes_accessed": float(nbytes),
            "output_bytes": float(4 * g_cells), "temp_bytes": None}


class Profiler:
    """Process-wide program registry + device-memory gauges.

    Disabled (one attribute check at every seam) until :meth:`enable`;
    ``configure(conf)`` wires it from ``profile.*`` keys.  All mutation is
    lock-guarded: the feeder's worker and the consuming thread sample
    concurrently."""

    def __init__(self):
        self.enabled = False
        self._lock = threading.Lock()
        # (site, key) → program record; insertion order = discovery order
        self._programs: Dict[Tuple[str, Any], dict] = {}
        self._gauges: Dict[Tuple[str, str], float] = {}
        self._mem_every = 1
        self._mem_calls: Dict[str, int] = {}

    # -- lifecycle -----------------------------------------------------------
    def enable(self, memory_sample: int = 1) -> "Profiler":
        with self._lock:
            self.enabled = True
            self._mem_every = max(int(memory_sample), 0)
        return self

    def disable(self) -> None:
        """Drop all registered state (run teardown, tests).  Does NOT
        flush — ``Tracer.disable`` flushes first, then calls this."""
        with self._lock:
            self.enabled = False
            self._programs.clear()
            self._gauges.clear()
            self._mem_calls.clear()

    # -- program registry ----------------------------------------------------
    def observe(self, key, site: str,
                cost: Optional[Dict[str, Optional[float]]] = None
                ) -> Optional[str]:
        """Register a dispatch program; returns its id (None when
        disabled).  The first observation of a ``(site, key)`` — and only
        the first, even under racing threads — journals
        ``program.compiled`` with ``cost`` (:func:`kernel_cost`'s dict:
        ``source: "analytic"``) or null costs (``source: "shapes"``);
        later observations are a dict hit."""
        if not self.enabled:
            return None
        with self._lock:
            rec = self._programs.get((site, key))
            if rec is not None:
                return rec["id"]
            pid = program_id(site, key)
            rec = {"id": pid, "site": site, "key": key, "cost": None,
                   "dispatches": 0, "wall_s": 0.0, "flushed": 0}
            self._programs[(site, key)] = rec
        # journaled outside the lock; the record is already published, so
        # a racing observe() of the same key returns the id and never
        # double-journals
        rec["cost"] = cost
        tel.tracer().event(
            "program.compiled", key=pid, site=site,
            flops=(cost or {}).get("flops"),
            bytes_accessed=(cost or {}).get("bytes_accessed"),
            output_bytes=(cost or {}).get("output_bytes"),
            temp_bytes=(cost or {}).get("temp_bytes"),
            source="analytic" if cost is not None else "shapes",
            shapes=repr(key)[:512])
        return pid

    def sample(self, key, site: str, dur_s: float) -> None:
        """Accumulate one dispatch's wall time against its program
        (auto-registering shapes-only if the seam never observed it)."""
        if not self.enabled:
            return
        with self._lock:
            rec = self._programs.get((site, key))
        if rec is None:
            self.observe(key, site)
            with self._lock:
                rec = self._programs.get((site, key))
            if rec is None:                      # disabled mid-flight
                return
        with self._lock:
            rec["dispatches"] += 1
            rec["wall_s"] += float(dur_s)
            due = rec["dispatches"] - rec["flushed"] >= _FLUSH_EVERY
            if due:
                rec["flushed"] = rec["dispatches"]
                snap = (rec["id"], rec["site"], rec["dispatches"],
                        rec["wall_s"])
        if due:
            self._emit_profile(*snap)

    @staticmethod
    def _emit_profile(pid: str, site: str, dispatches: int,
                      wall_s: float) -> None:
        tel.tracer().event("program.profile", key=pid, site=site,
                           dispatches=dispatches,
                           wall_ms=round(wall_s * 1e3, 3))

    def flush(self) -> None:
        """Journal a cumulative ``program.profile`` event for every
        program with unflushed samples — called at each job's and
        pipeline's end and by ``Tracer.disable`` before the journal
        closes."""
        if not self.enabled:
            return
        with self._lock:
            snaps = []
            for rec in self._programs.values():
                if rec["dispatches"] > rec["flushed"]:
                    rec["flushed"] = rec["dispatches"]
                    snaps.append((rec["id"], rec["site"],
                                  rec["dispatches"], rec["wall_s"]))
        for snap in snaps:
            self._emit_profile(*snap)

    def stats(self) -> List[dict]:
        """In-process program table snapshot (id, site, cost, dispatches,
        wall_ms) — discovery order."""
        with self._lock:
            return [{"id": rec["id"], "site": rec["site"],
                     "cost": dict(rec["cost"]) if rec["cost"] else None,
                     "dispatches": rec["dispatches"],
                     "wall_ms": round(rec["wall_s"] * 1e3, 3)}
                    for rec in self._programs.values()]

    # -- device memory gauges ------------------------------------------------
    def sample_device_memory(self, site: str, devices=None) -> None:
        """Sample the CUDA caching allocator of each device into the gauge
        table and the journal (one ``device.memory`` event a device,
        labelled ``cuda:<i>``): ``bytes_in_use`` is
        ``torch.cuda.memory_allocated``, ``peak_bytes``
        ``max_memory_allocated``.  ``devices`` are the torch devices the
        site runs on (a CPU device samples nothing); None means every
        visible CUDA device once CUDA is initialized in this process.
        Skips per this site's interval (``profile.memory.sample``).  A
        failing read raises: on the card a missing gauge is a fault."""
        if not self.enabled:
            return
        with self._lock:
            if not self._mem_every:
                return
            n = self._mem_calls.get(site, 0)
            self._mem_calls[site] = n + 1
            if n % self._mem_every:
                return
        import torch

        if devices is None:
            if not torch.cuda.is_initialized():
                return
            indices = range(torch.cuda.device_count())
        else:
            indices = sorted({
                torch.device(d).index if torch.device(d).index is not None
                else torch.cuda.current_device()
                for d in devices if torch.device(d).type == "cuda"})
        for i in indices:
            in_use = torch.cuda.memory_allocated(i)
            peak = torch.cuda.max_memory_allocated(i)
            label = f"cuda:{i}"
            with self._lock:
                self._gauges[(label, "bytes_in_use")] = float(in_use)
                self._gauges[(label, "peak_bytes")] = float(peak)
            tel.tracer().event("device.memory", site=site, device=label,
                               bytes_in_use=int(in_use), peak_bytes=int(peak))

    def gauges(self) -> Dict[Tuple[str, str], float]:
        """{(device, kind): bytes} — the ``avenir_device_bytes`` gauge set
        (empty until a device reports stats)."""
        with self._lock:
            return dict(self._gauges)


# the registry role under its own name — the Profiler is the program
# registry plus the gauge table
CompiledProgramRegistry = Profiler

_PROFILER = Profiler()


def profiler() -> Profiler:
    """The process profiler (disabled, hence free, until configured)."""
    return _PROFILER


def configure(conf) -> Profiler:
    """Enable the process profiler from ``profile.*`` conf keys; one dict
    lookup when ``profile.on`` is unset.  Reached through
    ``telemetry.spans.configure`` so every tracing entry point configures
    both planes from the same conf."""
    p = _PROFILER
    if p.enabled or not conf.get_bool("profile.on", False):
        return p
    return p.enable(memory_sample=conf.get_int("profile.memory.sample", 1))
