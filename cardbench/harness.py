"""The general harness: find a cell's configuration, traffic, limits and
metrics by name, set it up, drive it in a closed loop for the window,
read the metrics, check the outputs and print the result line.

Everything that belongs to one configuration, traffic mix, metric or
cell sits in files of its own, found by the names in ``BENCHMARK.json``:

- ``configs/<config>/``: ``config.json`` and ``workload.py`` (with its
  generator and plain reference beside it);
- ``traffic/<traffic>.json``: the mix's parameters;
- ``limits/<cell>.json``: the limit of each number compared;
- ``end_to_end/<metric>.py`` and ``layer_metrics/<metric>.py``: one
  reader a metric.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
import types
from typing import Dict, List, Optional

from cardbench import program

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "avenir_tpu")
PROFILE_SECONDS = 1.0         # length of a profiled sub-window, at most
UNIT_SPAN = "cardbench.unit"  # the harness's span around each unit


class CellError(RuntimeError):
    """A cell the harness cannot run as named."""


class Exit(Exception):
    """Leave the run with ``code`` and no result line."""

    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


# -- finding a cell's parts by name ------------------------------------------

def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _by_name(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise CellError(f"no {what} named {name!r} in BENCHMARK.json")


def _json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _safe(name: str) -> str:
    return re.sub(r"\W", "_", name)


def config_module(name: str):
    """``configs/<name>/workload.py``, imported as a module of a package
    made of the configuration's directory (so it can import its siblings
    relatively)."""
    directory = os.path.join(HERE, "configs", name)
    pkg_name = f"cardbench_config_{_safe(name)}"
    if pkg_name not in sys.modules:
        pkg = types.ModuleType(pkg_name)
        pkg.__path__ = [directory]
        sys.modules[pkg_name] = pkg
    return importlib.import_module(f"{pkg_name}.workload")


def reader(kind: str, name: str):
    """The reader module of a metric: ``<kind>/<name>.py``."""
    path = os.path.join(HERE, kind, f"{name}.py")
    mod_name = f"cardbench_{kind}_{_safe(name)}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or not os.path.exists(path):
        raise CellError(f"metric {name!r} has no reader {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A workload entry of ``BENCHMARK.json`` and everything it names."""

    def __init__(self, bench: dict, name: str):
        self.name = name
        self.entry = _by_name(bench["workloads"], name, "workload")
        self.config_entry = _by_name(bench["configs"], self.entry["config"],
                                     "config")
        self.config = _json(os.path.join(ROOT, self.config_entry["file"]))
        self.traffic = _json(os.path.join(HERE, "traffic",
                                          f"{self.entry['traffic']}.json"))
        self.limits = _json(os.path.join(HERE, "limits", f"{name}.json"))
        self.chips = int(self.entry["chips"])
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        e2e_names = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])
                          and m["moves"] in e2e_names]


# -- the window ----------------------------------------------------------------

class Window:
    """Every unit of one measured window: when each started and ended and
    how many items it completed."""

    def __init__(self, setup_s: float):
        self.setup_s = setup_s
        self.t0 = 0.0
        self.starts: List[float] = []
        self.ends: List[float] = []
        self.items: List[int] = []
        self.attempted = 0
        self.failed = 0

    @property
    def latencies(self) -> List[float]:
        return [e - s for s, e in zip(self.starts, self.ends)]


class Profile:
    """Two ``torch.profiler`` captures of steady sub-windows, each opened
    and closed between units with the card synchronised around it:

    - ``device``: CUDA activity alone, so the host runs at its own pace;
      the device's busy time, kernel time by name and the window's
      length by the host clock;
    - ``host``: CPU and CUDA activity, the sub-window marked by a user
      annotation; what the host was doing in each idle gap.

    The units inside either are listed in ``units``, so that the span
    metrics can leave out the units the profiler slowed."""

    PLAN = (("device", 0.2), ("host", 0.6))     # kind, start (window share)

    def __init__(self, seconds: float, directory: str):
        self.seconds = seconds
        self.length = min(PROFILE_SECONDS, 0.2 * seconds)
        self.directory = directory
        self.pending = list(self.PLAN)
        self.taken: Dict[str, tuple] = {}        # kind -> (path, window_s)
        self.units = set()
        self._prof = None

    @staticmethod
    def warm() -> None:
        """Start and stop the profiler once with each set of activities,
        at set-up: its first start in a process initialises the device
        tracing library, which takes seconds."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        for acts in ([ProfilerActivity.CUDA],
                     [ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            with profile(activities=acts):
                torch.ones(1, device="cuda").add_(1)
                torch.cuda.synchronize()

    def before_unit(self, elapsed: float, index: int) -> None:
        if self._prof is None and self.pending \
                and elapsed >= self.pending[0][1] * self.seconds:
            self._open(self.pending.pop(0)[0])
        if self._prof is not None:
            self.units.add(index)

    def _open(self, kind: str) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        from cardbench.yardstick.trace import WINDOW_MARK

        acts = [ProfilerActivity.CUDA]
        if kind == "host":
            acts.append(ProfilerActivity.CPU)
        torch.cuda.synchronize()
        self._prof = profile(activities=acts)
        self._prof.start()
        self._kind = kind
        self._mark = record_function(WINDOW_MARK) if kind == "host" else None
        if self._mark is not None:
            self._mark.__enter__()
        self._t = time.perf_counter()

    def after_unit(self) -> None:
        if self._prof is not None \
                and time.perf_counter() - self._t >= self.length:
            self.close()

    def close(self) -> None:
        if self._prof is None:
            return
        import torch

        torch.cuda.synchronize()
        window_s = time.perf_counter() - self._t
        if self._mark is not None:
            self._mark.__exit__(None, None, None)
        self._prof.stop()
        path = os.path.join(self.directory, f"{self._kind}.json")
        self._prof.export_chrome_trace(path)
        self.taken[self._kind] = (path, window_s)
        self._prof = None

    def trace(self, kind: str):
        from cardbench.yardstick.trace import Trace

        if kind not in self.taken:
            return None
        path, window_s = self.taken[kind]
        return Trace.load(path, window_s=window_s if kind == "device"
                          else None)


def run_window(wl, seconds: float, setup_s: float,
               profile: Optional[Profile] = None, journal=None) -> Window:
    """Units back to back, one client, from now until ``seconds`` have
    passed; a unit that has started runs to its end and counts.  With a
    ``journal``, each unit runs inside a span of the harness's own,
    ``cardbench.unit``, carrying its index."""
    w = Window(setup_s)
    w.t0 = time.perf_counter()
    deadline = w.t0 + seconds
    index = 0
    while True:
        now = time.perf_counter()
        if now >= deadline:
            break
        if profile is not None:
            profile.before_unit(now - w.t0, index)
            now = time.perf_counter()
        w.attempted += 1
        try:
            if journal is not None:
                with journal.unit_span(index):
                    n = wl.unit(index)
            else:
                n = wl.unit(index)
        except Exception:                     # the program failed a unit
            traceback.print_exc()
            w.failed += 1
            break
        end = time.perf_counter()
        w.starts.append(now)
        w.ends.append(end)
        w.items.append(n)
        if profile is not None:
            profile.after_unit()
        index += 1
    if profile is not None:
        profile.close()
    return w


# -- the run -------------------------------------------------------------------

def nvidia_smi() -> Dict[str, str]:
    fields = ("name", "power.limit", "power.draw", "clocks.sm", "clocks.mem",
              "clocks.max.sm", "temperature.gpu")
    try:
        proc = subprocess.run(
            ["nvidia-smi", f"--query-gpu={','.join(fields)}",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return {"error": str(exc)}
    line = proc.stdout.strip().splitlines()[:1]
    if proc.returncode != 0 or not line:
        return {"error": proc.stderr.strip()[-200:]}
    return dict(zip(fields, (v.strip() for v in line[0].split(","))))


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def check_device(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise Exit(2, "no CUDA device: the benchmark measures the program "
                      "on an NVIDIA card and runs nowhere else")
    if torch.cuda.device_count() < chips:
        raise Exit(2, f"the cell asks for {chips} cards and "
                      f"{torch.cuda.device_count()} are present")


def cache_env() -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    program's own kernels build into its ``build/`` directory there)."""
    base = os.path.join(ROOT, ".cardbench_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(base, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(base, "triton"))


def host_threads(cell: Cell) -> None:
    """The host's compute threads as the configuration's deployment
    states them (``host_threads``), before anything loads torch or
    NumPy's BLAS: the one place the benchmark sets them."""
    threads = cell.config.get("host_threads")
    if threads:
        os.environ["OMP_NUM_THREADS"] = str(int(threads))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda",
             traffic: Optional[dict] = None,
             parts: Optional[Dict[str, float]] = None) -> dict:
    """Set up, run and check one cell; the result line as a dict, with
    the card line and the checks beside it.  ``parts`` holds the set-up's
    parts timed before the call."""
    import torch

    parts = dict(parts or {})
    parts["start"] = time.perf_counter() - t_start - sum(parts.values())
    wl = config_module(cell.entry["config"]).Workload(
        cell.config, traffic or cell.traffic, seed, device)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    wl.make_inputs()
    parts["inputs"] = time.perf_counter() - t
    t = time.perf_counter()
    wl.setup()
    parts["program"] = time.perf_counter() - t
    tmp = tempfile.mkdtemp(prefix="cardbench-")
    try:
        journal = program.SpanJournal(tmp) if trace else None
        profile = Profile(seconds, tmp) if trace and on_card else None
        if profile is not None:
            profile.warm()
        before = program.read_counters()
        setup_s = time.perf_counter() - t_start
        window = run_window(wl, seconds, setup_s, profile, journal)
        counters = program.counter_deltas(before, program.read_counters())
        spans = journal.close() if journal is not None else []
        peak = (int(torch.cuda.max_memory_allocated()) if on_card else 0)
        dev_tr = profile.trace("device") if profile is not None else None
        host_tr = profile.trace("host") if profile is not None else None
        metrics = (layer_metrics(cell, wl, window, dev_tr, spans, counters,
                                 profile.units if profile else set())
                   if trace else end_to_end(cell, window))
        wl.release()
        t = time.perf_counter()
        checks = wl.check() if window.ends else {}
        parts["check"] = time.perf_counter() - t
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # the card's canary, once the window, its peak and the check are done:
    # it serves no request, so it is neither set-up nor held in the peak
    canary_ms = None
    if on_card:
        from cardbench.yardstick.canary import matmul_canary_ms

        canary_ms = matmul_canary_ms(torch.device(device))
    limits = cell.limits
    correct = (window.failed == 0 and bool(window.ends)
               and set(checks) == set(limits)
               and all(_within(checks[k], limits[k]) for k in limits))
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name(torch.device(device))
                            if on_card else "cpu"),
                   "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": window.attempted,
              "failed": window.failed, "metrics": metrics,
              "device": device_info}
    if dev_tr is not None:
        device_info["busy_s"] = dev_tr.busy_s
        device_info["window_s"] = dev_tr.window_s
        result["breakdown"] = {
            "device_ops": dev_tr.top_ops(10),
            "idle_gaps": host_tr.idle_by_host(10) if host_tr else []}
    result["checks"] = {k: {"value": _num(checks.get(k)),
                            "limit": limits[k]} for k in limits}
    card = {"cell": cell.name, "seed": seed, "trace": int(trace),
            "card": nvidia_smi() if on_card else {},
            "canary_ms": canary_ms, "launches": counters,
            "units": len(window.ends), "setup_s": window.setup_s,
            "setup_parts_s": parts, "unit_ms": unit_ms(window),
            "items_by_second": by_second(window)}
    return {"result": result, "card": card}


def unit_ms(window: Window) -> Dict[str, float]:
    """Quantiles of the units' latencies, for the card line."""
    lat = sorted(1e3 * x for x in window.latencies)
    if not lat:
        return {}
    pick = lambda q: lat[min(int(q * len(lat)), len(lat) - 1)]  # noqa: E731
    return {"min": lat[0], "p10": pick(0.1), "p50": pick(0.5),
            "p90": pick(0.9), "p99": pick(0.99), "max": lat[-1]}


def by_second(window: Window) -> List[int]:
    """Items completed in each whole second of the window."""
    out: List[int] = []
    for end, n in zip(window.ends, window.items):
        b = int(end - window.t0)
        out.extend([0] * (b + 1 - len(out)))
        out[b] += n
    return out


def _within(value, limit) -> bool:
    return value is not None and value == value and value <= limit


def _num(value):
    if value is None or value != value or value in (float("inf"),
                                                    float("-inf")):
        return str(value)
    return value


def end_to_end(cell: Cell, window: Window) -> Dict[str, dict]:
    out = {}
    for m in cell.end_to_end:
        value = reader("end_to_end", m["name"]).read(window)
        out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


class LayerContext:
    """What a per-layer reader reads: the device trace of the profiled
    sub-window, the program's spans and the units' latencies (of the
    units the profiler did not slow), the counters' deltas over the
    window, the cell's shapes and the card's peaks."""

    def __init__(self, cell, wl, window, trace, spans, counters,
                 profiled=frozenset()):
        import torch

        from cardbench.yardstick import peaks

        self.trace = trace
        self.counters = counters
        self.shape = wl.shape()
        self.items = sum(window.items)
        # the host-clock latencies (s) of the units the profiler did not slow
        self.latencies = [lat for i, lat in enumerate(window.latencies)
                          if i not in profiled]
        kind = (torch.cuda.get_device_name() if torch.cuda.is_available()
                else "cpu")
        self.peaks = peaks.peaks_for(kind)
        opens = {e["span"]: e for e in spans if e.get("ev") == "span.open"}

        def unit_of(span_id):
            while span_id in opens:
                e = opens[span_id]
                if e.get("name") == UNIT_SPAN:
                    return e["attrs"]["index"]
                span_id = e.get("parent")
            return None

        self._closed = [(e["name"], float(e["dur_ms"]), unit_of(e["span"]))
                        for e in spans if e.get("ev") == "span.close"]
        self._closed = [c for c in self._closed
                        if c[2] is not None and c[2] not in profiled]

    def span_ms(self, name: str) -> List[float]:
        """Durations (ms) of the spans named ``name``, in order."""
        return [d for n, d, _ in self._closed if n == name]

    def span_ms_by_unit(self, name: str) -> Dict[int, float]:
        """Each unit's total duration (ms) of the spans named ``name``."""
        out: Dict[int, float] = {}
        for n, d, u in self._closed:
            if n == name:
                out[u] = out.get(u, 0.0) + d
        return out


def layer_metrics(cell: Cell, wl, window, trace, spans, counters,
                  profiled=frozenset()) -> Dict[str, dict]:
    ctx = LayerContext(cell, wl, window, trace, spans, counters, profiled)
    out = {}
    for m in cell.per_layer:
        value = reader("layer_metrics", m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(args, t_start: float) -> int:
    try:
        bench = load_benchmark()
        cell = Cell(bench, args.workload)
        host_threads(cell)
        t = time.perf_counter()
        import torch  # noqa: F401

        parts = {"torch": time.perf_counter() - t}
        t = time.perf_counter()
        check_device(cell.chips)
        parts["device"] = time.perf_counter() - t
        if not program.present():
            raise Exit(4, "the program under test (avenir_tpu_torch) is not "
                          "in this checkout")
        cache_env()
        out = run_cell(cell, args.seed, float(args.seconds),
                       bool(args.trace), t_start, parts=parts)
        bad = forbidden_modules()
        if bad:
            raise Exit(5, f"the run loaded {', '.join(bad)}: the benchmark "
                          f"measures the port alone")
    except Exit as exc:
        print(str(exc), file=sys.stderr)
        return exc.code
    except CellError as exc:
        print(f"cell error: {exc}", file=sys.stderr)
        return 6
    print(json.dumps(out["card"]), flush=True)
    for name, c in out["result"]["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out["result"]), flush=True)
    return 0
