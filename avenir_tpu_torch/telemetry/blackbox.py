"""The always-on flight recorder and crash/hang forensics; a copy of
``avenir_tpu/telemetry/blackbox.py``.

- **flight ring**: a bounded in-process deque of schema'd events that
  records at every journal-emit seam even when ``trace.on`` is off
  (:func:`ring_record` is one time read and one deque append, GIL-safe
  with no lock).  ``blackbox.ring.events`` bounds it.
- **forensics bundles**: with ``blackbox.dir`` set, :func:`arm` (called
  by ``spans.configure``) starts a spill thread that keeps
  ``<dir>/bundle-<run>-<writer>/`` current — ring contents, all-thread
  stacks (``faulthandler``), registered in-flight and state providers,
  the device-memory gauges and program table of the port's profiler,
  and the conf — each file written atomically (tmp + ``os.replace``).
  An unhandled exception, SIGTERM or a watchdog trip latches the bundle
  ``final`` (and journals ``bundle.written`` when tracing is on); a
  clean exit removes the live bundle.  A SIGKILLed process runs no hook:
  its live bundle survives, and :func:`sweep` finalizes it and journals
  exactly one ``bundle.written`` for it.
- **progress watchdog**: long-running seams hold :func:`watchdog_guard`
  regions (the job body, ``ChunkFolder.fold``); a guard active with no
  progress for ``blackbox.watchdog.sec`` journals ``hang.detected``
  (naming the oldest silent site) and captures the bundle.

Nothing is armed and no hook installed unless ``blackbox.dir`` (bundles)
or ``blackbox.watchdog.sec`` (the watchdog thread) is set; the ring
append is the only always-on cost.  Stdlib only at import.
"""

from __future__ import annotations

import atexit
import contextlib
import faulthandler
import json
import os
import shutil
import signal
import sys
import threading
import time
import traceback
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

DEFAULT_RING_EVENTS = 4096

# -- the flight ring ---------------------------------------------------------

_RING: "deque[Tuple[float, str, Optional[dict]]]" = deque(
    maxlen=DEFAULT_RING_EVENTS)


def ring_record(ev: str, fields: Optional[dict] = None) -> None:
    """Append one event to the flight ring — the always-on hot path.

    One ``time.time()`` read, one tuple, one (GIL-atomic) bounded-deque
    append; no lock, no serialization, no branching on configuration.
    The tracer's emit seams call this on both sides of ``trace.on``;
    instrumentation that must stay visible with tracing off calls it
    directly."""
    _RING.append((time.time(), ev, fields))


def ring_snapshot() -> List[Dict[str, Any]]:
    """The ring's contents, oldest first, as journal-shaped dicts."""
    out = []
    for ts, ev, fields in list(_RING):
        rec = {"ts": round(ts, 6), "ev": ev}
        if fields:
            rec.update(fields)
        out.append(rec)
    return out


def ring_clear() -> None:
    _RING.clear()


def _ring_resize(cap: int) -> None:
    global _RING
    cap = max(int(cap), 16)
    if _RING.maxlen == cap:
        return
    _RING = deque(_RING, maxlen=cap)


# -- live-state providers ----------------------------------------------------

# name -> (kind, callable); kind "inflight" feeds the bundle's in-flight
# request table, anything else lands under state.json.  An owner
# registers on start and unregisters on close; a crashed owner that never
# closed is exactly when its snapshot is wanted.
_PROVIDERS: Dict[str, Tuple[str, Callable[[], Any]]] = {}
_PROVIDERS_LOCK = threading.Lock()


def register_provider(name: str, fn: Callable[[], Any],
                      kind: str = "state") -> None:
    """Register a zero-arg snapshot callable rendered into every bundle
    spill (``kind="inflight"`` → inflight.json, else state.json)."""
    with _PROVIDERS_LOCK:
        _PROVIDERS[name] = (kind, fn)


def unregister_provider(name: str) -> None:
    with _PROVIDERS_LOCK:
        _PROVIDERS.pop(name, None)


def _provider_snapshot(kind: str) -> Dict[str, Any]:
    with _PROVIDERS_LOCK:
        items = [(n, f) for n, (k, f) in _PROVIDERS.items() if k == kind]
    out: Dict[str, Any] = {}
    for name, fn in items:
        try:
            out[name] = fn()
        except Exception as exc:  # a dying owner must not kill the spill
            out[name] = f"provider failed: {type(exc).__name__}: {exc}"
    return out


# -- the progress watchdog ---------------------------------------------------

class Watchdog:
    """Trips when any guarded seam is active but NOTHING has progressed
    for ``sec`` — one global progress clock (every guard enter/exit and
    every :func:`watchdog_beat` advances it), so a fleet of busy seams
    never false-trips while one wedged seam still does."""

    def __init__(self):
        self.sec = 0.0
        self._lock = threading.Lock()
        self._guards: Dict[str, List[float]] = {}   # site -> [depth, t0]
        self.last_progress = time.monotonic()
        self._tripped = False
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def arm(self, sec: float) -> None:
        self.sec = float(sec)
        if self.sec <= 0 or (
                self._thread is not None and self._thread.is_alive()):
            return
        self._stop.clear()
        self.last_progress = time.monotonic()
        self._thread = threading.Thread(
            target=self._watch, daemon=True, name="graftbox-watchdog")
        self._thread.start()

    def disarm(self) -> None:
        self.sec = 0.0
        self._stop.set()
        thread = self._thread
        self._thread = None
        if thread is not None and thread.is_alive():
            thread.join(timeout=5.0)
        with self._lock:
            self._guards.clear()
        self._tripped = False

    def enter(self, site: str) -> None:
        now = time.monotonic()
        with self._lock:
            cell = self._guards.get(site)
            if cell is None:
                self._guards[site] = [1.0, now]
            else:
                cell[0] += 1
        self.last_progress = now

    def exit(self, site: str) -> None:
        now = time.monotonic()
        with self._lock:
            cell = self._guards.get(site)
            if cell is not None:
                cell[0] -= 1
                if cell[0] <= 0:
                    del self._guards[site]
        self.last_progress = now

    def beat(self) -> None:
        self.last_progress = time.monotonic()

    def snapshot(self) -> Dict[str, Any]:
        now = time.monotonic()
        with self._lock:
            active = {site: {"depth": int(cell[0]),
                             "active_s": round(now - cell[1], 3)}
                      for site, cell in self._guards.items()}
        return {"sec": self.sec, "active": active,
                "silent_s": round(now - self.last_progress, 3),
                "tripped": self._tripped}

    def _watch(self) -> None:
        interval = min(max(self.sec / 4.0, 0.05), 1.0)
        while not self._stop.wait(interval):
            try:
                self.check_once()
            except Exception:                      # never kill the checker
                ring_record("blackbox.error",
                            {"site": "watchdog", "exc": "check failed"})

    def check_once(self) -> None:
        """One deadline check (public for deterministic tests)."""
        if self.sec <= 0:
            return
        now = time.monotonic()
        silent = now - self.last_progress
        if silent <= self.sec:
            self._tripped = False             # progress resumed: re-latch
            return
        with self._lock:
            active = [(cell[1], site)
                      for site, cell in self._guards.items()]
        if not active or self._tripped:
            return
        self._tripped = True                  # one trip per excursion
        site = min(active)[1]                 # the oldest silent seam
        # the emit seam records to the flight ring on BOTH sides of
        # trace.on — no explicit ring_record here or the off state
        # would hold the event twice
        from avenir_tpu_torch.telemetry import spans as tel

        tel.tracer().event("hang.detected", site=site,
                           silent_s=round(silent, 3), threshold=self.sec)
        _BOX.finalize(f"hang:{site}")


_WATCHDOG = Watchdog()
_NULL_GUARD = contextlib.nullcontext()


class _Guard:
    __slots__ = ("site",)

    def __init__(self, site: str):
        self.site = site

    def __enter__(self):
        _WATCHDOG.enter(self.site)
        return self

    def __exit__(self, *exc):
        _WATCHDOG.exit(self.site)
        return False


def watchdog_guard(site: str):
    """Mark a long-running seam: while the region is open the watchdog
    holds this process accountable for progress.  Off (the default — no
    ``blackbox.watchdog.sec``): the shared inert context, one attribute
    check, no allocation."""
    if _WATCHDOG.sec <= 0:
        return _NULL_GUARD
    return _Guard(site)


def watchdog_beat() -> None:
    """Progress tick from inside a guarded region (chunk loops, queue
    waits): being slow is not being wedged."""
    if _WATCHDOG.sec > 0:
        _WATCHDOG.beat()


# -- the bundle writer -------------------------------------------------------

def _atomic_write(path: str, data: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        fh.write(data)
    os.replace(tmp, path)


def _json_dumps(obj: Any) -> str:
    return json.dumps(obj, separators=(",", ":"), default=repr)


class BlackBox:
    """The per-process forensics writer: armed by ``blackbox.dir``, it
    keeps a live bundle current and latches it ``final`` exactly once —
    on crash, fatal signal, or watchdog trip (first cause wins)."""

    def __init__(self):
        self.armed = False
        self.dir: Optional[str] = None
        self.bundle_path: Optional[str] = None
        self.run = ""
        self.writer = ""
        self.flush_sec = 1.0
        self.conf_props: Dict[str, str] = {}
        self._finalized = threading.Event()
        self._journaled = False
        self._reason = ""
        self._stop = threading.Event()
        self._flusher: Optional[threading.Thread] = None
        self._prev_excepthook = None
        self._prev_threadhook = None
        self._prev_sigterm = None
        self._sigterm_installed = False
        self._atexit_registered = False
        self._capture_seq = 0

    # -- identity ------------------------------------------------------------
    @staticmethod
    def _process_index() -> int:
        # one process: multi-process runs are ROADMAP.md, Queue 1 item 7h
        return 0

    def _resolve_identity(self, conf) -> None:
        from avenir_tpu_torch.telemetry import spans as tel

        self.run = tel.fleet_run_id(conf)
        proc = self._process_index()
        suffix = (conf.get("trace.writer.suffix", "")
                  or conf.get("tenant.id", "") or "")
        self.writer = f"proc-{proc}" + (f"-{suffix}" if suffix else "")

    # -- lifecycle -----------------------------------------------------------
    def arm(self, conf) -> None:
        if self.armed:
            return
        bb_dir = conf.get("blackbox.dir")
        if not bb_dir:
            return
        self.dir = bb_dir
        self.flush_sec = conf.get_float("blackbox.flush.sec", 1.0)
        self._resolve_identity(conf)
        self.conf_props = {str(k): str(v) for k, v in conf.props.items()}
        self.bundle_path = os.path.join(
            bb_dir, f"bundle-{self.run}-{self.writer}")
        os.makedirs(self.bundle_path, exist_ok=True)
        self._finalized.clear()
        self._journaled = False
        self._reason = ""
        self.armed = True
        self._install_hooks()
        self.spill("live")                   # a bundle exists from t=0
        if self.flush_sec > 0:
            self._stop.clear()
            self._flusher = threading.Thread(
                target=self._flush_loop, daemon=True, name="graftbox-flush")
            self._flusher.start()

    def _install_hooks(self) -> None:
        if self._prev_excepthook is None:
            self._prev_excepthook = sys.excepthook
            sys.excepthook = self._excepthook
        if self._prev_threadhook is None:
            self._prev_threadhook = threading.excepthook
            threading.excepthook = self._threadhook
        if not self._sigterm_installed:
            try:
                self._prev_sigterm = signal.signal(
                    signal.SIGTERM, self._sigterm)
                self._sigterm_installed = True
            except ValueError:     # non-main thread: the host CLI owns it
                self._prev_sigterm = None
        if not self._atexit_registered:
            atexit.register(self._atexit)
            self._atexit_registered = True

    def _excepthook(self, exc_type, exc, tb) -> None:
        try:
            text = "".join(traceback.format_exception(exc_type, exc, tb))
            self.finalize(f"crash:{exc_type.__name__}", exc_text=text)
        except Exception:
            ring_record("blackbox.error", {"site": "excepthook"})
        prev = self._prev_excepthook or sys.__excepthook__
        prev(exc_type, exc, tb)

    def _threadhook(self, args) -> None:
        try:
            if args.exc_type is not SystemExit:
                text = "".join(traceback.format_exception(
                    args.exc_type, args.exc_value, args.exc_traceback))
                self.finalize(
                    f"crash:{args.exc_type.__name__}:thread", exc_text=text)
        except Exception:
            ring_record("blackbox.error", {"site": "threadhook"})
        prev = self._prev_threadhook or threading.__excepthook__
        prev(args)

    def _sigterm(self, signum, frame) -> None:
        self.finalize("signal:SIGTERM")
        prev = self._prev_sigterm
        if callable(prev):
            prev(signum, frame)
        elif prev is not None:           # SIG_DFL/SIG_IGN: replay faithfully
            signal.signal(signal.SIGTERM, prev)
            os.kill(os.getpid(), signal.SIGTERM)

    def _atexit(self) -> None:
        # clean exit: a run that neither crashed, hung, nor was signalled
        # leaves NO bundle — the live spill is removed, not finalized
        self._stop.set()
        if self.armed and not self._finalized.is_set() and self.bundle_path:
            shutil.rmtree(self.bundle_path, ignore_errors=True)
            self.armed = False

    def _flush_loop(self) -> None:
        while not self._stop.wait(self.flush_sec):
            try:
                if not self._finalized.is_set():
                    self.spill("live")
            except Exception:            # spill failure must not kill owner
                ring_record("blackbox.error", {"site": "flush"})

    # -- the bundle itself ---------------------------------------------------
    def spill(self, status: str, reason: str = "", exc_text: str = "",
              path: Optional[str] = None) -> None:
        """Write every bundle file, each atomically (a SIGKILL between
        files leaves the previous consistent versions)."""
        bundle = path or self.bundle_path
        if bundle is None:
            return
        os.makedirs(bundle, exist_ok=True)
        snap = ring_snapshot()
        lines = [_json_dumps(rec) for rec in snap]
        _atomic_write(os.path.join(bundle, "ring.jsonl"),
                      "\n".join(lines) + ("\n" if lines else ""))
        self._spill_stacks(os.path.join(bundle, "stacks.txt"), exc_text)
        _atomic_write(os.path.join(bundle, "inflight.json"),
                      _json_dumps(_provider_snapshot("inflight")))
        _atomic_write(os.path.join(bundle, "state.json"),
                      _json_dumps(self._state_snapshot()))
        _atomic_write(os.path.join(bundle, "memory.json"),
                      _json_dumps(self._memory_snapshot()))
        _atomic_write(os.path.join(bundle, "conf.json"),
                      _json_dumps({"run": self.run, "writer": self.writer,
                                   "props": self.conf_props}))
        _atomic_write(os.path.join(bundle, "meta.json"), _json_dumps({
            "status": status, "reason": reason or self._reason,
            "ts": round(time.time(), 6), "pid": os.getpid(),
            "run": self.run, "writer": self.writer,
            "argv": list(sys.argv), "journaled": self._journaled,
            "events": len(snap)}))

    @staticmethod
    def _spill_stacks(path: str, exc_text: str) -> None:
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            if exc_text:
                fh.write(exc_text)
                fh.write("\n--- all threads ---\n")
            try:
                faulthandler.dump_traceback(file=fh, all_threads=True)
            except Exception:
                fh.write("faulthandler unavailable\n")
        os.replace(tmp, path)

    def _state_snapshot(self) -> Dict[str, Any]:
        state: Dict[str, Any] = {"watchdog": _WATCHDOG.snapshot()}
        state.update(_provider_snapshot("state"))
        # no tenancy arbiter in the port (ROADMAP.md, Queue 1 item 7f)
        state["arbiter"] = None
        return state

    @staticmethod
    def _memory_snapshot() -> Dict[str, Any]:
        try:
            from avenir_tpu_torch.telemetry import profile as prof_mod

            prof = prof_mod.profiler()
            gauges = {f"{dev}/{kind}": val
                      for (dev, kind), val in prof.gauges().items()}
            return {"device_memory": gauges, "programs": prof.stats()}
        except Exception:
            return {"device_memory": {}, "programs": {}}

    # -- latching ------------------------------------------------------------
    def finalize(self, reason: str, exc_text: str = "") -> Optional[str]:
        """Latch the bundle ``final`` — once per process, first cause
        wins — and journal ``bundle.written`` when tracing is on.
        Returns the bundle path (None when unarmed/already latched)."""
        if not self.armed or self._finalized.is_set():
            return None
        self._finalized.set()
        self._reason = reason
        self._stop.set()
        events = len(_RING)
        try:
            from avenir_tpu_torch.telemetry import spans as tel

            tracer = tel.tracer()
            if tracer.enabled and tracer.journal is not None:
                # the emit seam rings it too — one ring entry either way
                tracer.event("bundle.written", dir=self.bundle_path,
                             reason=reason, events=events)
                self._journaled = True
        except Exception:                    # dying: the bundle still lands
            ring_record("blackbox.error", {"site": "finalize.journal"})
        if not self._journaled:
            ring_record("bundle.written", {"dir": self.bundle_path,
                                           "reason": reason,
                                           "events": events})
        try:
            self.spill("final", reason=reason, exc_text=exc_text)
        except Exception:
            return None
        return self.bundle_path

    def capture(self, reason: str) -> Optional[str]:
        """A non-latching one-shot bundle (``<bundle>-c<n>/``): a snapshot
        of what the process saw, without spending its crash latch."""
        if not self.armed or self.bundle_path is None:
            return None
        self._capture_seq += 1
        path = f"{self.bundle_path}-c{self._capture_seq}"
        events = len(_RING)
        journaled = self._journaled
        try:
            from avenir_tpu_torch.telemetry import spans as tel

            tracer = tel.tracer()
            if tracer.enabled and tracer.journal is not None:
                tracer.event("bundle.written", dir=path, reason=reason,
                             events=events)
                journaled = True
        except Exception:
            journaled = False
        if not journaled:
            ring_record("bundle.written", {"dir": path, "reason": reason,
                                           "events": events})
        try:
            prev, self._journaled = self._journaled, journaled
            self.spill("final", reason=reason, path=path)
            self._journaled = prev
        except Exception:
            return None
        return path

    def reset(self) -> None:
        """Tear down hooks/threads and disarm — test isolation."""
        self._stop.set()
        if self._flusher is not None and self._flusher.is_alive():
            self._flusher.join(timeout=5.0)
        self._flusher = None
        if self._prev_excepthook is not None:
            sys.excepthook = self._prev_excepthook
            self._prev_excepthook = None
        if self._prev_threadhook is not None:
            threading.excepthook = self._prev_threadhook
            self._prev_threadhook = None
        if self._sigterm_installed:
            try:
                signal.signal(signal.SIGTERM,
                              self._prev_sigterm or signal.SIG_DFL)
            except ValueError:
                pass
            self._sigterm_installed = False
            self._prev_sigterm = None
        self.armed = False
        self.dir = None
        self.bundle_path = None
        self._finalized.clear()
        self._journaled = False
        self._reason = ""
        self._capture_seq = 0
        _WATCHDOG.disarm()


_BOX = BlackBox()


def box() -> BlackBox:
    return _BOX


def configure(conf) -> None:
    """The blackbox's slice of ``spans.configure``, called for every
    tracer configure with the same conf.  Cheap when unconfigured: three
    dict lookups, no threads, no files."""
    ring_cap = conf.get_int("blackbox.ring.events", 0)
    if ring_cap:
        _ring_resize(ring_cap)
    wd_sec = conf.get_float("blackbox.watchdog.sec", 0.0)
    if wd_sec > 0:
        _WATCHDOG.arm(wd_sec)
    _BOX.arm(conf)


def finalize(reason: str, exc_text: str = "") -> Optional[str]:
    return _BOX.finalize(reason, exc_text=exc_text)


def capture(reason: str) -> Optional[str]:
    return _BOX.capture(reason)


def on_signal(name: str) -> None:
    """A host CLI's own signal handler calls this before its shutdown
    path; a no-op when unarmed."""
    _BOX.finalize(f"signal:{name}")


def reset() -> None:
    _BOX.reset()


# -- the teardown sweep ------------------------------------------------------

def read_meta(bundle_path: str) -> Dict[str, Any]:
    try:
        with open(os.path.join(bundle_path, "meta.json"),
                  encoding="utf-8") as fh:
            return json.load(fh)
    except Exception:
        return {}


def _pid_alive(pid: Optional[int]) -> bool:
    if not pid:
        return False
    try:
        os.kill(int(pid), 0)
    except (OSError, ValueError):
        return False
    return True


def sweep(blackbox_dir: str, journal_dir: Optional[str] = None,
          run_id: Optional[str] = None) -> List[Dict[str, Any]]:
    """Finalize dead processes' bundles and journal the unjournaled ones.

    A teardown calls this before merging a run's shards: every ``bundle-*`` whose writing pid is gone is marked ``swept``,
    and each bundle no process journaled (a SIGKILL runs no hook; a
    crash with tracing off has no journal) gets exactly ONE
    ``bundle.written`` appended to a sweep shard of the run
    (``run-<id>.proc-<k>-sweep.jsonl``) so the merged journal accounts
    for every dead process.  Idempotent: swept-and-journaled
    bundles are reported but never re-journaled.  Returns one record per
    surviving bundle (dir/reason/status/events/journaled)."""
    if not blackbox_dir or not os.path.isdir(blackbox_dir):
        return []
    found = []
    for name in sorted(os.listdir(blackbox_dir)):
        path = os.path.join(blackbox_dir, name)
        if not name.startswith("bundle-") or not os.path.isdir(path):
            continue
        meta = read_meta(path)
        if not meta:
            continue
        pid = meta.get("pid")
        if pid == os.getpid() or (meta.get("status") == "live"
                                  and _pid_alive(pid)):
            continue                       # writer still running: not ours
        found.append((path, meta))
    swept: List[Dict[str, Any]] = []
    journal = None
    try:
        for path, meta in found:
            status = meta.get("status")
            reason = meta.get("reason") or (
                "killed" if status == "live" else "unknown")
            if status == "live":
                meta["status"] = "swept"
                meta["reason"] = reason
            if not meta.get("journaled") and journal_dir:
                if journal is None:
                    journal = _sweep_journal(journal_dir,
                                             run_id or meta.get("run"))
                if journal is not None:
                    journal.emit("bundle.written", trace=None, span=None,
                                 dir=path, reason=reason,
                                 events=int(meta.get("events") or 0))
                    meta["journaled"] = True
            try:
                _atomic_write(os.path.join(path, "meta.json"),
                              _json_dumps(meta))
            except Exception:
                ring_record("blackbox.error", {"site": "sweep", "dir": path})
            swept.append({"dir": path, "reason": meta.get("reason"),
                          "status": meta.get("status"),
                          "events": meta.get("events"),
                          "journaled": bool(meta.get("journaled")),
                          "writer": meta.get("writer")})
    finally:
        if journal is not None:
            journal.close()
    return swept


def _sweep_journal(journal_dir: str, run_id: Optional[str]):
    """The sweeper's own journal shard — raw (the sweeping process's
    tracer may be off or pointed elsewhere), named so ``find_shards``
    merges it with the run it accounts for."""
    import socket

    from avenir_tpu_torch.telemetry.journal import Journal

    rid = run_id or "sweep"
    proc = BlackBox._process_index()
    path = os.path.join(journal_dir, f"run-{rid}.proc-{proc}-sweep.jsonl")
    try:
        os.makedirs(journal_dir, exist_ok=True)
        return Journal(path, stamp={"proc": proc,
                                    "host": socket.gethostname()})
    except Exception:
        return None
