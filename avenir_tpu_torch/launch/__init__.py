"""The fleet launcher — port of ``avenir_tpu/launch/``: the process plane
under the count jobs, in one verb::

    python -m avenir_tpu_torch.launch --nprocs 2 -- BayesianDistribution \\
        -Dconf.path=churn.properties train.csv out/

It spawns N local worker processes (or, inside an externally provisioned
pod, discovers its own rank from the environment and execs the worker in
place), and each worker joins through the bounded
:func:`avenir_tpu_torch.parallel.mesh.init_distributed` (a
``torch.distributed`` group on ``gloo``; an unreachable coordinator raises
the typed :class:`LaunchError` naming it, never hangs).  Each worker gets
its own journal shard (``trace.writer.suffix`` from
``AVENIR_WRITER_SUFFIX``); on teardown the launcher merges the shards into
one fleet view and propagates the first non-zero exit.

Standard library only at import time: the launcher starts at once, and
its error messages still work on a machine whose torch is broken.  The
workers do the torch work.

Env contract (the launcher writes these, the worker reads them):

- ``AVENIR_COORDINATOR_ADDRESS`` — ``host:port`` of the ``TCPStore``
  rendezvous that process 0 hosts;
- ``AVENIR_NUM_PROCESSES`` / ``AVENIR_PROCESS_ID`` — fleet size / rank;
- ``AVENIR_JOIN_TIMEOUT_SEC`` / ``AVENIR_JOIN_ATTEMPTS`` — the join's
  bounds (defaults 300 s / 3);
- ``AVENIR_WRITER_SUFFIX`` — the journal-shard suffix (``w<rank>``);
  ``python -m avenir_tpu_torch`` adopts it as ``trace.writer.suffix``
  unless the conf sets one.

A pod whose scheduler starts every rank itself sets the same variables
per rank and runs the same command on each without ``--nprocs``:
:func:`pod_env` finds the rank and the launcher execs the worker in
place.
"""

from __future__ import annotations

import os
import socket
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

ENV_COORD = "AVENIR_COORDINATOR_ADDRESS"
ENV_NPROCS = "AVENIR_NUM_PROCESSES"
ENV_PID = "AVENIR_PROCESS_ID"
ENV_SUFFIX = "AVENIR_WRITER_SUFFIX"
ENV_JOIN_TIMEOUT = "AVENIR_JOIN_TIMEOUT_SEC"
ENV_JOIN_ATTEMPTS = "AVENIR_JOIN_ATTEMPTS"


class LaunchError(RuntimeError):
    """A fleet that could not be brought up or torn down cleanly: a join
    that timed out (the message names the coordinator address), a worker
    that outlived the launch deadline, or an argv the launcher cannot
    interpret."""


def free_port() -> int:
    """An OS-assigned free TCP port on localhost — the default coordinator
    port of a locally spawned fleet."""
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def pod_env(environ: Optional[Dict[str, str]] = None) -> Optional[dict]:
    """An externally provisioned rank: when the environment names this
    process's rank (``AVENIR_PROCESS_ID`` and the fleet size), return
    ``{"coordinator", "nprocs", "process_id"}``; else None."""
    env = os.environ if environ is None else environ
    if ENV_PID not in env or ENV_NPROCS not in env:
        return None
    return {"coordinator": env.get(ENV_COORD, ""),
            "nprocs": int(env[ENV_NPROCS]),
            "process_id": int(env[ENV_PID])}


def join_from_env(environ: Optional[Dict[str, str]] = None) -> int:
    """A worker's bootstrap: join the fleet the environment describes (rank
    0 of 1 when it describes none) through the bounded join, and return
    this process's rank.  ``python -m avenir_tpu_torch`` calls it before
    any device work when ``AVENIR_NUM_PROCESSES`` is set."""
    env = os.environ if environ is None else environ
    from avenir_tpu_torch.parallel.mesh import init_distributed

    pod = pod_env(env)
    if pod is None:
        return init_distributed()
    return init_distributed(
        coordinator_address=pod["coordinator"] or None,
        num_processes=pod["nprocs"], process_id=pod["process_id"],
        timeout_s=float(env.get(ENV_JOIN_TIMEOUT, "300")),
        attempts=int(env.get(ENV_JOIN_ATTEMPTS, "3")))


def worker_command(argv: Sequence[str]) -> List[str]:
    """One worker's command line: ``<JobName> …`` runs the job CLI
    (``python -m avenir_tpu_torch …``), ``<script>.py …`` the script,
    ``-m <module> …`` the module."""
    argv = list(argv)
    if not argv:
        raise LaunchError("no worker argv after '--': pass the job CLI "
                          "argv (JobName -D… <in> <out>), a script.py, "
                          "or -m <module>")
    if argv[0] == "-m":
        if len(argv) < 2:
            raise LaunchError("'-m' needs a module name")
        return [sys.executable, "-m", argv[1], *argv[2:]]
    if argv[0].endswith(".py"):
        return [sys.executable, *argv]
    return [sys.executable, "-m", "avenir_tpu_torch", *argv]


@dataclass
class WorkerResult:
    """One worker's teardown record."""

    rank: int
    returncode: Optional[int]
    output: str = ""
    finished_at: float = 0.0


@dataclass
class FleetResult:
    """What a local launch returned: the workers' records, the propagated
    exit code (the first non-zero exit in completion order: the worker
    that died first explains the fleet), the merged journal path, and the
    dead workers' forensics bundles swept at teardown."""

    workers: List[WorkerResult] = field(default_factory=list)
    exit_code: int = 0
    merged_journal: Optional[str] = None
    bundles: List[dict] = field(default_factory=list)

    def output_of(self, rank: int) -> str:
        return next(w.output for w in self.workers if w.rank == rank)


def merge_fleet_journal(journal_dir: str,
                        run_id: Optional[str] = None) -> Optional[str]:
    """Merge one run's journal shards under ``journal_dir`` (every writer
    suffix: ``run-<id>.proc-<k>[-<suffix>].jsonl``) into one time-ordered
    ``fleet-<run>.jsonl`` (``telemetry/journal.py::merge_journals``; torn
    tails and missing shards tolerated).  ``run_id`` pins the run, else
    the newest in the directory.  Returns the merged path, or None when
    the directory holds no shard."""
    import json

    from avenir_tpu_torch.telemetry.journal import merge_journals

    run_id, _shards, events = merge_journals(journal_dir, run_id=run_id)
    if run_id is None:
        return None
    out_path = os.path.join(journal_dir, f"fleet-{run_id}.jsonl")
    with open(out_path, "w", encoding="utf-8") as fh:
        for e in events:
            fh.write(json.dumps(e, separators=(",", ":")))
            fh.write("\n")
    return out_path


def _worker_env(base: Dict[str, str], rank: int, nprocs: int,
                coordinator: str, devices_per_proc: Optional[int],
                join_timeout_s: float, join_attempts: int) -> Dict[str, str]:
    env = dict(base)
    env[ENV_COORD] = coordinator
    env[ENV_NPROCS] = str(nprocs)
    env[ENV_PID] = str(rank)
    env[ENV_SUFFIX] = f"w{rank}"
    env[ENV_JOIN_TIMEOUT] = str(join_timeout_s)
    env[ENV_JOIN_ATTEMPTS] = str(join_attempts)
    if devices_per_proc:
        # K host shard slots a worker (parallel/mesh.py::host_slots): an
        # inherited count is replaced, so the worker's CPU mesh is K wide
        flags = [f for f in env.get("XLA_FLAGS", "").split()
                 if "xla_force_host_platform_device_count" not in f]
        flags.append(
            f"--xla_force_host_platform_device_count={devices_per_proc}")
        env["XLA_FLAGS"] = " ".join(flags)
    return env


def launch_local(child_argv: Sequence[str], nprocs: int, *,
                 devices_per_proc: Optional[int] = None,
                 coordinator: Optional[str] = None,
                 join_timeout_s: float = 300.0, join_attempts: int = 3,
                 timeout_s: float = 0.0, grace_s: float = 15.0,
                 env: Optional[Dict[str, str]] = None,
                 journal_dir: Optional[str] = None,
                 echo: bool = True) -> FleetResult:
    """Spawn ``nprocs`` local workers running ``child_argv``
    (:func:`worker_command`) as one fleet and tear it down: pump every
    worker's output (prefixed ``[p<k>]`` when ``echo``), enforce the wall
    deadline (``timeout_s`` > 0: expiry kills the fleet and raises
    :class:`LaunchError`), give the survivors of a dead worker ``grace_s``
    to notice before killing them (a peer blocked in a collective never
    returns), sweep dead workers' forensics bundles and merge the journal
    shards of ``journal_dir`` when given, and propagate the first non-zero
    exit in completion order."""
    import subprocess

    if nprocs < 1:
        raise LaunchError(f"--nprocs must be >= 1, got {nprocs}")
    cmd = worker_command(child_argv)
    coordinator = coordinator or f"localhost:{free_port()}"
    base_env = dict(os.environ if env is None else env)
    procs = []
    for rank in range(nprocs):
        wenv = _worker_env(base_env, rank, nprocs, coordinator,
                           devices_per_proc, join_timeout_s, join_attempts)
        procs.append(subprocess.Popen(
            cmd, env=wenv, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))

    outputs: List[List[str]] = [[] for _ in range(nprocs)]
    lock = threading.Lock()

    def pump(rank: int) -> None:
        try:
            for line in procs[rank].stdout:
                outputs[rank].append(line)
                if echo:
                    with lock:
                        sys.stdout.write(f"[p{rank}] {line}")
                        sys.stdout.flush()
        except Exception as e:            # noqa: BLE001
            # into the captured transcript: a dead reader must not
            # silently truncate a worker's output
            outputs[rank].append(f"[launcher] output pump died: {e!r}\n")

    readers = [threading.Thread(target=pump, args=(r,), daemon=True)
               for r in range(nprocs)]
    for t in readers:
        t.start()

    deadline = time.monotonic() + timeout_s if timeout_s > 0 else None
    finished: Dict[int, float] = {}
    first_failure_at: Optional[float] = None
    try:
        while len(finished) < nprocs:
            now = time.monotonic()
            for rank, p in enumerate(procs):
                if rank not in finished and p.poll() is not None:
                    finished[rank] = now
                    if p.returncode != 0 and first_failure_at is None:
                        first_failure_at = now
            if len(finished) == nprocs:
                break
            if deadline is not None and now > deadline:
                for p in procs:
                    p.kill()
                raise LaunchError(
                    f"fleet launch exceeded the {timeout_s:g}s deadline; "
                    f"still running: "
                    f"{sorted(set(range(nprocs)) - set(finished))} — "
                    f"workers killed")
            if first_failure_at is not None and \
                    now - first_failure_at > grace_s:
                for rank, p in enumerate(procs):
                    if rank not in finished:
                        p.kill()
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for t in readers:
            t.join(timeout=10)

    result = FleetResult()
    order = sorted(range(nprocs), key=lambda r: finished.get(r, float("inf")))
    for rank in range(nprocs):
        result.workers.append(WorkerResult(
            rank=rank, returncode=procs[rank].returncode,
            output="".join(outputs[rank]),
            finished_at=finished.get(rank, 0.0)))
    for rank in order:                       # first non-zero in time order
        rc = procs[rank].returncode
        if rc:
            result.exit_code = int(rc)
            break
    if journal_dir:
        # dead workers' bundles first: the sweep's bundle.written records
        # must exist before the merge reads the directory
        from avenir_tpu_torch.telemetry.blackbox import sweep

        for bb_dir in (journal_dir, os.path.join(journal_dir, "blackbox")):
            result.bundles.extend(sweep(bb_dir, journal_dir=journal_dir))
        result.merged_journal = merge_fleet_journal(journal_dir)
    return result
