"""Fleet launcher CLI — ``python -m avenir_tpu_torch.launch``; port of
``avenir_tpu/launch/__main__.py``.

- **spawn** (``--nprocs N``): bring up N local worker processes as one
  fleet over a local coordinator, run the worker argv in each, merge the
  journal shards, propagate the first non-zero exit;
- **join** (no ``--nprocs``, ``AVENIR_PROCESS_ID`` set): the scheduler
  started every rank itself — exec the worker argv in place; it joins
  through its environment;
- **serve** (``--serve --conf serve.properties --nprocs N``): bring up N
  full serving planes (one ``python -m avenir_tpu_torch.serving`` process
  each, on ``--device``, a ReplicaPool inside when ``pool.*`` is armed)
  and front them with the tenant-aware
  :class:`~avenir_tpu_torch.serving.global_pool.GlobalRouter` on
  ``fleet.http.port`` (or ``--http-port``; 0 binds an ephemeral port that
  the startup line names); on SIGTERM every shard — workers, tenants and
  the router — merges into one ``fleet-<run>.jsonl`` and the router's
  stats print.  ``--conf``, ``--http-port`` and ``--device`` belong to
  this mode only; an argv after ``--`` here starts each worker in place
  of ``python -m avenir_tpu_torch.serving`` (a wrapper taking the
  serving CLI's arguments, which follow it).

Examples::

    # 2 workers on the card, job CLI argv
    python -m avenir_tpu_torch.launch --nprocs 2 -- \\
        BayesianDistribution -Dconf.path=churn.properties train.csv out/

    # 2 workers × 4 CPU shard slots each
    python -m avenir_tpu_torch.launch --nprocs 2 --devices-per-proc 4 -- \\
        StreamAnalytics -Dshard.devices=4 ... train.csv win --device cpu

    # a 2-process serving fleet behind one logical frontend
    python -m avenir_tpu_torch.launch --serve --conf serve.properties --nprocs 2
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List

from avenir_tpu_torch.launch import (LaunchError, launch_local, pod_env,
                                     worker_command)


def main(argv: List[str]) -> int:
    if "--" in argv:
        cut = argv.index("--")
        opts, child = argv[:cut], argv[cut + 1:]
    else:
        opts, child = argv, []
    ap = argparse.ArgumentParser(
        prog="python -m avenir_tpu_torch.launch",
        description="Spawn (or join) a fleet of worker processes and run "
                    "a job or script argv in every worker")
    ap.add_argument("--nprocs", type=int, default=0,
                    help="workers to spawn locally (omit inside an "
                         "externally provisioned pod)")
    ap.add_argument("--devices-per-proc", type=int, default=0,
                    help="CPU shard slots per worker "
                         "(xla_force_host_platform_device_count)")
    ap.add_argument("--coordinator", default=None,
                    help="coordinator host:port (default: localhost on a "
                         "free port)")
    ap.add_argument("--join-timeout-sec", type=float, default=300.0,
                    help="per-attempt join timeout (default 300; a bad "
                         "address fails typed, never hangs)")
    ap.add_argument("--join-attempts", type=int, default=3,
                    help="join attempts under decorrelated jitter "
                         "(default 3)")
    ap.add_argument("--timeout-sec", type=float, default=0.0,
                    help="overall fleet wall deadline (0 = none)")
    ap.add_argument("--journal-dir", default=None,
                    help="trace.journal.dir of the workers; shards are "
                         "merged into fleet-<run>.jsonl on teardown")
    ap.add_argument("--serve", action="store_true",
                    help="serving mode: front --nprocs serving worker "
                         "processes (built from --conf) with one "
                         "GlobalRouter on fleet.http.port")
    ap.add_argument("--conf", default=None,
                    help="(--serve) serving properties file, shared by "
                         "every worker process")
    ap.add_argument("--http-port", type=int, default=None,
                    help="(--serve) override fleet.http.port for the "
                         "router frontend (0: an ephemeral port)")
    ap.add_argument("--device", default=None,
                    help="(--serve) the workers' device: cuda (default) "
                         "or cpu")
    args = ap.parse_args(opts)

    if args.serve:
        if not args.conf:
            ap.error("--serve requires --conf <serve.properties>")
        if args.nprocs < 1:
            ap.error("--serve requires --nprocs >= 1")
        # lazy import: the launcher module itself stays stdlib-only at
        # import (the join-mode exec path must not pay a torch import)
        from avenir_tpu_torch.serving.global_pool import serve_fleet

        try:
            return serve_fleet(
                args.conf, args.nprocs, http_port=args.http_port,
                device=args.device,
                command=worker_command(child) if child else None)
        except LaunchError as e:
            print(f"launch error: {e}", file=sys.stderr)
            return 3
    for flag, value in (("--conf", args.conf), ("--http-port", args.http_port),
                        ("--device", args.device)):
        if value is not None:
            ap.error(f"{flag} belongs to --serve")
    try:
        if not args.nprocs:
            if pod_env() is None:
                ap.error("--nprocs is required outside an externally "
                         "provisioned pod (AVENIR_PROCESS_ID / "
                         "AVENIR_NUM_PROCESSES unset)")
            # join mode: the environment names this rank — exec the worker
            # in place (it joins through its environment)
            cmd = worker_command(child)
            os.execv(cmd[0], cmd)                      # never returns
        result = launch_local(
            child, args.nprocs,
            devices_per_proc=args.devices_per_proc or None,
            coordinator=args.coordinator,
            join_timeout_s=args.join_timeout_sec,
            join_attempts=args.join_attempts,
            timeout_s=args.timeout_sec,
            journal_dir=args.journal_dir)
    except LaunchError as e:
        print(f"launch error: {e}", file=sys.stderr)
        return 3
    for w in result.workers:
        print(f"[launch] worker p{w.rank} exit={w.returncode}",
              file=sys.stderr)
    for b in result.bundles:
        print(f"[launch] blackbox bundle: {b['dir']} ({b['reason']})",
              file=sys.stderr)
    if result.merged_journal:
        print(f"[launch] merged fleet journal: {result.merged_journal}",
              file=sys.stderr)
    return result.exit_code


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
