"""Fleet launcher CLI — ``python -m avenir_tpu_torch.launch``; port of
``avenir_tpu/launch/__main__.py``.

- **spawn** (``--nprocs N``): bring up N local worker processes as one
  fleet over a local coordinator, run the worker argv in each, merge the
  journal shards, propagate the first non-zero exit;
- **join** (no ``--nprocs``, ``AVENIR_PROCESS_ID`` set): the scheduler
  started every rank itself — exec the worker argv in place; it joins
  through its environment.

The serving fleet (``--serve``, the JAX package's GlobalServe) is
ROADMAP.md, Queue 1 item 7h-ii, and is refused.

Examples::

    # 2 workers on the card, job CLI argv
    python -m avenir_tpu_torch.launch --nprocs 2 -- \\
        BayesianDistribution -Dconf.path=churn.properties train.csv out/

    # 2 workers × 4 CPU shard slots each
    python -m avenir_tpu_torch.launch --nprocs 2 --devices-per-proc 4 -- \\
        StreamAnalytics -Dshard.devices=4 ... train.csv win --device cpu
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
    if "--serve" in opts:
        raise NotImplementedError(
            "launch --serve (the serving fleet behind a global router) is "
            "not ported yet (ROADMAP.md, Queue 1 item 7h-ii)")
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
    args = ap.parse_args(opts)
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
