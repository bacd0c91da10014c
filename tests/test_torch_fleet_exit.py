"""A port fleet's processes exit 0 once their work is done.

Each case spawns a two-rank and a three-rank fleet side by side.  Every
rank joins through ``init_distributed(init_method="file://…")`` (a
``FileStore`` rendezvous on gloo), runs one ``all_process_sum_state``
and exits, the ranks in a staggered order that rotates from case to
case.  To make the exit race of a group left up into interpreter
teardown show on every run rather than under rare load, each rank is
pinned to one CPU and gloo's native threads (``pt_gloo_runloop``,
``gloo_tcp_loop``) are moved to ``SCHED_IDLE`` after the join, and the
rank stays busy until it exits.  So a runloop thread releases the last
reference to its collective's tensors late, while the main thread
finalizes.  Without the exit hook of ``init_distributed`` a rank then
aborts (SIGABRT, "terminate called without an active exception").

Every return code must be 0 and no output may hold "terminate called".
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = """
import os, sys, time
store, rank, nprocs, first = sys.argv[1], *map(int, sys.argv[2:5])
cpus = sorted(os.sched_getaffinity(0))
os.sched_setaffinity(0, {cpus[rank % len(cpus)]})   # threads made later inherit it
import numpy as np
from avenir_tpu_torch.parallel.mesh import all_process_sum_state, init_distributed
assert init_distributed(init_method="file://" + store, num_processes=nprocs,
                        process_id=rank, timeout_s=60) == rank
for tid in os.listdir("/proc/self/task"):
    with open(f"/proc/self/task/{tid}/comm") as fh:
        if fh.read().startswith(("pt_gloo", "gloo")):
            os.sched_setscheduler(int(tid), os.SCHED_IDLE, os.sched_param(0))
out = all_process_sum_state({"x": np.arange(4, dtype=np.int64) + rank})
want = [sum(range(nprocs)) + i * nprocs for i in range(4)]
assert out["x"].tolist() == want, (out, want)
end = time.perf_counter() + 0.1 * ((rank - first) % nprocs)
while time.perf_counter() < end:
    pass                        # busy, so the runloop threads stay starved
print(f"rank {rank} done", flush=True)
"""


@pytest.mark.parametrize("case", range(4))
def test_fleet_ranks_exit_zero_after_their_work(case, tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = []
    for nprocs in (2, 3):
        store = tmp_path / f"store{nprocs}"
        first = case % nprocs
        procs += [(nprocs, rank, subprocess.Popen(
            [sys.executable, "-c", WORKER, str(store), str(rank),
             str(nprocs), str(first)],
            env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)) for rank in range(nprocs)]
    outs = []
    try:
        for nprocs, rank, p in procs:
            outs.append((nprocs, rank, p.communicate(timeout=120)[0]))
    finally:
        for _n, _r, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for (nprocs, rank, p), (_n, _r, out) in zip(procs, outs):
        assert p.returncode == 0 and "terminate called" not in out, (
            f"fleet of {nprocs}, rank {rank}: exit {p.returncode}\n{out}")
        assert f"rank {rank} done" in out
