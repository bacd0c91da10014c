"""The port's fleet launcher and the fleet side of its telemetry
(``avenir_tpu_torch/launch/``, the CLI's join and writer suffix, the
process index in spans, exports and black-box bundles), against the JAX
package's where both have the same function.

The children ``launch_local`` spawns here never join a fleet: they are
small scripts that print the launcher's env contract and exit, so no
test starts a coordinator, picks a port number or hands one on (the
coordinator address given is ``localhost:9``, where nothing listens).
The bounded join is held against the same address: it must raise the
typed ``LaunchError`` naming it within its timeout.
"""

import json
import os
import sys
import time

import pytest

from avenir_tpu.launch import merge_fleet_journal as jmerge_fleet_journal
from avenir_tpu.launch import pod_env as jpod_env
from avenir_tpu.launch import worker_command as jworker_command
from avenir_tpu_torch import launch
from avenir_tpu_torch.core.config import JobConfig
from avenir_tpu_torch.launch.__main__ import main as launch_main
from avenir_tpu_torch.telemetry import spans as tel
from avenir_tpu_torch.telemetry.journal import Journal, read_events

NOWHERE = "localhost:9"          # the discard port: nothing listens there


@pytest.fixture(autouse=True)
def _tracer_off():
    yield
    tel.tracer().disable()


def _script(tmp_path, body):
    path = tmp_path / "child.py"
    path.write_text("import os, sys, time\n"
                    "rank = int(os.environ['AVENIR_PROCESS_ID'])\n" + body)
    return str(path)


# ---------------------------------------------------------------------------
# the env contract and launch_local's teardown
# ---------------------------------------------------------------------------

def test_launch_local_writes_the_env_contract(tmp_path):
    child = _script(tmp_path, (
        "keys = ['AVENIR_COORDINATOR_ADDRESS', 'AVENIR_NUM_PROCESSES',\n"
        "        'AVENIR_PROCESS_ID', 'AVENIR_WRITER_SUFFIX',\n"
        "        'AVENIR_JOIN_TIMEOUT_SEC', 'AVENIR_JOIN_ATTEMPTS']\n"
        "print(' '.join(os.environ[k] for k in keys))\n"
        "print(os.environ['XLA_FLAGS'])\n"))
    res = launch.launch_local(
        [child], 3, coordinator=NOWHERE, join_timeout_s=7.5,
        join_attempts=2, devices_per_proc=4, echo=False,
        env=dict(os.environ,
                 XLA_FLAGS="--xla_force_host_platform_device_count=8 --x"))
    assert res.exit_code == 0 and res.merged_journal is None
    for rank in range(3):
        first, flags = res.output_of(rank).splitlines()
        assert first == f"{NOWHERE} 3 {rank} w{rank} 7.5 2"
        assert flags.split() == ["--x",
                                 "--xla_force_host_platform_device_count=4"]


def test_launch_local_propagates_first_nonzero_exit(tmp_path):
    """The first worker to fail explains the fleet: rank 1 exits 3 at
    once, rank 0 exits 5 later, and rank 2, blocked as a peer in a
    collective would be, is killed after the grace window."""
    child = _script(tmp_path, (
        "if rank == 1: sys.exit(3)\n"
        "if rank == 0: time.sleep(0.5); sys.exit(5)\n"
        "time.sleep(60)\n"))
    t0 = time.monotonic()
    res = launch.launch_local([child], 3, coordinator=NOWHERE, grace_s=1.0,
                              echo=False)
    assert time.monotonic() - t0 < 30
    assert res.exit_code == 3
    codes = {w.rank: w.returncode for w in res.workers}
    assert codes[0] == 5 and codes[1] == 3 and codes[2] != 0


def test_launch_local_deadline_kills_the_fleet(tmp_path):
    child = _script(tmp_path, "time.sleep(60)\n")
    t0 = time.monotonic()
    with pytest.raises(launch.LaunchError, match="1s deadline"):
        launch.launch_local([child], 2, coordinator=NOWHERE, timeout_s=1.0,
                            echo=False)
    assert time.monotonic() - t0 < 30


def test_launch_cli_exit_code_and_refusals(tmp_path, capsys):
    child = _script(tmp_path, "sys.exit(0 if rank == 0 else 4)\n")
    assert launch_main(["--nprocs", "2", "--coordinator", NOWHERE, "--",
                        child]) == 4
    err = capsys.readouterr().err
    assert "[launch] worker p1 exit=4" in err
    with pytest.raises(NotImplementedError, match="Queue 1 item 7h-ii"):
        launch_main(["--serve", "--nprocs", "2"])
    with pytest.raises(SystemExit):
        launch_main(["--", child])       # no --nprocs outside a pod
    with pytest.raises(launch.LaunchError, match="--nprocs must be >= 1"):
        launch.launch_local([child], 0)


@pytest.mark.parametrize("argv", [
    ["BayesianDistribution", "-Dx=1", "in", "out"],
    ["script.py", "--flag"], ["-m", "some.module", "a"]])
def test_worker_command_shapes(argv):
    got = launch.worker_command(argv)
    want = jworker_command(argv)
    assert got[0] == want[0] == sys.executable
    assert got[1:] == [a.replace("avenir_tpu", "avenir_tpu_torch")
                       if a == "avenir_tpu" else a for a in want[1:]]


@pytest.mark.parametrize("argv", [[], ["-m"]])
def test_worker_command_refuses(argv):
    with pytest.raises(launch.LaunchError):
        launch.worker_command(argv)


@pytest.mark.parametrize("environ", [
    {}, {"AVENIR_PROCESS_ID": "1"},
    {"AVENIR_PROCESS_ID": "1", "AVENIR_NUM_PROCESSES": "4"},
    {"AVENIR_PROCESS_ID": "2", "AVENIR_NUM_PROCESSES": "3",
     "AVENIR_COORDINATOR_ADDRESS": "h:1"}])
def test_pod_env_equals_jax(environ):
    assert launch.pod_env(environ) == jpod_env(environ)


# ---------------------------------------------------------------------------
# the bounded join
# ---------------------------------------------------------------------------

def test_join_against_nothing_raises_typed_within_timeout():
    from avenir_tpu_torch.parallel.mesh import init_distributed, process_grid

    t0 = time.monotonic()
    with pytest.raises(launch.LaunchError, match=NOWHERE) as err:
        init_distributed(coordinator_address=NOWHERE, num_processes=2,
                         process_id=1, timeout_s=1.5, attempts=2)
    assert time.monotonic() - t0 < 10
    assert "was not reachable within 1.5s" in str(err.value)
    assert process_grid() == (0, 1)            # no group was left behind
    with pytest.raises(launch.LaunchError, match="not host:port"):
        init_distributed(coordinator_address="nohostport", num_processes=2,
                         process_id=1, timeout_s=1)
    with pytest.raises(ValueError, match="outside a fleet"):
        init_distributed(coordinator_address=NOWHERE, num_processes=2,
                         process_id=2)
    assert init_distributed() == 0             # nothing describes a fleet


def test_cli_joins_from_the_env_before_any_work(tmp_path, monkeypatch):
    from avenir_tpu_torch.__main__ import main

    for key, val in (("AVENIR_NUM_PROCESSES", "2"), ("AVENIR_PROCESS_ID", "1"),
                     ("AVENIR_COORDINATOR_ADDRESS", NOWHERE),
                     ("AVENIR_JOIN_TIMEOUT_SEC", "1"),
                     ("AVENIR_JOIN_ATTEMPTS", "1")):
        monkeypatch.setenv(key, val)
    with pytest.raises(launch.LaunchError, match=NOWHERE):
        main(["NoSuchJob", "in", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()


# ---------------------------------------------------------------------------
# the writer suffix, the process index and the merged fleet view
# ---------------------------------------------------------------------------

def test_cli_adopts_the_launcher_writer_suffix(tmp_path, monkeypatch):
    from avenir_tpu_torch.__main__ import main
    from avenir_tpu_torch.core.csv_io import write_csv
    from avenir_tpu_torch.datagen.churn import (CHURN_SCHEMA_JSON,
                                                generate_churn)

    write_csv(str(tmp_path / "train.csv"), generate_churn(300, seed=1))
    (tmp_path / "churn.json").write_text(json.dumps(CHURN_SCHEMA_JSON))
    monkeypatch.setenv("AVENIR_WRITER_SUFFIX", "w3")
    argv = ["BayesianDistribution",
            f"-Dfeature.schema.file.path={tmp_path / 'churn.json'}",
            "-Dtrace.on=true", f"-Dtrace.journal.dir={tmp_path / 'tel'}",
            "-Dtrace.run.id=cli", str(tmp_path / "train.csv"),
            str(tmp_path / "nb"), "--device", "cpu"]
    assert main(argv) == 0
    tel.tracer().disable()
    names = [n for n in os.listdir(tmp_path / "tel") if n.endswith(".jsonl")]
    assert names == ["run-cli.proc-0-w3.jsonl"]
    events = read_events(str(tmp_path / "tel" / names[0]))
    assert {e["replica"] for e in events} == {"w3"}
    # an explicit conf key wins over the env
    tracer = tel.configure(JobConfig({
        "trace.on": "true", "trace.journal.dir": str(tmp_path / "t2"),
        "trace.writer.suffix": "router"}))
    assert tracer.journal_path.endswith(".proc-0-router.jsonl")


def test_process_index_in_exports_and_blackbox(monkeypatch):
    from avenir_tpu_torch.telemetry import export
    from avenir_tpu_torch.telemetry.blackbox import BlackBox

    assert export.fleet_identity(replica="w0") == {"process": "0",
                                                   "replica": "w0"}
    assert BlackBox._process_index() == 0
    monkeypatch.setenv("AVENIR_PROCESS_ID", "3")
    assert BlackBox._process_index() == 3


def _shards(d):
    for k, sfx in enumerate(("w0", "w1", "router")):
        jl = Journal(os.path.join(d, f"run-fl.proc-{k}-{sfx}.jsonl"),
                     stamp={"proc": k, "host": "h", "replica": sfx})
        for i in range(3):
            jl.emit("canary", ms=float(i), when="pre_run")
            time.sleep(0.002)
        jl.close()
    jl = Journal(os.path.join(d, "run-old.proc-0.jsonl"),
                 stamp={"proc": 0, "host": "h"})
    jl.emit("canary", ms=9.0, when="pre_run")
    jl.close()
    old = os.path.join(d, "run-old.proc-0.jsonl")
    os.utime(old, (time.time() - 600, time.time() - 600))


def test_merge_fleet_journal_equals_jax(tmp_path):
    """The same shard files merge into the same fleet view in both
    packages: every writer suffix of the newest run (or the pinned one),
    time-ordered."""
    for name in ("port", "jax"):
        os.makedirs(tmp_path / name)
    _shards(str(tmp_path / "port"))
    import shutil

    for f in os.listdir(tmp_path / "port"):
        shutil.copy2(tmp_path / "port" / f, tmp_path / "jax" / f)
    got = launch.merge_fleet_journal(str(tmp_path / "port"))
    want = jmerge_fleet_journal(str(tmp_path / "jax"))
    assert os.path.basename(got) == os.path.basename(want) == "fleet-fl.jsonl"
    assert open(got).read() == open(want).read()
    assert {e["replica"] for e in read_events(got)} == {"w0", "w1", "router"}
    pinned = launch.merge_fleet_journal(str(tmp_path / "port"),
                                        run_id="old")
    assert pinned.endswith("fleet-old.jsonl")
    os.makedirs(tmp_path / "empty")
    assert launch.merge_fleet_journal(str(tmp_path / "empty")) is None
