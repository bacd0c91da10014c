"""The port's flight recorder (``avenir_tpu_torch/telemetry/blackbox.py``)
on the CPU; copies of ``tests/test_blackbox.py`` where they apply: the
flight ring, forensics bundles, the progress watchdog, the teardown
sweep, and the kill drill — a SIGKILLed worker (no hook runs) and a
crashing job, both with ``trace.on`` unset, each leaving a bundle that
the sweep journals exactly once and ``telemetry bundle`` renders.

Every test resets the box in teardown: it installs process-global hooks
(excepthook, SIGTERM) that must not leak into other tests.  The drill's
worker is this file's ``__main__`` block, run in a fresh subprocess.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from avenir_tpu_torch.core.config import JobConfig  # noqa: E402
from avenir_tpu_torch.telemetry import __main__ as cli  # noqa: E402
from avenir_tpu_torch.telemetry import blackbox  # noqa: E402
from avenir_tpu_torch.telemetry import spans as tel  # noqa: E402
from avenir_tpu_torch.telemetry.journal import read_events  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_box():
    blackbox.ring_clear()
    tel.tracer().disable()
    yield
    tel.tracer().disable()
    blackbox.reset()
    blackbox.ring_clear()


# ---------------------------------------------------------------------------
# the flight ring
# ---------------------------------------------------------------------------

def test_ring_records_oldest_first_and_bounded():
    from avenir_tpu.telemetry import blackbox as jblackbox

    jblackbox.ring_clear()
    try:
        for box in (blackbox, jblackbox):
            for i in range(5):
                box.ring_record("probe", {"i": i})
        snap = blackbox.ring_snapshot()
        assert [r["i"] for r in snap] == [0, 1, 2, 3, 4]
        assert all(r["ev"] == "probe" and r["ts"] > 0 for r in snap)
        strip = lambda s: [{k: v for k, v in r.items() if k != "ts"}  # noqa: E731
                           for r in s]
        assert strip(snap) == strip(jblackbox.ring_snapshot())
    finally:
        jblackbox.ring_clear()
    blackbox._ring_resize(16)
    for i in range(40):
        blackbox.ring_record("flood", {"i": i})
    snap = blackbox.ring_snapshot()
    assert len(snap) == 16 and snap[-1]["i"] == 39 and snap[0]["i"] == 24
    blackbox._ring_resize(blackbox.DEFAULT_RING_EVENTS)


def test_emit_seams_record_with_tracing_off():
    t = tel.Tracer()                    # never enabled
    t.event("checkpoint.save", scope="s", run="r")
    t.event_once("shard.topology", key="k", devices=8)
    t.gauge("serve.queue.depth", 3.0)
    evs = [r["ev"] for r in blackbox.ring_snapshot()]
    assert {"checkpoint.save", "shard.topology", "gauge"} <= set(evs)
    assert t.journal is None


def test_off_state_span_site_unchanged():
    """Disabled ``span()`` returns the shared NOOP object and does not
    touch the ring: the off state of every span site is one attribute
    check."""
    t = tel.Tracer()
    before = len(blackbox.ring_snapshot())
    assert t.span("probe") is tel.NOOP_SPAN
    with t.span("probe"):
        pass
    assert len(blackbox.ring_snapshot()) == before


# ---------------------------------------------------------------------------
# the progress watchdog
# ---------------------------------------------------------------------------

def test_watchdog_trips_once_per_excursion():
    wd = blackbox.Watchdog()
    wd.sec = 0.05
    wd.enter("fold")
    wd.enter("job.BayesianDistribution")
    try:
        wd.last_progress = time.monotonic() - 1.0
        wd._guards["fold"][1] -= 5.0
        wd.check_once()
        hangs = [r for r in blackbox.ring_snapshot()
                 if r["ev"] == "hang.detected"]
        assert len(hangs) == 1
        assert hangs[0]["site"] == "fold"
        assert hangs[0]["silent_s"] >= 0.05
        assert hangs[0]["threshold"] == 0.05
        wd.last_progress = time.monotonic() - 1.0
        wd.check_once()                 # still the same excursion
        assert len([r for r in blackbox.ring_snapshot()
                    if r["ev"] == "hang.detected"]) == 1
        wd.beat()
        wd.check_once()
        assert wd.snapshot()["tripped"] is False
    finally:
        wd.exit("job.BayesianDistribution")
        wd.exit("fold")


def test_watchdog_guard_off_is_shared_nullcontext():
    assert blackbox.watchdog_guard("fold") is blackbox._NULL_GUARD
    snap = blackbox.Watchdog().snapshot()
    assert snap["active"] == {} and snap["sec"] == 0.0


def test_job_body_and_fold_are_guarded(tmp_path):
    """With ``blackbox.watchdog.sec`` set, a job's body and its SharedScan
    folds run inside watchdog guards (the JAX package's two batch
    seams)."""
    from avenir_tpu_torch.core.csv_io import write_csv
    from avenir_tpu_torch.datagen.hosp_readmit import (HOSP_SCHEMA_JSON,
                                                      generate_hosp_readmit)
    from avenir_tpu_torch.pipeline import scan

    write_csv(str(tmp_path / "train.csv"), generate_hosp_readmit(300, seed=2))
    (tmp_path / "hosp.json").write_text(json.dumps(HOSP_SCHEMA_JSON))
    seen = []
    fold = scan.ChunkFolder._fold

    def spy(self, ds, acc):
        seen.append(sorted(blackbox._WATCHDOG.snapshot()["active"]))
        return fold(self, ds, acc)

    scan.ChunkFolder._fold = spy
    try:
        from avenir_tpu_torch.pipeline.driver import Pipeline, Stage

        p = Pipeline(str(tmp_path / "ws"), JobConfig({
            "feature.schema.file.path": str(tmp_path / "hosp.json"),
            "stream.chunk.rows": "200", "blackbox.watchdog.sec": "600"}),
            device="cpu")
        p.bind("train", str(tmp_path / "train.csv"))
        p.add(Stage("nb", "BayesianDistribution", "train", "nb_model"))
        p.add(Stage("mi", "MutualInformation", "train", "mi_out"))
        p.run()
    finally:
        scan.ChunkFolder._fold = fold
    assert seen == [["fold"], ["fold"]]
    from avenir_tpu_torch.jobs import get_job

    job = get_job("BayesianDistribution")
    execute = job.execute

    def spy_execute(conf, inp, out, counters):
        seen.append(sorted(blackbox._WATCHDOG.snapshot()["active"]))
        return execute(conf, inp, out, counters)

    job.execute = spy_execute
    job.run(JobConfig({"feature.schema.file.path": str(tmp_path / "hosp.json"),
                       "blackbox.watchdog.sec": "600"}),
            str(tmp_path / "train.csv"), str(tmp_path / "nb"), device="cpu")
    assert seen[-1] == ["job.BayesianDistribution"]


# ---------------------------------------------------------------------------
# the bundle writer
# ---------------------------------------------------------------------------

def _arm(tmp_path, **extra):
    props = {"blackbox.dir": str(tmp_path / "bb"),
             "blackbox.flush.sec": "0",
             "trace.run.id": "boxtest"}
    props.update({k: str(v) for k, v in extra.items()})
    conf = JobConfig(props)
    blackbox.configure(conf)
    return conf


def test_arm_finalize_and_latch(tmp_path):
    _arm(tmp_path)
    box = blackbox.box()
    assert box.armed and os.path.isdir(box.bundle_path)
    assert os.path.basename(box.bundle_path) == "bundle-boxtest-proc-0"
    assert blackbox.read_meta(box.bundle_path)["status"] == "live"
    blackbox.ring_record("checkpoint.save", {"dir": "d", "run": "r"})
    path = blackbox.finalize("crash:TestError", "Traceback: boom")
    assert path == box.bundle_path
    for name in ("ring.jsonl", "stacks.txt", "inflight.json", "state.json",
                 "memory.json", "conf.json", "meta.json"):
        assert os.path.isfile(os.path.join(path, name)), name
    meta = blackbox.read_meta(path)
    assert meta["status"] == "final"
    assert meta["reason"] == "crash:TestError"
    assert meta["journaled"] is False
    assert meta["events"] > 0
    assert "Traceback: boom" in open(os.path.join(path, "stacks.txt")).read()
    state = json.load(open(os.path.join(path, "state.json")))
    assert state["arbiter"] is None and "watchdog" in state
    ring = [r for r in blackbox.ring_snapshot()
            if r["ev"] == "bundle.written"]
    assert len(ring) == 1 and ring[0]["dir"] == path
    assert blackbox.finalize("crash:Second") is None


def test_capture_is_non_latching(tmp_path):
    _arm(tmp_path)
    box = blackbox.box()
    first = blackbox.capture("smoke:a")
    second = blackbox.capture("smoke:b")
    assert first == box.bundle_path + "-c1"
    assert second == box.bundle_path + "-c2"
    assert blackbox.read_meta(first)["reason"] == "smoke:a"
    assert blackbox.finalize("crash:Later") == box.bundle_path


def test_unarmed_configure_is_inert(tmp_path):
    """No ``blackbox.dir``: nothing armed, no hook installed, no thread."""
    hook, thread_hook = sys.excepthook, threading.excepthook
    blackbox.configure(JobConfig({}))
    assert not blackbox.box().armed
    assert sys.excepthook is hook
    assert threading.excepthook is thread_hook
    assert blackbox.finalize("crash:Nope") is None
    assert blackbox.capture("smoke:x") is None


def test_bundle_journaled_when_tracing_on(tmp_path):
    conf = JobConfig({"blackbox.dir": str(tmp_path / "bb"),
                      "blackbox.flush.sec": "0",
                      "trace.on": "true",
                      "trace.journal.dir": str(tmp_path / "tel"),
                      "trace.run.id": "boxtest"})
    tel.configure(conf)
    try:
        path = blackbox.finalize("crash:Traced")
        assert blackbox.read_meta(path)["journaled"] is True
    finally:
        journal_path = tel.tracer().journal_path
        tel.tracer().disable()
    written = [e for e in read_events(journal_path)
               if e.get("ev") == "bundle.written"]
    assert len(written) == 1
    assert written[0]["dir"] == path and written[0]["reason"] == "crash:Traced"


def test_sweep_journals_each_dead_bundle_exactly_once(tmp_path):
    bb = tmp_path / "bb" / "bundle-r1-proc-0-wx"
    bb.mkdir(parents=True)
    dead_pid = 2 ** 22 + 12345               # beyond pid_max: never alive
    bb.joinpath("meta.json").write_text(json.dumps(
        {"status": "live", "reason": "", "pid": dead_pid, "run": "r1",
         "writer": "proc-0-wx", "journaled": False, "events": 7}))
    tel_dir = tmp_path / "tel"
    recs = blackbox.sweep(str(tmp_path / "bb"), journal_dir=str(tel_dir),
                          run_id="r1")
    assert len(recs) == 1
    assert recs[0]["status"] == "swept" and recs[0]["reason"] == "killed"
    assert recs[0]["journaled"] is True
    meta = blackbox.read_meta(str(bb))
    assert meta["status"] == "swept" and meta["journaled"] is True
    recs2 = blackbox.sweep(str(tmp_path / "bb"), journal_dir=str(tel_dir),
                           run_id="r1")
    assert len(recs2) == 1
    shards = [n for n in os.listdir(tel_dir) if n.endswith("-sweep.jsonl")]
    assert shards == ["run-r1.proc-0-sweep.jsonl"]
    events = read_events(str(tel_dir / shards[0]))
    assert [e["ev"] for e in events] == ["bundle.written"]
    assert events[0]["events"] == 7


def test_sweep_skips_live_bundles_of_running_processes(tmp_path):
    bb = tmp_path / "bb" / "bundle-r1-proc-0-live"
    bb.mkdir(parents=True)
    bb.joinpath("meta.json").write_text(json.dumps(
        {"status": "live", "pid": os.getpid(), "run": "r1",
         "writer": "proc-0-live", "journaled": False, "events": 1}))
    assert blackbox.sweep(str(tmp_path / "bb")) == []


# ---------------------------------------------------------------------------
# the CLI renderers, held against the JAX package's
# ---------------------------------------------------------------------------

def test_bundle_cli_renders_postmortem(tmp_path, capsys):
    from avenir_tpu.telemetry import __main__ as jcli

    _arm(tmp_path)
    blackbox.ring_record("span.open", {"span": "s1", "name": "fold"})
    blackbox.register_provider(
        "stream-t", lambda: [{"rid": "chunk-0", "state": "staged",
                              "age_ms": 9}], kind="inflight")
    try:
        path = blackbox.finalize("crash:CliTest", "Traceback: cli")
    finally:
        blackbox.unregister_provider("stream-t")
    assert cli.main(["bundle", path]) == 0
    out = capsys.readouterr().out
    assert "reason=crash:CliTest" in out
    assert "slowest open span: fold" in out
    assert "[stream-t] rid=chunk-0" in out and "state=staged" in out
    assert "Traceback: cli" in out
    assert jcli.main(["bundle", path]) == 0
    assert capsys.readouterr().out == out
    assert cli.main(["bundle", str(tmp_path)]) == 2


def test_diff_cli_per_program_and_stage_deltas(tmp_path, capsys):
    from avenir_tpu.telemetry import __main__ as jcli

    def journal(name, wall, dur):
        path = tmp_path / name
        events = [
            {"ev": "canary", "ms": 2.0},
            {"ev": "program.compiled", "key": "scan/0", "site": "fold",
             "flops": 1e9},
            {"ev": "program.profile", "key": "scan/0", "site": "fold",
             "dispatches": 10, "wall_ms": wall},
            {"ev": "span.open", "span": "s1", "name": "fold", "ts": 1.0},
            {"ev": "span.close", "span": "s1", "dur_ms": dur},
        ]
        path.write_text("\n".join(json.dumps(e) for e in events) + "\n")
        return str(path)

    a = journal("a.jsonl", wall=50.0, dur=40.0)
    b = journal("b.jsonl", wall=80.0, dur=70.0)
    assert cli.main(["diff", a, b]) == 0
    out = capsys.readouterr().out
    assert "scan/0" in out and out.count("+30.0") >= 2
    assert "MFU" in out and "canary peak" in out
    assert jcli.main(["diff", a, b]) == 0
    assert capsys.readouterr().out == out


def test_stage_walls_maps_span_names():
    events = [{"ev": "span.open", "span": "a", "name": "fold"},
              {"ev": "span.close", "span": "a", "dur_ms": 5.0},
              {"ev": "span.open", "span": "b", "name": "fold"},
              {"ev": "span.close", "span": "b", "dur_ms": 7.0},
              {"ev": "span.open", "span": "c", "name": "open-forever"}]
    assert cli.stage_walls(events) == {"fold": [2, 12.0]}


# ---------------------------------------------------------------------------
# the kill drill: fresh subprocesses, trace.on unset
# ---------------------------------------------------------------------------

def _worker_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def _wait_for_inflight(bundle, rid, timeout_s=60.0):
    """Poll the live bundle's spilled in-flight table until ``rid`` shows:
    the kill lands mid-flight by construction."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            with open(os.path.join(bundle, "inflight.json"),
                      encoding="utf-8") as fh:
                tables = json.load(fh)
        except (OSError, ValueError):
            tables = {}
        for rows in tables.values():
            if isinstance(rows, list) and any(
                    isinstance(r, dict) and r.get("rid") == rid
                    for r in rows):
                return tables
        time.sleep(0.1)
    raise AssertionError(f"{rid} never showed in {bundle}/inflight.json")


def test_kill_drill_subprocess(tmp_path, capsys):
    """One worker SIGKILLed mid-flight (no hook runs: the flush thread's
    live bundle is the record), one job dying on an injected crash (the
    excepthook writes the bundle), both with ``trace.on`` unset.  The
    sweep journals exactly one ``bundle.written`` per dead worker, the
    merged view holds both, and ``telemetry bundle`` renders the
    victim's post-mortem with its in-flight chunks."""
    from avenir_tpu_torch.core.csv_io import write_csv
    from avenir_tpu_torch.datagen.hosp_readmit import (HOSP_SCHEMA_JSON,
                                                      generate_hosp_readmit)
    from avenir_tpu_torch.telemetry.journal import merge_journals

    write_csv(str(tmp_path / "train.csv"), generate_hosp_readmit(600, seed=4))
    (tmp_path / "hosp.json").write_text(json.dumps(HOSP_SCHEMA_JSON))
    env = _worker_env()
    bb_dir = str(tmp_path / "bb")

    crash = subprocess.run([sys.executable, __file__, "crash", str(tmp_path)],
                           env=env, capture_output=True, text=True,
                           timeout=300)
    assert crash.returncode != 0
    assert "injected crash after chunk" in crash.stderr, crash.stderr

    proc = subprocess.Popen(
        [sys.executable, __file__, "sigkill", str(tmp_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        seen = []
        for line in proc.stdout:
            seen.append(line)
            if "READY" in line:
                break
        else:
            raise AssertionError(
                f"worker exited before READY:\n{''.join(seen)}"
                f"{proc.stderr.read()}")
        victim = os.path.join(bb_dir, "bundle-bbdrill-proc-0-w0")
        _wait_for_inflight(victim, "chunk-0")
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    assert proc.returncode == -signal.SIGKILL

    bundles = sorted(os.listdir(bb_dir))
    assert bundles == ["bundle-bbdrill-proc-0-w0",
                       "bundle-bbdrill-proc-0-w1"], bundles
    crash_meta = blackbox.read_meta(os.path.join(
        bb_dir, "bundle-bbdrill-proc-0-w1"))
    assert crash_meta["status"] == "final"
    assert crash_meta["reason"] == "crash:RuntimeError"
    assert blackbox.read_meta(victim)["status"] == "live"

    tel_dir = str(tmp_path / "tel")
    recs = blackbox.sweep(bb_dir, journal_dir=tel_dir, run_id="bbdrill")
    assert sorted(r["writer"] for r in recs) == ["proc-0-w0", "proc-0-w1"]
    assert all(r["journaled"] for r in recs)
    assert blackbox.read_meta(victim)["reason"] == "killed"
    assert blackbox.sweep(bb_dir, journal_dir=tel_dir, run_id="bbdrill")
    run_id, _shards, merged = merge_journals(tel_dir)
    assert run_id == "bbdrill"
    written = [e for e in merged if e.get("ev") == "bundle.written"]
    assert sorted(os.path.basename(e["dir"]) for e in written) == bundles
    ring = [json.loads(ln) for ln in
            open(os.path.join(victim, "ring.jsonl"), encoding="utf-8")
            if ln.strip()]
    assert [r["chunk"] for r in ring if r.get("ev") == "chunk.staged"] == \
        list(range(4))

    assert cli.main(["bundle", victim]) == 0
    out = capsys.readouterr().out
    assert "reason=killed" in out
    assert "rid=chunk-0" in out and "[feeder-w0]" in out


def _drill_worker(mode: str, root: str) -> int:
    """The drill's worker processes (this file run as a script)."""
    if mode == "crash":
        from avenir_tpu_torch.__main__ import main

        # an uncaught injected crash: the excepthook latches the bundle
        return main(["BayesianDistribution",
                     f"-Dfeature.schema.file.path={root}/hosp.json",
                     "-Dstream.chunk.rows=200",
                     f"-Dstream.checkpoint.dir={root}/ck",
                     "-Dstream.fault.crash.after.chunks=1",
                     f"-Dblackbox.dir={root}/bb", "-Dblackbox.flush.sec=0",
                     "-Dtrace.run.id=bbdrill", "-Dtrace.writer.suffix=w1",
                     f"{root}/train.csv", f"{root}/nb_crash",
                     "--device", "cpu"])
    blackbox.configure(JobConfig({"blackbox.dir": f"{root}/bb",
                                  "blackbox.flush.sec": "0.1",
                                  "trace.run.id": "bbdrill",
                                  "trace.writer.suffix": "w0"}))
    for i in range(4):
        blackbox.ring_record("chunk.staged", {"chunk": i})
    blackbox.register_provider(
        "feeder-w0", lambda: [{"rid": f"chunk-{i}", "state": "staged"}
                              for i in range(4)], kind="inflight")
    print("READY", flush=True)
    time.sleep(600)                      # killed long before this ends
    return 0


if __name__ == "__main__":
    raise SystemExit(_drill_worker(sys.argv[1], sys.argv[2]))
