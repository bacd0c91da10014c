"""The port's process plane against the JAX package's one-process runs,
on the CPU.

Two fleets of port processes — N = 2 and N = 3 — are spawned by this
module (``tests/torch_fleet_worker.py``), each joined through
``init_distributed(init_method="file://<tmp>/store")``: a ``FileStore``
rendezvous on the ``gloo`` backend, so no test picks a port number or
hands one on (gloo's own listeners bind port 0).  No JAX fleet is
started; the JAX package's own tests hold its N-process output equal to
its one-process output, so the JAX package's one-process run on the same
conf is the reference.

Held here, byte for byte unless stated:

- ``all_process_sum_state`` against its plain sum in process order:
  mixed key sets, ``min:`` / ``max:``, an int64 total past 2^31, a
  float64 sum whose value depends on the order, the shape-mismatch
  error on every process;
- BayesianDistribution and MutualInformation streamed with
  ``stream.chunk.rows`` (chunk ownership ``idx % nprocs == pid``, the
  end-of-stream merge, process 0 writing), N = 3 with one process owning
  no chunk; the two correlation jobs, the Markov chain and the HMM
  (tagged and partially tagged), and NumericalAttrStats (the port's
  one-process bytes; the JAX package's within 1e-5 relative, as
  tests/test_torch_chombo.py holds it);
- a kill on every rank after its first snapshot and a ``--resume``
  relaunch (``proc-NNN-of-NNN`` subdirectories, swept at the end);
- a fused NB + MI pipeline under ``shard.devices=2`` with
  ``shard.proc.axis=proc`` (a global 2 × 2 mesh), the plan's chunk step
  under ``shard.allreduce.quantized`` (the int8 leg across processes,
  bit for bit), and ``StreamAnalytics`` on the same plan, killed and
  resumed from per-process window snapshots;
- LogisticRegressionJob's history: equal to the port's one-process
  history bit for bit, and to the JAX package's within the LR contract
  (each iteration within 1e-5 of its largest coefficient, equal
  iteration counts and status);
- the journal shards (``fleet.join``, ``collective.wait``), the hybrid
  mesh and the process-local batch.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from avenir_tpu.core.config import JobConfig as JConfig
from avenir_tpu.jobs import get_job as jget_job
from avenir_tpu.pipeline import driver as jdriver
from avenir_tpu_torch.core.config import JobConfig
from avenir_tpu_torch.core.csv_io import write_csv
from avenir_tpu_torch.datagen.churn import CHURN_SCHEMA_JSON, generate_churn
from avenir_tpu_torch.datagen.hosp_readmit import (HOSP_SCHEMA_JSON,
                                                   generate_hosp_readmit)
from avenir_tpu_torch.jobs import get_job
from avenir_tpu_torch.pipeline import driver
from avenir_tpu_torch.telemetry.journal import read_events

sys.path.insert(0, os.path.dirname(__file__))
from torch_fleet_worker import gram_rows, sum_case  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_fleet_worker.py")
ROWS = 2000


def _spawn(work, nprocs, specs, name):
    """Run ``specs`` in a fleet of ``nprocs`` port processes joined
    through a fresh FileStore; returns the joined output."""
    (work / f"{name}.json").write_text(json.dumps(specs))
    store = work / f"{name}.store"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = []
    for rank in range(nprocs):
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, str(store), str(rank), str(nprocs),
             str(work), f"{name}.json"],
            env=dict(env, AVENIR_WRITER_SUFFIX=f"w{rank}"), cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    text = "".join(outs)
    for rank, p in enumerate(procs):
        assert p.returncode == 0, f"rank {rank} failed:\n{text[-4000:]}"
        assert f"proc {rank} done" in text
    return text


def _conf(work, **extra):
    return {"feature.schema.file.path": str(work / "churn.json"),
            "stream.chunk.rows": "700", **extra}


def _nb_mi_specs(work, tag, chunk):
    conf = _conf(work, **{"stream.chunk.rows": chunk})
    return [{"job": "BayesianDistribution", "input": "train.csv",
             "out": f"nb_{tag}", "conf": conf},
            {"job": "MutualInformation", "input": "train.csv",
             "out": f"mi_{tag}", "conf": conf}]


def _pipeline_props(work, **extra):
    props = {"pipeline.stages": "nb,mi",
             "pipeline.bind.train": str(work / "train.csv"),
             "pipeline.stage.nb.job": "BayesianDistribution",
             "pipeline.stage.nb.input": "train",
             "pipeline.stage.nb.output": "nb_model",
             "pipeline.stage.mi.job": "MutualInformation",
             "pipeline.stage.mi.input": "train",
             "pipeline.stage.mi.output": "mi_out",
             "shard.devices": "2", "shard.proc.axis": "proc",
             **_conf(work)}
    props.update(extra)
    return props


def _family_inputs(work):
    """Sequences (chains, tagged and partially tagged) and a numeric CSV
    for the Markov family and NumericalAttrStats; the values are on a
    1/16 grid, so every float32 partial is exact."""
    rng = np.random.default_rng(7)
    states, obs = ["A", "B", "C"], ["x", "y", "z", "w"]
    seq, hmm, pt = [], [], []
    for i in range(600):
        n = int(rng.integers(3, 12))
        seq.append(",".join([f"id{i}"] + [states[int(s)]
                                          for s in rng.integers(0, 3, n)]))
        hmm.append(",".join([f"id{i}"] + [
            f"{obs[int(o)]}:{states[int(s)]}"
            for o, s in zip(rng.integers(0, 4, n), rng.integers(0, 3, n))]))
        pt.append(",".join([f"id{i}"] + [
            states[int(rng.integers(0, 3))] if rng.random() < 0.3
            else obs[int(rng.integers(0, 4))]
            for _ in range(int(rng.integers(5, 15)))]))
    for name, lines in (("seqs", seq), ("hmm", hmm), ("pt", pt)):
        (work / f"{name}.csv").write_text("\n".join(lines) + "\n")
    g = rng.choice(["u", "v"], ROWS)
    x = rng.integers(-160, 160, (ROWS, 2)) / 16.0
    (work / "stats.csv").write_text("\n".join(
        f"{g[i]},{float(x[i, 0])!r},{float(x[i, 1])!r}" for i in range(ROWS))
        + "\n")


def _family_specs(work):
    """(job, input, conf) of the other jobs with a distributed branch."""
    churn = _conf(work)
    seq = {"stream.chunk.rows": "250", "model.states": "A,B,C"}
    hmm = dict(seq, **{"model.observations": "x,y,z,w"})
    return {
        "cramer": ("CramerCorrelation", "train.csv", churn),
        "het": ("HeterogeneityReductionCorrelation", "train.csv",
                dict(churn, **{"heterogeneity.algorithm": "uncertainty"})),
        "stats": ("NumericalAttrStats", "stats.csv",
                  {"stream.chunk.rows": "700", "attr.list": "1,2",
                   "cond.attr.ord": "0"}),
        "markov": ("MarkovStateTransitionModel", "seqs.csv", seq),
        "hmm": ("HiddenMarkovModelBuilder", "hmm.csv", hmm),
        "hmm_pt": ("HiddenMarkovModelBuilder", "pt.csv",
                   dict(hmm, **{"partially.tagged": "true"})),
    }


# one 2000-row chunk: each process's partial holds cells past 127, so
# the int8 scale is not 1
QUANT = {"shard.allreduce.quantized": "true", "stream.chunk.rows": "2000"}

STREAM = {"stream.pane.rows": "128", "stream.window.panes": "2",
          "stream.consumers": "classDistribution,naiveBayes,mutualInfo",
          "shard.devices": "2", "shard.proc.axis": "proc"}


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    """Both fleets' outputs: ``work`` holds the inputs and every part
    file; ``out2`` / ``out3`` the workers' transcripts."""
    work = tmp_path_factory.mktemp("torch_fleet")
    write_csv(str(work / "train.csv"), generate_churn(ROWS, seed=7))
    (work / "churn.json").write_text(json.dumps(CHURN_SCHEMA_JSON))
    write_csv(str(work / "hosp.csv"), generate_hosp_readmit(ROWS, seed=2))
    (work / "hosp.json").write_text(json.dumps(HOSP_SCHEMA_JSON))
    _family_inputs(work)
    ck = {"stream.checkpoint.dir": str(work / "ckpt"),
          "stream.checkpoint.interval.chunks": "1"}
    wck = {**STREAM, "feature.schema.file.path": str(work / "churn.json"),
           "stream.checkpoint.dir": str(work / "wckpt"),
           "stream.checkpoint.interval.panes": "2"}
    traced = {"trace.on": "true", "trace.journal.dir": str(work / "tel"),
              "trace.run.id": "fleet"}
    lr = {"feature.schema.file.path": str(work / "hosp.json"),
          "stream.chunk.rows": "700", "iteration.limit": "8"}
    crash = [{"job": "BayesianDistribution", "input": "train.csv",
              "out": "nb_kill", "expect_crash": True,
              "conf": _conf(work, **ck, **{
                  "stream.fault.crash.after.chunks": "1"})},
             {"job": "StreamAnalytics", "input": "train.csv",
              "out": "win_kill", "expect_crash": True,
              "conf": {**wck, "stream.fault.crash.after.panes": "7"}}]
    out2 = _spawn(work, 2, [{"sum": "mixed"}, {"sum": "empty"},
                            {"sum": "shape"}, {"mesh": True}]
                  + _nb_mi_specs(work, "n2", "700") + crash, "fleet2a")
    # between the kill and the resume: each process's own snapshots
    subdirs = sorted(os.listdir(work / "ckpt"))
    wsub = sorted(os.listdir(work / "wckpt"))
    resume = [{"job": "BayesianDistribution", "input": "train.csv",
               "out": "nb_kill", "conf": _conf(work, **ck, **{
                   "stream.resume": "true"})},
              {"job": "StreamAnalytics", "input": "train.csv",
               "out": "win_kill", "conf": {**wck, "stream.resume": "true"}},
              {"pipeline": _pipeline_props(work), "workspace": "ws_proc"},
              {"pipeline": _pipeline_props(work, **QUANT),
               "workspace": "ws_proc_q"},
              {"job": "LogisticRegressionJob", "input": "hosp.csv",
               "out": "lr_n2", "conf": lr},
              {"job": "BayesianDistribution", "input": "train.csv",
               "out": "nb_traced", "conf": _conf(work, **traced)},
              {"job": "StreamAnalytics", "input": "train.csv",
               "out": "win_traced",
               "conf": {**STREAM, **traced, "feature.schema.file.path":
                        str(work / "churn.json")}}]
    resume += [{"job": job, "input": inp, "out": f"fam_{tag}", "conf": conf}
               for tag, (job, inp, conf) in _family_specs(work).items()]
    resume.append({"qstep": True})
    out2 += _spawn(work, 2, resume, "fleet2b")
    specs3 = ([{"sum": "mixed"}] + _nb_mi_specs(work, "n3", "700")
              + _nb_mi_specs(work, "n3one", "1000"))
    out3 = _spawn(work, 3, specs3, "fleet3")
    return {"work": work, "out2": out2, "out3": out3,
            "ckpt_subdirs": subdirs, "wckpt_subdirs": wsub, "lr": lr,
            "wck": wck}


def _part(path):
    return (path / "part-00000").read_bytes()


def _jax(work, job, conf, out):
    jget_job(job).run(JConfig(dict(conf)), str(work / "train.csv"),
                      str(work / out))
    return _part(work / out)


# ---------------------------------------------------------------------------
# all_process_sum_state against its plain sum
# ---------------------------------------------------------------------------

def _plain_sum(case, nprocs):
    out = {}
    for p in range(nprocs):
        for k, v in sum_case(case, p).items():
            if k not in out:
                out[k] = v.copy()
            elif k.startswith("min:"):
                out[k] = np.minimum(out[k], v)
            elif k.startswith("max:"):
                out[k] = np.maximum(out[k], v)
            else:
                out[k] = out[k] + v
    return out


@pytest.mark.parametrize("nprocs,case", [(2, "mixed"), (3, "mixed"),
                                         (2, "empty")])
def test_all_process_sum_state_equals_plain_sum(fleets, nprocs, case):
    want = _plain_sum(case, nprocs)
    if case == "mixed":
        assert want["common"][0] > 2 ** 31
    if nprocs == 3:
        # (1e16 + 1) + 1 rounds to 1e16 twice; 1e16 + (1 + 1) would not
        assert want["f"][1] == 1e16
    for rank in range(nprocs):
        got = dict(np.load(
            fleets["work"] / f"sum_{case}_n{nprocs}_p{rank}.npz"))
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert got[k].tobytes() == want[k].tobytes(), k


def test_all_process_sum_state_shape_mismatch_raises_everywhere(fleets):
    for rank in range(2):
        got = np.load(fleets["work"] / f"sum_shape_n2_p{rank}.npz")
        assert "process 1 contributed 'bad' with shape (3,)" in \
            str(got["error"])


def test_hybrid_mesh_and_process_local_batch(fleets):
    out = fleets["out2"]
    for rank in range(2):
        line = next(ln for ln in out.splitlines()
                    if ln.startswith(f"proc {rank} mesh"))
        assert '{"data": 2, "model": 8}' in line
        assert "['cpu:0', 'cpu:1']" in line
        assert f"rows [[{100 * rank}, {100 * rank + 1}]" in line


# ---------------------------------------------------------------------------
# chunk ownership and the end-of-stream merge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("job,prefix", [("BayesianDistribution", "nb"),
                                        ("MutualInformation", "mi")])
@pytest.mark.parametrize("tag,chunk", [("n2", "700"), ("n3", "700"),
                                       ("n3one", "1000")])
def test_fleet_part_files_equal_jax_one_process(fleets, job, prefix, tag,
                                                chunk):
    work = fleets["work"]
    want = _jax(work, job, _conf(work, **{"stream.chunk.rows": chunk}),
                f"jax_{prefix}_{chunk}")
    assert _part(work / f"{prefix}_{tag}") == want


@pytest.mark.parametrize("tag", ["cramer", "het", "stats", "markov", "hmm",
                                 "hmm_pt"])
def test_family_fleet_part_files_equal_jax_one_process(fleets, tag):
    """The correlation jobs, NumericalAttrStats and the Markov family own
    chunks, merge once at the end of the stream and write from process 0,
    as BayesianDistribution does."""
    work = fleets["work"]
    job, inp, conf = _family_specs(work)[tag]
    jget_job(job).run(JConfig(dict(conf)), str(work / inp),
                      str(work / f"jax_{tag}"))
    got, want = _part(work / f"fam_{tag}"), _part(work / f"jax_{tag}")
    if tag != "stats":
        assert got == want
        return
    # NumericalAttrStats sums the shifted values in float64 where the JAX
    # package sums float32 (ROADMAP Queue 3 item 8): the fleet equals the
    # port's one process byte for byte — without the conftest's 8-slot
    # mesh, which a fleet's process never takes (its shard sums are added
    # in another order) — and the JAX package within 1e-5 relative, the
    # bound tests/test_torch_chombo.py holds this job's moments to
    get_job(job).run(JobConfig(dict(conf, **{"data.parallel.auto": "false"})),
                     str(work / inp), str(work / "one_stats"), device="cpu")
    assert got == _part(work / "one_stats")
    for g, w in zip(got.decode().split(), want.decode().split(), strict=True):
        for a, b in zip(g.split(","), w.split(","), strict=True):
            try:
                assert float(a) == pytest.approx(float(b), rel=1e-5)
            except ValueError:
                assert a == b


def test_every_process_counts_every_row(fleets):
    for out, nprocs in ((fleets["out2"], 2), (fleets["out3"], 3)):
        for rank in range(nprocs):
            assert f"proc {rank} spec" in out
        rows = [ln for ln in out.splitlines() if "rows=" in ln]
        assert rows and all(ln.endswith((f"rows={ROWS}", "rows=600"))
                            for ln in rows)


def test_kill_every_rank_and_resume(fleets):
    work = fleets["work"]
    assert fleets["ckpt_subdirs"] == ["proc-000-of-002", "proc-001-of-002"]
    for rank in range(2):
        assert f"proc {rank} spec 6 crashed" in fleets["out2"]
    want = _jax(work, "BayesianDistribution", _conf(work), "jax_nb_700k")
    assert _part(work / "nb_kill") == want
    assert not (work / "ckpt").exists()          # the finish() sweep


# ---------------------------------------------------------------------------
# the global (proc × data) plan
# ---------------------------------------------------------------------------

def test_shard_proc_axis_pipeline_equals_jax(fleets):
    work = fleets["work"]
    props = _pipeline_props(work)
    jdriver.Pipeline.from_conf(JConfig(dict(props)),
                               workspace=str(work / "ws_jax")).run()
    for art in ("nb_model", "mi_out"):
        assert _part(work / "ws_proc" / art) == _part(work / "ws_jax" / art)


def test_shard_proc_axis_quantized_pipeline(fleets):
    """The fused pipeline under the quantized global plan writes the
    part files of the port's one-process quantized ``shard.devices=2``
    run, whose two shard partials are the two processes' partials; the
    NB model is the JAX package's.  The MI values are the JAX package's
    within 2e-6, the bound tests/test_torch_models.py holds MI's derived
    statistics to: the port derives them in float32 in another order than
    XLA, and with these rounded counts one value prints on the other side
    of its sixth decimal (the gram itself is held bit for bit below)."""
    work = fleets["work"]
    props = _pipeline_props(work, **QUANT)
    driver.Pipeline.from_conf(JobConfig(dict(props)),
                              workspace=str(work / "ws_one_q"),
                              device="cpu").run()
    jdriver.Pipeline.from_conf(JConfig(dict(props)),
                               workspace=str(work / "ws_jax_q")).run()
    for art in ("nb_model", "mi_out"):
        assert _part(work / "ws_proc_q" / art) == \
            _part(work / "ws_one_q" / art)
    assert _part(work / "ws_proc_q" / "nb_model") == \
        _part(work / "ws_jax_q" / "nb_model")
    got = _part(work / "ws_proc_q" / "mi_out").decode().splitlines()
    want = _part(work / "ws_jax_q" / "mi_out").decode().splitlines()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if g == w:
            continue
        (gk, gv), (wk, wv) = g.rsplit(",", 1), w.rsplit(",", 1)
        assert gk == wk
        assert abs(float(gv) - float(wv)) <= 2e-6
    # the rounding shows: these are not the exact counts' MI values
    assert _part(work / "ws_proc_q" / "mi_out") != \
        _part(work / "ws_proc" / "mi_out")


def test_global_quantized_step_equals_jax(fleets):
    """``shard.allreduce.quantized`` under the global 2 × 2 plan: each
    process sums its two local shards exactly and the int8 reduce runs
    across the processes.  Its gram equals, bit for bit on every process,
    the JAX package's one-process quantized step over two devices on the
    same padded chunk (the same pow-2 target, cut in the same two row
    blocks).  The 2000-row chunk gives each process's partial cells past
    127, so the int8 scale is not 1 and the gram is not the exact one."""
    from jax.sharding import Mesh as JMesh

    from avenir_tpu.parallel import collectives as jcoll
    from avenir_tpu.parallel import mesh as jmesh
    from avenir_tpu_torch.core.encoding import pad_rows

    codes, labels = gram_rows(n=2000, f=6, b=2)
    codes, labels = pad_rows(2048, codes, labels)
    cont = np.zeros((2048, 1), np.float32)
    jm = JMesh(np.array(jax.devices()[:2]), ("data",))
    staged = jmesh.device_put_sharded_batch(jm, codes, labels, cont)
    want = np.asarray(jcoll.sharded_scan_step(
        jm, 2, 2, interpret=True, quantized=True, moments=False)(*staged)[0])
    exact = np.asarray(jcoll.sharded_scan_step(
        jm, 2, 2, interpret=True, moments=False)(*staged)[0])
    for rank in range(2):
        got = np.load(fleets["work"] / f"qstep_p{rank}.npz")["g"]
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()
    assert np.abs(exact).max() > 2 * 127 and (want != exact).any()


def test_stream_analytics_global_plan_kill_and_resume(fleets):
    """Both processes fold every pane of the global 2 × 2 plan, snapshot
    it under their own ``proc-NNN-of-NNN`` and crash; the resumed run's
    windows are the JAX package's uninterrupted ones from the restore."""
    work = fleets["work"]
    assert fleets["wckpt_subdirs"] == ["proc-000-of-002", "proc-001-of-002"]
    conf = {k: v for k, v in fleets["wck"].items()
            if not k.startswith("stream.checkpoint")}
    full = _jax(work, "StreamAnalytics", conf, "jax_win").decode()
    tail = _part(work / "win_kill").decode().splitlines()
    lines = full.splitlines()
    first = next(i for i, ln in enumerate(lines)
                 if ln.startswith(tail[0].split(",")[0] + ","))
    assert first > 0 and tail == lines[first:]


# ---------------------------------------------------------------------------
# logistic regression: the per-iteration merge
# ---------------------------------------------------------------------------

def _history(path):
    rows = [ln.split(",") for ln in path.read_text().splitlines()]
    return ([np.array([float(x) for x in r]) for r in rows[:-1]],
            rows[-1])


def test_lr_fleet_history_holds_the_contract(fleets):
    work = fleets["work"]
    got, status = _history(work / "lr_n2" / "part-00000")
    # one thread, as the workers run: a float32 CPU product's summation
    # order depends on the thread count
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        get_job("LogisticRegressionJob").run(
            JobConfig(dict(fleets["lr"])), str(work / "hosp.csv"),
            str(work / "lr_one"), device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert (work / "lr_n2" / "part-00000").read_bytes() == \
        (work / "lr_one" / "part-00000").read_bytes()
    jget_job("LogisticRegressionJob").run(
        JConfig(dict(fleets["lr"])), str(work / "hosp.csv"),
        str(work / "lr_jax"))
    want, jstatus = _history(work / "lr_jax" / "part-00000")
    assert status == jstatus and len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert np.max(np.abs(g - w)) <= 1e-5 * np.max(np.abs(w))


# ---------------------------------------------------------------------------
# telemetry across processes
# ---------------------------------------------------------------------------

def test_journal_shards_carry_join_and_collective_wait(fleets):
    """Each process journals its own shard under the launcher's writer
    suffix: the NB merge's ``collective.wait``, and under the global plan
    one ``shard.topology`` with the process axis and one ``fleet.join``."""
    work = fleets["work"]
    tel = work / "tel"
    names = sorted(n for n in os.listdir(tel) if n.endswith(".jsonl"))
    assert names == ["run-fleet.proc-0-w0.jsonl", "run-fleet.proc-1-w1.jsonl"]
    for rank, name in enumerate(names):
        events = read_events(str(tel / name))
        assert all(e["proc"] == rank for e in events)
        waits = [e for e in events if e["ev"] == "collective.wait"]
        assert waits and waits[0]["site"] == "all_process_sum_state"
        assert waits[0]["procs"] == 2 and waits[0]["wall_ms"] >= 0
        (topo,) = [e for e in events if e["ev"] == "shard.topology"]
        assert topo["mesh"] == {"proc": 2, "data": 2}
        assert topo["axes"] == ["proc", "data"] and topo["procs"] == 2
        (join,) = [e for e in events if e["ev"] == "fleet.join"]
        assert join["nprocs"] == 2 and join["attempts"] == 1
        assert join["coordinator"].startswith("file://")
    assert _part(work / "nb_traced") == _part(work / "nb_n2")
    assert not (work / "win_traced.inprogress").exists()
