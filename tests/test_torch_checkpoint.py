"""Stream checkpoints of the port's count jobs (``StreamCheckpointer``,
``jobs/base.py``) on the CPU, mirroring tests/test_stream_checkpoint.py,
and held against the JAX package's.

A run killed mid-stream by ``stream.fault.crash.after.chunks`` and resumed
from its snapshot writes the part file of an uninterrupted run, byte for
byte.  The snapshots keep the JAX package's format, accumulator keys and
run id, so a run crashed under one package resumes under the other.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from avenir_tpu.__main__ import main as jax_main  # noqa: E402
from avenir_tpu.core.config import ConfigError as JConfigError  # noqa: E402
from avenir_tpu.core.config import JobConfig as JConfig  # noqa: E402
from avenir_tpu.jobs import get_job as jget_job  # noqa: E402
from avenir_tpu.jobs.base import StreamCheckpointer as JStreamCheckpointer  # noqa: E402
from avenir_tpu.utils import checkpoint as jcheckpoint  # noqa: E402
from avenir_tpu_torch.__main__ import main as torch_main  # noqa: E402
from avenir_tpu_torch.core.config import ConfigError, JobConfig  # noqa: E402
from avenir_tpu_torch.core.csv_io import write_csv  # noqa: E402
from avenir_tpu_torch.core.encoding import EncodedDataset  # noqa: E402
from avenir_tpu_torch.datagen.churn import (  # noqa: E402
    CHURN_SCHEMA_JSON, generate_churn)
from avenir_tpu_torch.datagen.hosp_readmit import (  # noqa: E402
    HOSP_SCHEMA_JSON, generate_hosp_readmit)
from avenir_tpu_torch.jobs import get_job  # noqa: E402
from avenir_tpu_torch.jobs.base import Job, StreamCheckpointer  # noqa: E402
from avenir_tpu_torch.models.mutual_info import MutualInformation  # noqa: E402
from avenir_tpu_torch.ops import agg, hist  # noqa: E402
from avenir_tpu_torch.utils import checkpoint  # noqa: E402
from avenir_tpu_torch.checkpoint import reshard  # noqa: E402
from avenir_tpu_torch.utils.metrics import Counters  # noqa: E402

N_ROWS = 3000
CHUNK = 250          # 12 chunks
COUNT_JOBS = ("BayesianDistribution", "MutualInformation",
              "CramerCorrelation", "HeterogeneityReductionCorrelation")


@pytest.fixture()
def workload(tmp_path):
    write_csv(str(tmp_path / "train.csv"), generate_hosp_readmit(N_ROWS, seed=5))
    (tmp_path / "schema.json").write_text(json.dumps(HOSP_SCHEMA_JSON))

    def conf(**extra):
        c = JobConfig()
        c.set("feature.schema.file.path", str(tmp_path / "schema.json"))
        c.set("stream.chunk.rows", str(CHUNK))
        for k, v in extra.items():
            c.set(k.replace("_", "."), str(v))
        return c

    return tmp_path / "train.csv", conf


def _part(path):
    with open(os.path.join(path, "part-00000"), "rb") as fh:
        return fh.read()


def _run(job, conf, csv, out):
    return get_job(job).run(conf, str(csv), str(out), device="cpu")


@pytest.mark.parametrize("job_name", COUNT_JOBS)
def test_kill_and_resume_byte_identical(tmp_path, workload, job_name):
    csv, conf = workload
    clean_out = tmp_path / "clean"
    _run(job_name, conf(), csv, clean_out)

    ckdir = tmp_path / "ckpt"
    crashed_out = tmp_path / "crashed"
    with pytest.raises(RuntimeError, match="injected crash after chunk 7"):
        _run(job_name, conf(stream_checkpoint_dir=ckdir,
                            stream_checkpoint_interval_chunks=3,
                            stream_fault_crash_after_chunks=7),
             csv, crashed_out)
    assert not os.path.exists(os.path.join(crashed_out, "part-00000"))
    assert sorted(os.listdir(ckdir)) == ["step_3", "step_6"]

    resumed_out = tmp_path / "resumed"
    c = _run(job_name, conf(stream_checkpoint_dir=ckdir,
                            stream_checkpoint_interval_chunks=3,
                            stream_resume="true"), csv, resumed_out)
    assert _part(resumed_out) == _part(clean_out)
    # Records Processed counts the whole input, not the resumed tail
    assert c.get("Records", "Processed") == N_ROWS
    assert not os.path.exists(ckdir)


def test_finish_preserves_unrelated_files(tmp_path, workload):
    csv, conf = workload
    ckdir = tmp_path / "shared"
    ckdir.mkdir()
    (ckdir / "precious.txt").write_text("keep me")
    (ckdir / "other_dir").mkdir()
    (ckdir / "other_dir" / "data.bin").write_bytes(b"\x00\x01")
    _run("BayesianDistribution",
         conf(stream_checkpoint_dir=ckdir, stream_checkpoint_interval_chunks=2),
         csv, tmp_path / "out")
    assert (ckdir / "precious.txt").read_text() == "keep me"
    assert (ckdir / "other_dir" / "data.bin").exists()
    assert not [n for n in os.listdir(ckdir) if n.startswith("step_")]


def test_resume_without_checkpoint_is_fresh_run(tmp_path, workload):
    csv, conf = workload
    _run("BayesianDistribution", conf(), csv, tmp_path / "clean")
    out = tmp_path / "fresh_resume"
    _run("BayesianDistribution",
         conf(stream_checkpoint_dir=tmp_path / "nope", stream_resume="true"),
         csv, out)
    assert _part(out) == _part(tmp_path / "clean")


def test_cursor_resume_skips_consumed_chunks(workload):
    csv, conf = workload
    c = conf()
    enc = Job.encoder_for(c)
    counters = Counters()
    pairs = list(Job.iter_encoded_retrying(c, str(csv), enc, counters,
                                           emit_cursor=True))
    assert len(pairs) == N_ROWS // CHUNK
    cut = 5
    rest = list(Job.iter_encoded_retrying(
        c, str(csv), enc, counters,
        start={k: pairs[cut - 1][1][k] for k in ("file", "offset", "chunk")},
        emit_cursor=True))
    assert len(rest) == len(pairs) - cut
    np.testing.assert_array_equal(rest[0][0].codes, pairs[cut][0].codes)
    assert rest[0][1]["chunk"] == pairs[cut][1]["chunk"]
    assert rest[-1][1]["rows"] == (len(pairs) - cut) * CHUNK
    with pytest.raises(ConfigError, match="not among the input files"):
        next(Job.iter_encoded_retrying(
            c, str(csv), enc, counters,
            start={"file": str(csv) + ".gone", "offset": 0, "chunk": 1}))


def test_checkpointer_interval_and_crash(tmp_path):
    ck = StreamCheckpointer(str(tmp_path / "ck"), interval_chunks=2,
                            crash_after_chunks=5)
    ck.accumulator.add("x", np.arange(3))
    cursors = [{"file": "f", "offset": 10 * (i + 1), "chunk": i + 1,
                "rows": 7 * (i + 1)} for i in range(5)]
    for cur in cursors[:4]:
        ck.chunk_done(cur, last=False)
    with pytest.raises(RuntimeError, match="injected crash"):
        ck.chunk_done(cursors[4], last=False)
    ck2 = StreamCheckpointer(str(tmp_path / "ck"), interval_chunks=2,
                             resume=True)
    assert ck2.start == {"file": "f", "offset": 40, "chunk": 4}
    assert ck2.base_rows == 28
    np.testing.assert_array_equal(ck2.accumulator.get("x"), np.arange(3))
    # the last chunk is never snapshotted: finish() removes the state
    ck2.chunk_done({"file": "f", "offset": 60, "chunk": 6, "rows": 7},
                   last=True)
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_2", "step_4"]
    ck2.finish()
    assert not (tmp_path / "ck").exists()


def test_finish_sweep_tolerates_a_peer_clearing_its_own_subdir(
        tmp_path, monkeypatch):
    """Two processes of one run finish at once: process 0 sweeps process
    1's subdirectory (same run id) while process 1 clears it itself.  The
    subdirectory vanishing under the sweep is not an error, and the root
    is gone once both have finished."""
    from avenir_tpu_torch.utils.checkpoint import CheckpointManager

    root = tmp_path / "ck"
    cks = [StreamCheckpointer(str(root / f"proc-00{p}-of-002"),
                              interval_chunks=1, parent_dir=str(root),
                              run_id="runA") for p in range(2)]
    for p, ck in enumerate(cks):
        ck.accumulator.add("x", np.arange(3) + p)
        ck.chunk_done({"file": "f", "offset": 10, "chunk": 1, "rows": 5},
                      last=False)
    peer = str(root / "proc-001-of-002")
    recover = CheckpointManager._recover

    def racing(self):
        if self.directory == peer and os.path.isdir(peer):
            cks[1].finish()           # the peer clears itself first
        recover(self)

    monkeypatch.setattr(CheckpointManager, "_recover", racing)
    cks[0].finish()
    assert not root.exists()


def test_snapshot_run_fingerprint_rejected_on_mismatch(tmp_path):
    ck = StreamCheckpointer(str(tmp_path / "ck"), interval_chunks=1,
                            run_id="runA")
    ck.accumulator.add("x", np.arange(3))
    ck.chunk_done({"file": "f", "offset": 10, "chunk": 1, "rows": 5},
                  last=False)
    ok = StreamCheckpointer(str(tmp_path / "ck"), resume=True, run_id="runA")
    assert ok.base_rows == 5
    with pytest.raises(ConfigError, match="written by run 'runA'"):
        StreamCheckpointer(str(tmp_path / "ck"), resume=True, run_id="runB")


def test_construction_failure_is_a_config_error(tmp_path):
    squatter = tmp_path / "ck"
    squatter.write_text("not a directory")
    with pytest.raises(ConfigError, match="construction"):
        StreamCheckpointer(str(squatter))


def _tiny_ds():
    return EncodedDataset(
        codes=np.zeros((10, 3), np.int32), cont=np.zeros((10, 0), np.float32),
        labels=np.zeros(10, np.int32), n_bins=np.full(3, 4, np.int32),
        class_values=["a", "b"], binned_ordinals=[0, 1, 2])


def test_mi_resume_rejects_incompatible_g_layout():
    for key in ("g", "g:jmaj:f3:b5:c2"):
        acc = agg.Accumulator()
        acc.load({key: np.zeros((384, 384), np.int64), "class": np.zeros(2)})
        with pytest.raises(ValueError, match="incompatible kernel layout"):
            MutualInformation(device="cpu").fit(_tiny_ds(), accumulator=acc)


def test_mi_resume_across_path_flip_converts_counts(tmp_path, workload,
                                                    monkeypatch):
    """A kernel-route (G) snapshot — a run crashed on one card, where
    there is no data mesh — resumed where the kernel does not apply (the
    CPU under its host mesh) converts G into the ``agg`` route's
    ``fc``/``pcc<s>`` tensors exactly."""
    csv, conf = workload
    clean_out = tmp_path / "clean"
    _run("MutualInformation", conf(), csv, clean_out)

    monkeypatch.setattr(hist, "use_kernel", lambda f, b, c, d: True)
    ckdir = tmp_path / "ck_flip"
    with pytest.raises(RuntimeError, match="injected crash"):
        _run("MutualInformation",
             conf(stream_checkpoint_dir=ckdir,
                  stream_checkpoint_interval_chunks=2,
                  stream_fault_crash_after_chunks=5,
                  data_parallel_auto="false"),
             csv, tmp_path / "crashed_flip")
    monkeypatch.undo()
    snap = checkpoint.CheckpointManager(str(ckdir)).restore()
    assert sorted(snap["acc"]) == ["class", hist.g_key(10, 13, 2)]

    out = tmp_path / "resumed_flip"
    _run("MutualInformation",
         conf(stream_checkpoint_dir=ckdir, stream_resume="true",
              data_parallel_auto="false"), csv, out)
    assert _part(out) == _part(clean_out)


def test_mi_einsum_snapshot_stays_on_the_einsum_route(tmp_path, workload,
                                                      monkeypatch):
    """An ``agg``-route snapshot resumed where the kernel applies keeps the
    resumed run on the ``agg`` route: no gram is launched."""
    csv, conf = workload
    _run("MutualInformation", conf(), csv, tmp_path / "clean")
    ckdir = tmp_path / "ck"
    with pytest.raises(RuntimeError, match="injected crash"):
        _run("MutualInformation",
             conf(stream_checkpoint_dir=ckdir,
                  stream_checkpoint_interval_chunks=2,
                  stream_fault_crash_after_chunks=5),
             csv, tmp_path / "crashed")
    grams = []
    monkeypatch.setattr(hist, "use_kernel", lambda f, b, c, d: True)
    monkeypatch.setattr(hist, "cooc_counts",
                        lambda *a: grams.append(a) or None)
    out = tmp_path / "resumed"
    _run("MutualInformation",
         conf(stream_checkpoint_dir=ckdir, stream_resume="true"), csv, out)
    assert grams == []
    assert _part(out) == _part(tmp_path / "clean")


def test_correlation_refuses_a_kernel_snapshot_on_the_einsum_route(
        tmp_path, workload, monkeypatch):
    csv, conf = workload
    ckdir = tmp_path / "ck"
    # the kernel route of one card, where there is no data mesh
    monkeypatch.setattr(hist, "use_kernel", lambda f, b, c, d: True)
    with pytest.raises(RuntimeError, match="injected crash"):
        _run("CramerCorrelation",
             conf(stream_checkpoint_dir=ckdir,
                  stream_checkpoint_interval_chunks=1,
                  stream_fault_crash_after_chunks=2,
                  data_parallel_auto="false"),
             csv, tmp_path / "crashed")
    monkeypatch.undo()
    with pytest.raises(ValueError, match="different device/kernel layout"):
        _run("CramerCorrelation",
             conf(stream_checkpoint_dir=ckdir, stream_resume="true",
                  data_parallel_auto="false"),
             csv, tmp_path / "resumed")
    assert not (tmp_path / "resumed" / "part-00000").exists()


def _mesh_snapshot(directory):
    mgr = jcheckpoint.CheckpointManager(str(directory), keep=2)
    mgr.save(1, {"acc": {"g:fmaj:f10:b13:c2:mesh:data8":
                         np.zeros((384, 384), np.int64),
                         "class": np.zeros(2, np.int64)},
                 "cursor": {"file": "f", "offset": 9, "chunk": 1},
                 "rows": 250, "run": ""})


def test_mesh_qualified_snapshot_is_refused(tmp_path):
    _mesh_snapshot(tmp_path / "ck")
    with pytest.raises(JConfigError) as want:
        JStreamCheckpointer(str(tmp_path / "ck"), resume=True)
    with pytest.raises(ConfigError) as got:
        StreamCheckpointer(str(tmp_path / "ck"), resume=True)
    assert str(got.value) == str(want.value)
    assert "folded under mesh topology ':mesh:data8'" in str(got.value)
    # behind the gate the snapshot is re-keyed for the unsharded fold, as
    # the JAX package's is (tests/test_torch_reshard.py holds the rest)
    moved = StreamCheckpointer(str(tmp_path / "ck"), resume=True,
                               reshard=True)
    jmoved = JStreamCheckpointer(str(tmp_path / "ck"), resume=True,
                                 reshard=True)
    assert sorted(moved.accumulator.names()) == ["class", "g:fmaj:f10:b13:c2"]
    assert sorted(jmoved.accumulator.state()) == \
        sorted(moved.accumulator.names())
    assert moved.start == jmoved.start and moved.base_rows == 250
    # the mesh-qualified keys come back as written
    state = StreamCheckpointer(str(tmp_path / "ck")).mgr.restore()
    assert sorted(state["acc"]) == ["class", "g:fmaj:f10:b13:c2:mesh:data8"]
    assert reshard.split_mesh_key("g:cls:f4:b5:c2:mesh:data8") == \
        ("g:cls:f4:b5:c2", ":mesh:data8")
    mixed = {"acc": {"g:a:mesh:data8": 1, "g:b:mesh:data4": 2}}
    with pytest.raises(reshard.ReshardError, match="mixed-topology"):
        reshard.snapshot_suffix(mixed)


RUN_ID_PROPS = [
    {},
    {"feature.schema.file.path": "s.json", "stream.chunk.rows": "250"},
    {"feature.schema.file.path": "s.json", "stream.chunk.rows": "250",
     "stream.checkpoint.dir": "D", "stream.resume": "true",
     "stream.fault.crash.after.chunks": "2", "stream.prefetch.depth": "0",
     "shard.devices": "4", "fault.x": "1", "mutual.info.score.algorithms": "mim"},
    {"stream.run.id": "explicit", "a": "1"},
]


@pytest.mark.parametrize("props", range(len(RUN_ID_PROPS)))
def test_run_id_equals_the_jax_one(props):
    props = RUN_ID_PROPS[props]
    got = StreamCheckpointer.run_id_from_conf(JobConfig(dict(props)))
    assert got == JStreamCheckpointer.run_id_from_conf(JConfig(dict(props)))
    relaunch = {k: v for k, v in props.items()
                if not k.startswith(("stream.fault.", "stream.resume"))}
    assert StreamCheckpointer.run_id_from_conf(JobConfig(relaunch)) == got


# ---------------------------------------------------------------------------
# across the packages, on categorical data
# ---------------------------------------------------------------------------

@pytest.fixture()
def churn(tmp_path):
    write_csv(str(tmp_path / "churn.csv"), generate_churn(N_ROWS, seed=9))
    (tmp_path / "churn.json").write_text(json.dumps(CHURN_SCHEMA_JSON))
    return tmp_path


def _cli(main, job, work, out, *extra):
    argv = [job, f"-Dfeature.schema.file.path={work / 'churn.json'}",
            f"-Dstream.chunk.rows={CHUNK}",
            f"-Dstream.checkpoint.dir={work / 'D'}",
            "-Dstream.checkpoint.interval.chunks=2", *extra,
            str(work / "churn.csv"), str(out)]
    if main is torch_main:
        argv += ["--device", "cpu"]
    with contextlib.redirect_stdout(io.StringIO()):
        assert main(argv) == 0


@pytest.mark.parametrize("crash,resume", [("jax", "torch"), ("torch", "jax")])
@pytest.mark.parametrize("job", ["BayesianDistribution", "CramerCorrelation"])
def test_a_snapshot_of_one_package_resumes_in_the_other(churn, job, crash,
                                                        resume):
    mains = {"jax": jax_main, "torch": torch_main}
    work = churn
    clean = work / "jax_clean"
    jget_job(job).run(JConfig({
        "feature.schema.file.path": str(work / "churn.json"),
        "stream.chunk.rows": str(CHUNK)}), str(work / "churn.csv"), str(clean))
    with pytest.raises(RuntimeError, match="injected crash after chunk 5"):
        _cli(mains[crash], job, work, work / "crashed",
             "-Dstream.fault.crash.after.chunks=5")
    assert sorted(os.listdir(work / "D")) == ["step_2", "step_4"]
    _cli(mains[resume], job, work, work / "resumed", "--resume")
    assert _part(work / "resumed") == _part(clean)
    assert not (work / "D").exists()
