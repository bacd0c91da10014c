"""The port's stream plane (``avenir_tpu_torch/stream/``) against the JAX
package's on the CPU.

Every window a port ``WindowedScan`` emits is held against the JAX
package's ``WindowedScan`` over the same rows (count tables integer for
integer, MI within abs 2e-6, moments on float32-exact grid data byte for
byte) and against the port's own batch ``SharedScan`` over the window's
rows.  Around it: kill-and-resume, the snapshot refusals (run id, a
foreign routing), a JAX-written snapshot resumed in the port,
``StreamAnalytics`` part files and counters against the JAX job, drift
divergences bit for bit with the same journal events, and the
drift → retrain → hot-swap loop on the port's registry and batcher.  No
test binds a socket.
"""

import json
import os
import threading
import types

import numpy as np
import pytest
import torch

from avenir_tpu.core.config import JobConfig as JJobConfig
from avenir_tpu.core.encoding import DatasetEncoder as JEncoder
from avenir_tpu.core.schema import FeatureSchema as JSchema
from avenir_tpu.jobs import get_job as jget_job
from avenir_tpu.pipeline import scan as jscan
from avenir_tpu.stream import ClassDistributionConsumer as JClassDist
from avenir_tpu.stream import DriftDetector as JDriftDetector
from avenir_tpu.stream import WindowCheckpointer as JCheckpointer
from avenir_tpu.stream import WindowedScan as JWindowedScan
from avenir_tpu.stream.drift import chisquare_divergence as jchisq
from avenir_tpu.stream.drift import js_divergence as jjs
from avenir_tpu.telemetry import spans as jtel
from avenir_tpu.telemetry.journal import read_events as jread_events
from avenir_tpu_torch.core.config import ConfigError, JobConfig
from avenir_tpu_torch.core.csv_io import read_csv_string
from avenir_tpu_torch.core.encoding import DatasetEncoder
from avenir_tpu_torch.core.schema import FeatureSchema
from avenir_tpu_torch.jobs import get_job
from avenir_tpu_torch.pipeline import scan
from avenir_tpu_torch.pipeline.streaming import InProcQueue
from avenir_tpu_torch.stream import (
    ClassDistributionConsumer,
    DriftDetector,
    DriftEvent,
    DriftRetrainController,
    WindowCheckpointer,
    WindowedScan,
    WindowResult,
)
from avenir_tpu_torch.stream.drift import chisquare_divergence, js_divergence
from avenir_tpu_torch.telemetry import spans as tel
from avenir_tpu_torch.telemetry.journal import read_events

MI_TOL = 2e-6

# binned AND continuous features; scores on the 1/16 grid in [0.5, 2.5],
# so every value and square is exact in float32 and every partial sum
# stays exact: moments are byte-identical across any pane chunking
STREAM_SCHEMA = {
    "fields": [
        {"name": "id", "ordinal": 0, "id": True, "dataType": "string"},
        {"name": "color", "ordinal": 1, "dataType": "categorical",
         "cardinality": ["r", "g", "b"], "feature": True},
        {"name": "size", "ordinal": 2, "dataType": "categorical",
         "cardinality": ["s", "m", "l"], "feature": True},
        {"name": "score", "ordinal": 3, "dataType": "double",
         "feature": True},
        {"name": "status", "ordinal": 4, "dataType": "categorical",
         "cardinality": ["pos", "neg"]},
    ]
}


def gen_lines(n, seed, flip=False):
    """CSV rows with P(status | color) steady or flipped (the drift
    signal), made from a numpy seed."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        color = ["r", "g", "b"][int(rng.integers(0, 3))]
        size = ["s", "m", "l"][int(rng.integers(0, 3))]
        score = (8 + int(rng.integers(0, 17))) / 16.0 + \
            (1.0 if color == "r" else 0.0)
        p_pos = 0.9 if color == "r" else 0.15
        if flip:
            p_pos = 1.0 - p_pos
        status = "pos" if rng.random() < p_pos else "neg"
        out.append(f"id{i},{color},{size},{score!r},{status}")
    return out


def _const_lines(n, color, status, start=0):
    return [f"id{start + i},{color},m,1.25,{status}" for i in range(n)]


@pytest.fixture(scope="module")
def schema(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_stream")
    path = root / "stream.json"
    path.write_text(json.dumps(STREAM_SCHEMA))
    return str(path)


def _enc(schema):
    return DatasetEncoder(FeatureSchema.from_file(schema))


def _jenc(schema):
    return JEncoder(JSchema.from_file(schema))


def consumers():
    return [ClassDistributionConsumer(name="cd"),
            scan.NaiveBayesConsumer(name="nb"),
            scan.MutualInfoConsumer(name="mi"),
            scan.CorrelationConsumer(name="cramer", against_class=True)]


def jconsumers():
    return [JClassDist(name="cd"), jscan.NaiveBayesConsumer(name="nb"),
            jscan.MutualInfoConsumer(name="mi"),
            jscan.CorrelationConsumer(name="cramer", against_class=True)]


def _port(schema, pane_rows, **kw):
    return WindowedScan(_enc(schema), consumers(), pane_rows, device="cpu",
                        **kw)


def _jax(schema, pane_rows, **kw):
    return JWindowedScan(_jenc(schema), jconsumers(), pane_rows, **kw)


NB_ATTRS = ("bin_counts", "class_counts", "cont_count", "cont_sum",
            "cont_sumsq")


def _mi_close(a_lines, b_lines):
    assert len(a_lines) == len(b_lines)
    for a, b in zip(a_lines, b_lines):
        fa, fb = a.split(","), b.split(",")
        assert len(fa) == len(fb)
        for x, y in zip(fa, fb):
            try:
                assert abs(float(x) - float(y)) <= MI_TOL, (a, b)
            except ValueError:
                assert x == y, (a, b)


def assert_window_equal(w, ref):
    """One port window against a reference window (the JAX package's, or
    a port batch scan's result dict wrapped as one)."""
    results = ref.results if hasattr(ref, "results") else ref
    np.testing.assert_array_equal(w.results["cd"]["counts"],
                                  np.asarray(results["cd"]["counts"]))
    for attr in NB_ATTRS:
        got = np.asarray(getattr(w.results["nb"], attr))
        want = np.asarray(getattr(results["nb"], attr))
        assert got.tobytes() == want.astype(got.dtype).tobytes(), attr
    _mi_close(w.results["mi"].to_lines(), results["mi"].to_lines())
    np.testing.assert_array_equal(w.results["cramer"].contingency,
                                  results["cramer"].contingency)
    np.testing.assert_allclose(w.results["cramer"].stat,
                               results["cramer"].stat, rtol=0, atol=1e-6)


def batch_oracle(schema, lines):
    """The port's own batch SharedScan over exactly these rows."""
    eng = scan.SharedScan(device="cpu")
    for c in consumers():
        eng.register(c)
    return eng.run(_enc(schema).transform(read_csv_string("\n".join(lines)),
                                          with_labels=True))


def _both(schema, lines, pane_rows, flush=True, **kw):
    port = _port(schema, pane_rows, retain_rows=True, **kw)
    jax_ = _jax(schema, pane_rows, retain_rows=True, **kw)
    a = port.feed(lines) + (port.flush() if flush else [])
    b = jax_.feed(lines) + (jax_.flush() if flush else [])
    assert [(w.index, w.first_pane, w.last_pane, w.rows) for w in a] == \
        [(w.index, w.first_pane, w.last_pane, w.rows) for w in b]
    for w, ref in zip(a, b):
        assert w.lines == ref.lines
        assert_window_equal(w, ref)
        assert_window_equal(w, batch_oracle(schema, w.lines))
    return port, a


# ---------------------------------------------------------------------------
# windows against the JAX package's and the port's batch scan
# ---------------------------------------------------------------------------

def test_tumbling_windows_equal_jax_and_batch(schema):
    lines = gen_lines(370, seed=3)
    port, windows = _both(schema, lines, 50, window_panes=2)
    # 7 full panes + a ragged 20 → 8 panes → 4 windows
    assert port.panes_closed == 8 and len(windows) == 4
    assert windows[-1].rows == 70


@pytest.mark.parametrize("pad_pow2", [True, False])
def test_sliding_windows_equal_jax_and_batch(schema, pad_pow2):
    lines = gen_lines(240, seed=5)
    _port_, windows = _both(schema, lines, 40, window_panes=3, slide_panes=1,
                            pad_pow2=pad_pow2)
    assert [w.last_pane for w in windows] == [2, 3, 4, 5]
    assert windows[0].lines[40:] == windows[1].lines[:80]


def test_pane_edge_and_ragged_tail(schema):
    port = _port(schema, 32, retain_rows=True)
    jax_ = _jax(schema, 32, retain_rows=True)
    lines = gen_lines(64, seed=7)
    assert len(port.feed(lines)) == 2 and len(jax_.feed(lines)) == 2
    assert port.flush() == [] and jax_.flush() == []
    port.feed(lines[:1])
    jax_.feed(lines[:1])
    assert port.panes_closed == 2
    (tail,), (jtail,) = port.flush(), jax_.flush()
    assert tail.rows == 1
    assert_window_equal(tail, jtail)


def test_feed_chunking_invariance(schema):
    lines = gen_lines(200, seed=11)
    one = _port(schema, 30, window_panes=2, slide_panes=1, retain_rows=True)
    all_at_once = one.feed(lines) + one.flush()
    dribble = _port(schema, 30, window_panes=2, slide_panes=1,
                    retain_rows=True)
    trickled = []
    for i in range(0, len(lines), 17):
        trickled += dribble.feed(lines[i:i + 17])
    trickled += dribble.flush()
    assert [w.last_pane for w in all_at_once] == \
        [w.last_pane for w in trickled]
    for a, b in zip(all_at_once, trickled):
        assert a.lines == b.lines
        assert_window_equal(a, b)


def test_empty_windows_finalize_as_jax(schema):
    port, jax_ = _port(schema, 16, window_panes=2), \
        _jax(schema, 16, window_panes=2)
    assert port.close_pane() == [] and jax_.close_pane() == []
    (window,), (jwindow,) = port.close_pane(), jax_.close_pane()
    assert window.rows == 0
    assert int(window.results["cd"]["counts"].sum()) == 0
    assert window.results["cd"]["fractions"].tolist() == [0.0, 0.0]
    assert_window_equal(window, jwindow)
    detector = DriftDetector(threshold=0.1)
    detector.last_divergence = 0.231
    assert detector.update(window) is None
    assert detector.last_divergence == 0.0


def test_warm_blank_panes_count_nothing_and_zero_recompiles(schema):
    port = _port(schema, 32, window_panes=1)
    assert port.warm() == len(port.buckets) == 6       # 1, 2, ..., 32
    port.feed(gen_lines(100, seed=13))                 # 3 panes + a 4-row tail
    (tail,) = port.flush()
    assert not port.counters.get("Stream", "recompiles")
    assert port.counters.get("Stream", "panes") == 4
    assert int(tail.results["cd"]["counts"].sum()) == 4


def test_pump_from_queue(schema):
    port = _port(schema, 25, window_panes=1, retain_rows=True)
    q = InProcQueue(depth=256)
    lines = gen_lines(60, seed=17)
    q.push_all(lines)
    windows = port.pump(q, max_rows=50)
    assert len(q) == 10 and len(windows) == 2
    windows += port.pump(q) + port.flush()
    assert [w.rows for w in windows] == [25, 25, 10]
    for w in windows:
        assert_window_equal(w, batch_oracle(schema, w.lines))


# ---------------------------------------------------------------------------
# kill and resume, snapshot refusals, a JAX-written snapshot
# ---------------------------------------------------------------------------

def _ckpt_props(schema, tmp_path, **extra):
    props = {"feature.schema.file.path": schema,
             "stream.pane.rows": "16",
             "stream.checkpoint.dir": str(tmp_path / "ckpt"),
             "stream.checkpoint.interval.panes": "2"}
    props.update(extra)
    return props


def test_window_checkpoint_kill_and_resume_byte_identical(schema, tmp_path):
    lines = gen_lines(128, seed=19)            # exactly 8 panes of 16
    golden = _port(schema, 16, window_panes=3, slide_panes=1)
    uninterrupted = {w.index: w for w in golden.feed(lines)}
    conf = JobConfig(_ckpt_props(schema, tmp_path))
    crashed = _port(schema, 16, window_panes=3, slide_panes=1,
                    checkpointer=WindowCheckpointer.from_conf(conf),
                    crash_after_panes=5)
    with pytest.raises(RuntimeError, match="injected crash"):
        crashed.feed(lines)
    ckpt = WindowCheckpointer.from_conf(JobConfig(
        _ckpt_props(schema, tmp_path, **{"stream.resume": "true"})))
    resumed = _port(schema, 16, window_panes=3, slide_panes=1,
                    checkpointer=ckpt)
    skip = ckpt.restore_into(resumed)
    assert skip == 64 and resumed.panes_closed == 4
    replayed = resumed.feed(lines[skip:])
    assert [w.index for w in replayed] == [2, 3, 4, 5]
    for w in replayed:
        ref = uninterrupted[w.index]
        assert (w.first_pane, w.last_pane, w.rows) == \
            (ref.first_pane, ref.last_pane, ref.rows)
        assert_window_equal(w, ref)
    ckpt.finish()
    assert not (tmp_path / "ckpt").exists()


def test_checkpoint_run_id_mismatch_refused(schema, tmp_path):
    ckpt = WindowCheckpointer.from_conf(JobConfig(_ckpt_props(schema,
                                                              tmp_path)))
    port = _port(schema, 16, window_panes=2, checkpointer=ckpt)
    port.feed(gen_lines(32, seed=23))          # 2 panes → a snapshot
    other = _ckpt_props(schema, tmp_path, **{"stream.pane.rows": "32",
                                              "stream.resume": "true"})
    with pytest.raises(ConfigError, match="written by"):
        WindowCheckpointer.from_conf(JobConfig(other))


def _snapshot_with(tmp_path, schema, rekey):
    """A port snapshot whose pane states ``rekey`` rewrites, restored into
    a fresh CPU scan."""
    props = _ckpt_props(schema, tmp_path)
    port = _port(schema, 16, window_panes=2,
                 checkpointer=WindowCheckpointer.from_conf(JobConfig(props)))
    port.feed(gen_lines(32, seed=23))
    from avenir_tpu_torch.utils import checkpoint

    mgr = checkpoint.CheckpointManager(props["stream.checkpoint.dir"], keep=2)
    state = mgr.restore()
    for rec in state["ring"]:
        rec["state"] = rekey(rec["state"])
    # a sharded fold records its topology beside its keys
    from avenir_tpu_torch.checkpoint import reshard

    state["shard"] = reshard.snapshot_suffix(
        {"ring": state["ring"]}) or ""
    mgr.save(state["pane"], state)
    ckpt = WindowCheckpointer.from_conf(JobConfig(
        {**props, "stream.resume": "true"}))
    return ckpt, _port(schema, 16, window_panes=2, checkpointer=ckpt)


def _cuda_keyed(state):
    """The einsum state re-keyed as a kernel-route (``cuda``) fold writes
    it: the gram under ``g_key`` instead of ``fc`` / ``pcc<off>``."""
    out = {k: v for k, v in state.items()
           if k != "fc" and not k.startswith("pcc")}
    out["g:fmaj:f2:b4:c2"] = np.zeros((128, 128), np.int64)
    return out


def _mesh_keyed(state):
    out = _cuda_keyed(state)
    out["g:fmaj:f2:b4:c2:mesh:data8"] = out.pop("g:fmaj:f2:b4:c2")
    return out


@pytest.mark.parametrize("rekey,match", [
    (_cuda_keyed, "chunked-einsum count routing"),
    (_mesh_keyed, "set shard.reshard.on.restore=true"),
], ids=["cuda_gram_on_cpu", "mesh_gram"])
def test_routing_mismatch_refused_never_folded(schema, tmp_path, rekey,
                                               match):
    ckpt, port = _snapshot_with(tmp_path, schema, rekey)
    with pytest.raises(ConfigError, match=match):
        ckpt.restore_into(port)
    assert port.panes_closed == 0 and not port._ring


def test_einsum_snapshot_refused_on_a_gram_routing(schema, tmp_path):
    """einsum ``fc`` counts restored onto a gram routing (here the packed
    one a forced pack gives) are refused, never folded."""
    ckpt, _ = _snapshot_with(tmp_path, schema, lambda s: s)
    enc = _enc(schema)
    gram = WindowedScan(enc, consumers(), 16, window_panes=2, device="cpu",
                        checkpointer=ckpt)
    gram.folder.step, gram.folder.gk = "packed", "g:packed:fmaj:f2:b4:c2"
    with pytest.raises(ConfigError, match="cannot be promoted"):
        ckpt.restore_into(gram)


def test_state_matches_routing_both_directions(schema):
    folder = _port(schema, 16).folder
    assert folder.step == "einsum"
    assert folder.state_matches_routing({"class": 1, "fc": 2})
    assert not folder.state_matches_routing({"g:fmaj:f2:b4:c2": 1})
    assert folder.g_suffix == ""
    folder.step, folder.gk = "kernel", "g:fmaj:f2:b4:c2"
    assert folder.state_matches_routing({"g:fmaj:f2:b4:c2": 1})
    assert not folder.state_matches_routing({"fc": 1})
    assert not folder.state_matches_routing({"g:packed:x": 1})


def test_jax_written_snapshot_resumes_byte_identical(schema, tmp_path):
    """Both packages fold this schema on the CPU's einsum routing, under
    the same keys and the same run id: a snapshot the JAX package wrote
    resumes in the port and finishes byte-identical."""
    lines = gen_lines(128, seed=19)
    props = _ckpt_props(schema, tmp_path)
    jconf = JJobConfig(dict(props))
    crashed = _jax(schema, 16, window_panes=3, slide_panes=1,
                   checkpointer=JCheckpointer.from_conf(jconf),
                   crash_after_panes=5)
    with pytest.raises(RuntimeError, match="injected crash"):
        crashed.feed(lines)
    from avenir_tpu.jobs.base import StreamCheckpointer as JStream
    from avenir_tpu_torch.jobs.base import StreamCheckpointer

    conf = JobConfig({**props, "stream.resume": "true"})
    assert StreamCheckpointer.run_id_from_conf(conf) == \
        JStream.run_id_from_conf(JJobConfig(dict(conf.props)))
    ckpt = WindowCheckpointer.from_conf(conf)
    resumed = _port(schema, 16, window_panes=3, slide_panes=1,
                    checkpointer=ckpt)
    assert resumed.folder.state_matches_routing(
        ckpt.restored["ring"][0]["state"])
    skip = ckpt.restore_into(resumed)
    assert skip == 64
    golden = {w.index: w for w in
              _jax(schema, 16, window_panes=3, slide_panes=1).feed(lines)}
    replayed = resumed.feed(lines[skip:])
    assert [w.index for w in replayed] == [2, 3, 4, 5]
    for w in replayed:
        assert_window_equal(w, golden[w.index])


# ---------------------------------------------------------------------------
# the StreamAnalytics job against the JAX job
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def job_data(schema, tmp_path_factory):
    root = tmp_path_factory.mktemp("stream_job")
    data = root / "data.csv"
    data.write_text("\n".join(gen_lines(96, seed=29)
                              + gen_lines(96, seed=30, flip=True)) + "\n")
    return root, str(data)


def _jobs(props, data, out_port, out_jax, **kw):
    port = get_job("StreamAnalytics").run(JobConfig(dict(props)), data,
                                          str(out_port), device="cpu")
    jax_ = jget_job("StreamAnalytics").run(JJobConfig(dict(props)), data,
                                           str(out_jax))
    return port, jax_


def _part(path):
    return (path / "part-00000").read_text()


@pytest.mark.parametrize("drift", [None, "0.05"], ids=["plain", "drift"])
def test_stream_analytics_equals_jax_job(schema, job_data, tmp_path, drift):
    _root, data = job_data
    props = {"feature.schema.file.path": schema, "stream.pane.rows": "16",
             "stream.window.panes": "2", "stream.slide.panes": "1",
             "stream.consumers": "classDistribution,naiveBayes,mutualInfo,"
                                 "cramer"}
    if drift:
        props["stream.drift.threshold"] = drift
    port, jax_ = _jobs(props, data, tmp_path / "p", tmp_path / "j")
    assert _part(tmp_path / "p") == _part(tmp_path / "j")
    assert port.as_dict() == jax_.as_dict()
    assert port.get("Stream", "windows") == 11
    assert port.get("Records", "Processed") == 192
    if drift:
        assert "detected" in _part(tmp_path / "p")


def test_stream_analytics_resume_equals_jax(schema, job_data, tmp_path):
    """Crash after pane 5 with a snapshot every 2 panes; each package
    resumes its own snapshot and the port resumes the JAX package's: all
    three tails equal the uninterrupted part file's, drift lines
    included."""
    _root, data = job_data
    props = {"feature.schema.file.path": schema, "stream.pane.rows": "16",
             "stream.window.panes": "2",
             "stream.consumers": "classDistribution,naiveBayes",
             "stream.drift.threshold": "0.05",
             "stream.checkpoint.interval.panes": "2"}
    get_job("StreamAnalytics").run(JobConfig(dict(props)), data,
                                   str(tmp_path / "full"), device="cpu")
    full = _part(tmp_path / "full").splitlines()
    tails = {}
    for crash, resume in (("port", "port"), ("jax", "jax"),
                          ("jax", "port")):
        ck = str(tmp_path / f"ck_{crash}_{resume}")
        crash_props = {**props, "stream.checkpoint.dir": ck,
                       "stream.fault.crash.after.panes": "5"}
        with pytest.raises(RuntimeError, match="injected crash"):
            if crash == "port":
                get_job("StreamAnalytics").run(
                    JobConfig(crash_props), data,
                    str(tmp_path / f"x_{crash}_{resume}"), device="cpu")
            else:
                jget_job("StreamAnalytics").run(
                    JJobConfig(crash_props), data,
                    str(tmp_path / f"x_{crash}_{resume}"))
        assert not (tmp_path / f"x_{crash}_{resume}").exists()
        res_props = {**props, "stream.checkpoint.dir": ck,
                     "stream.resume": "true"}
        out = tmp_path / f"r_{crash}_{resume}"
        if resume == "port":
            counters = get_job("StreamAnalytics").run(
                JobConfig(res_props), data, str(out), device="cpu")
        else:
            counters = jget_job("StreamAnalytics").run(
                JJobConfig(res_props), data, str(out))
        assert counters.get("Stream", "windows") == 4   # windows 2..5
        tails[(crash, resume)] = _part(out).splitlines()
        assert not os.path.exists(ck)
    w2 = next(i for i, ln in enumerate(full) if ln.startswith("w=2,panes"))
    for key, tail in tails.items():
        assert tail == full[w2:], key


def test_stream_analytics_fold_fault_then_resume(schema, job_data, tmp_path):
    """``fault.fold.crash.after`` (the mid-fold kill, before the pane
    folds) then ``stream.resume``: the part file equals the uninterrupted
    run's tail from the restored window on."""
    from avenir_tpu_torch.utils.retry import InjectedFault

    _root, data = job_data
    props = {"feature.schema.file.path": schema, "stream.pane.rows": "16",
             "stream.window.panes": "2",
             "stream.checkpoint.dir": str(tmp_path / "ck"),
             "stream.checkpoint.interval.panes": "4"}
    get_job("StreamAnalytics").run(JobConfig(dict(props)), data,
                                   str(tmp_path / "full"), device="cpu")
    full = _part(tmp_path / "full").splitlines()
    with pytest.raises(InjectedFault):
        get_job("StreamAnalytics").run(
            JobConfig({**props, "fault.fold.crash.after": "7"}), data,
            str(tmp_path / "x"), device="cpu")
    get_job("StreamAnalytics").run(
        JobConfig({**props, "stream.resume": "true"}), data,
        str(tmp_path / "r"), device="cpu")
    tail = _part(tmp_path / "r").splitlines()
    w2 = next(i for i, ln in enumerate(full) if ln.startswith("w=2,panes"))
    assert tail == full[w2:]


def test_stream_analytics_refusals_before_output(schema, job_data,
                                                 tmp_path):
    _root, data = job_data
    base = {"feature.schema.file.path": schema, "stream.pane.rows": "16"}
    for extra, exc, match in (
            ({"shard.devices": "9", "shard.reshard.on.restore": "true"},
             ConfigError, "only 8 device"),
            ({"stream.consumers": "naiveBays"}, ConfigError,
             "unknown stream consumer")):
        out = tmp_path / "out"
        with pytest.raises(exc, match=match):
            get_job("StreamAnalytics").run(JobConfig({**base, **extra}),
                                           data, str(out), device="cpu")
        assert not out.exists()
        assert not (tmp_path / "out.inprogress").exists()
    import unittest.mock

    with unittest.mock.patch.object(torch.cuda, "is_available",
                                    lambda: False):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            get_job("StreamAnalytics").run(JobConfig(dict(base)), data,
                                           str(tmp_path / "o2"))


def test_stream_analytics_cli_equals_jax_cli(schema, job_data, tmp_path,
                                             capsys):
    from avenir_tpu.__main__ import main as jmain
    from avenir_tpu_torch.__main__ import main as tmain

    _root, data = job_data
    argv = ["StreamAnalytics", f"-Dfeature.schema.file.path={schema}",
            "-Dstream.pane.rows=32", "-Dstream.window.panes=2",
            "-Dstream.drift.threshold=0.02"]
    assert tmain(argv + [data, str(tmp_path / "p"), "--device", "cpu"]) == 0
    port_out = capsys.readouterr().out
    assert jmain(argv + [data, str(tmp_path / "j")]) == 0
    jax_out = capsys.readouterr().out
    assert _part(tmp_path / "p") == _part(tmp_path / "j")
    assert "\tpanes=6" in port_out and "\tpanes=6" in jax_out


# ---------------------------------------------------------------------------
# drift
# ---------------------------------------------------------------------------

def test_divergences_equal_jax_bit_for_bit():
    rng = np.random.default_rng(43)
    for k in (2, 3, 7, 13):
        for _ in range(40):
            p = rng.random(k) * (rng.random(k) > 0.2)
            q = rng.random(k) * (rng.random(k) > 0.2)
            p /= max(p.sum(), 1e-12)
            q /= max(q.sum(), 1e-12)
            assert js_divergence(p, q) == jjs(p, q)
            assert chisquare_divergence(p, q) == jchisq(p, q)
    d = chisquare_divergence(np.array([0.99, 0.01]), np.array([1.0, 0.0]))
    assert 0.0 < d < 1.0


def _drift_run(ws, detector, statuses, commit=True):
    fires = []
    for status in statuses:
        (window,) = ws.feed(_const_lines(8, "r", status))
        fires.append(detector.update(window, commit=commit) is not None)
    return fires


@pytest.mark.parametrize("metric", ["js", "chisquare"])
def test_hysteresis_and_rebase_equal_jax(schema, metric):
    statuses = ("pos", "pos", "neg", "neg", "neg", "pos", "pos")
    port = WindowedScan(_enc(schema), [ClassDistributionConsumer(name="cd")],
                        8, device="cpu")
    jax_ = JWindowedScan(_jenc(schema), [JClassDist(name="cd")], 8)
    det = DriftDetector(threshold=0.1, min_windows=2, source="class",
                        metric=metric)
    jdet = JDriftDetector(threshold=0.1, min_windows=2, source="class",
                          metric=metric)
    fires = []
    for status in statuses:
        (w,), (jw,) = (port.feed(_const_lines(8, "r", status)),
                       jax_.feed(_const_lines(8, "r", status)))
        fires.append(det.update(w) is not None)
        assert (jdet.update(jw) is not None) == fires[-1]
        assert det.last_divergence == jdet.last_divergence
        assert (det.streak, det.fired) == (jdet.streak, jdet.fired)
    assert fires[:5] == [False, False, False, True, False]
    state, jstate = det.state(), jdet.state()
    assert [r.tobytes() for r in state["reference"]] == \
        [np.asarray(r).tobytes() for r in jstate["reference"]]


def test_uncommitted_fire_refires_until_committed(schema):
    ws = WindowedScan(_enc(schema), [ClassDistributionConsumer(name="cd")],
                      8, device="cpu")
    detector = DriftDetector(threshold=0.1, min_windows=1, source="class")
    assert _drift_run(ws, detector, ["pos"]) == [False]
    assert _drift_run(ws, detector, ["neg", "neg"], commit=False) == \
        [True, True]
    assert detector.streak == 2
    (w,) = ws.feed(_const_lines(8, "r", "neg"))
    detector.commit_fire(w.tables)
    assert detector.streak == 0
    assert detector.update(ws.feed(_const_lines(8, "r", "neg"))[0]) is None


def test_features_source_without_count_consumer_refused(schema):
    ws = WindowedScan(_enc(schema), [ClassDistributionConsumer(name="cd")],
                      8, device="cpu")
    (window,) = ws.feed(_const_lines(8, "r", "pos"))
    with pytest.raises(ConfigError, match="feature count table"):
        DriftDetector(threshold=0.1, source="features").update(window)
    assert DriftDetector(threshold=0.1, source="both").update(window) is None
    for bad in ({"metric": "kl"}, {"source": "rows"}, {"threshold": 0}):
        kw = {"threshold": 0.1, **bad}
        with pytest.raises(ConfigError):
            DriftDetector(**kw)


def test_feature_source_sees_covariate_shift(schema):
    ws = WindowedScan(_enc(schema), [ClassDistributionConsumer(name="cd"),
                                     scan.NaiveBayesConsumer(name="nb")],
                      8, device="cpu")
    feat = DriftDetector(threshold=0.1, min_windows=1, source="features")
    cls = DriftDetector(threshold=0.1, min_windows=1, source="class")
    (w0,) = ws.feed(_const_lines(4, "r", "pos")
                    + _const_lines(4, "g", "neg", start=4))
    (w1,) = ws.feed(_const_lines(4, "b", "pos")
                    + _const_lines(4, "b", "neg", start=4))
    for detector in (feat, cls):
        assert detector.update(w0) is None
    assert feat.update(w1) is not None
    assert cls.update(w1) is None


def _drift_journal(tracer_mod, read, make_ws, make_det, path):
    tracer = tracer_mod.tracer().enable(str(path))
    try:
        ws, det = make_ws(), make_det()
        for status in ("pos", "pos", "neg", "neg", "neg", "pos"):
            (w,) = ws.feed(_const_lines(8, "r", status))
            det.update(w)
        jpath = tracer.journal_path
    finally:
        tracer_mod.tracer().disable()
    return [{k: v for k, v in e.items() if k not in ("ts", "trace", "span")}
            for e in read(jpath) if e["ev"].startswith("drift.")]


def test_drift_journal_events_equal_jax(schema, tmp_path):
    port = _drift_journal(
        tel, read_events,
        lambda: WindowedScan(_enc(schema),
                             [ClassDistributionConsumer(name="cd")], 8,
                             device="cpu"),
        lambda: DriftDetector(threshold=0.1, source="class"),
        tmp_path / "tp")
    jax_ = _drift_journal(
        jtel, jread_events,
        lambda: JWindowedScan(_jenc(schema), [JClassDist(name="cd")], 8),
        lambda: JDriftDetector(threshold=0.1, source="class"),
        tmp_path / "tj")
    assert port == jax_
    assert [e["ev"] for e in port].count("drift.detected") == 1


# ---------------------------------------------------------------------------
# drift → retrain → hot swap
# ---------------------------------------------------------------------------

def test_retrain_failure_shed_not_fatal(schema, tmp_path, monkeypatch):
    class _Reg:
        def get(self, name):
            return types.SimpleNamespace(family="naiveBayes", device="cpu")

    conf = JobConfig({"stream.retrain.dir": str(tmp_path / "rt")})
    detector = DriftDetector(threshold=0.05, min_windows=1, source="class")
    controller = DriftRetrainController(
        conf, types.SimpleNamespace(registry=_Reg()), detector)
    assert controller.device == "cpu"
    ws = WindowedScan(_enc(schema), [ClassDistributionConsumer(name="cd")],
                      8, retain_rows=True, device="cpu")
    (ref,) = ws.feed(_const_lines(8, "r", "pos"))
    assert controller.on_window(ref) is None

    def boom(window, event):
        raise OSError("no space left on device")

    monkeypatch.setattr(controller, "retrain_and_swap", boom)
    (w1,) = ws.feed(_const_lines(8, "r", "neg"))
    assert controller.on_window(w1) is None
    assert controller.counters.get("Stream", "retrain.failed") == 1
    assert detector.streak == 1
    monkeypatch.setattr(controller, "retrain_and_swap",
                        lambda window, event: 7)
    (w2,) = ws.feed(_const_lines(8, "r", "neg"))
    assert controller.on_window(w2) == 7
    assert detector.streak == 0
    with pytest.raises(ConfigError, match="stream.retrain.dir"):
        DriftRetrainController(JobConfig({}),
                               types.SimpleNamespace(registry=_Reg()),
                               detector)


class _GateServable:
    """Wraps a live entry: scoring blocks until released, which freezes a
    batch in flight so a concurrent swap lands after its dispatch
    resolved the old entry."""

    family = "naiveBayes"

    def __init__(self, inner):
        self.inner = inner
        self.device = inner.device
        self.compile_keys = inner.compile_keys
        self.entered = threading.Event()
        self.release = threading.Event()

    def score_lines(self, lines, pad_to):
        self.entered.set()
        assert self.release.wait(30.0)
        return self.inner.score_lines(lines, pad_to)

    def warmup(self, pad_to):
        self.inner.warmup(pad_to)


@pytest.fixture(scope="module")
def drift_ws(schema, tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_driftswap")
    train = root / "train.csv"
    train.write_text("\n".join(gen_lines(480, seed=31)) + "\n")
    props = {"feature.schema.file.path": schema,
             "bayesian.model.file.path": str(root / "nb_model"),
             "serve.models": "naiveBayes",
             "serve.bucket.sizes": "1,2,4",
             "serve.request.timeout.ms": "30000",
             "stream.retrain.dir": str(root / "retrain")}
    get_job("BayesianDistribution").run(JobConfig(dict(props)), str(train),
                                        str(root / "nb_model"), device="cpu")
    return {"props": props, "root": root}


def test_drift_retrain_swap_end_to_end(schema, drift_ws, tmp_path):
    """Injected shift → ``drift.detected`` → retrain over the drifted
    window through the port's own NB job → swap into the registry: the
    next request scores on the new version while a request in flight
    before the swap finishes on the old parameters; the retrained
    artifact equals the batch job's (and the JAX job's) on the window's
    rows."""
    from avenir_tpu_torch.serving import BucketedMicrobatcher, ModelRegistry

    conf = JobConfig(dict(drift_ws["props"]))
    tracer = tel.tracer().enable(str(tmp_path / "tel"))
    try:
        registry = ModelRegistry.from_conf(conf, device="cpu")
        batcher = BucketedMicrobatcher.from_conf(registry, conf)
        probe = "q1,r,s,1.5"
        assert batcher.submit("naiveBayes", probe).endswith(",pos")
        gate = _GateServable(registry.get("naiveBayes"))
        registry.add("naiveBayes", gate)               # version 2
        inflight = batcher.submit_nowait("naiveBayes", probe)
        assert gate.entered.wait(30.0)
        detector = DriftDetector(threshold=0.01, min_windows=2,
                                 source="class")
        controller = DriftRetrainController(conf, batcher, detector)
        assert str(controller.device) == "cpu"
        ws = WindowedScan(_enc(schema), [ClassDistributionConsumer(name="cd")],
                          64, window_panes=2, retain_rows=True, device="cpu")
        ws.warm()
        versions, fired = [], {}
        for window in ws.feed(gen_lines(256, seed=37)
                              + gen_lines(512, seed=41, flip=True)) \
                + ws.flush():
            v = controller.on_window(window)
            if v is not None:
                versions.append((window.index, v))
                fired[window.index] = window
        assert versions == [(3, 3)]
        assert registry.version("naiveBayes") == 3
        assert controller.swaps == 1 and controller.last_swap_s > 0
        gate.release.set()
        assert inflight.wait(30.0).endswith(",pos")
        assert batcher.submit("naiveBayes", probe).endswith(",neg")
        batcher.close()
    finally:
        path = tracer.journal_path
        tel.tracer().disable()
    events = read_events(path)
    kinds = [e["ev"] for e in events]
    detected = next(e for e in events if e["ev"] == "drift.detected")
    assert detected["window"] == 3 and detected["windows"] == 2
    retrain = next(e for e in events if e["ev"] == "drift.retrain")
    assert retrain["version"] == 3 and retrain["rows"] == 128
    (swap,) = [e for e in events if e["ev"] == "model.swap"]
    assert swap["version"] == 3
    assert kinds.index("drift.detected") < kinds.index("model.swap")
    # the retrained artifact is the batch job's on the same rows, and the
    # JAX package's job's
    stage = drift_ws["root"] / "retrain" / "retrain-w3"
    rows = str(stage / "input.csv")
    assert open(rows).read().splitlines() == fired[3].lines
    props = {k: v for k, v in drift_ws["props"].items()
             if k != "bayesian.model.file.path"}
    get_job("BayesianDistribution").run(JobConfig(dict(props)), rows,
                                        str(tmp_path / "batch"),
                                        device="cpu")
    jget_job("BayesianDistribution").run(JJobConfig(dict(props)), rows,
                                         str(tmp_path / "jbatch"))
    artifact = _part(stage / "model")
    assert artifact == _part(tmp_path / "batch") == \
        _part(tmp_path / "jbatch")


def test_train_conf_drops_artifact_and_durability_keys(drift_ws):
    import types as _t

    class _Reg:
        def get(self, name):
            return _t.SimpleNamespace(family="naiveBayes", device="cpu")

    conf = JobConfig(dict(drift_ws["props"]))
    controller = DriftRetrainController(
        conf, _t.SimpleNamespace(registry=_Reg()),
        DriftDetector(threshold=0.1))
    controller.conf.set("stream.checkpoint.dir", "/nonexistent/ring")
    controller.conf.set("avenir.bayesian.model.file.path", "/stale")
    controller.conf.set("avenir.stream.checkpoint.dir", "/live/ring")
    train_conf = controller._train_conf("/tmp/artifact")
    assert train_conf.get("bayesian.model.file.path") is None
    assert train_conf.get("stream.checkpoint.dir") is None
    event = DriftEvent(window=9, divergence=0.5, streak=2, threshold=0.01)
    restored = WindowResult(9, 0, 1, 10, None, {}, None, retained=True)
    assert controller.retrain_and_swap(restored, event) is None
    assert controller.counters.get("Stream", "retrain.deferred") == 1
    with pytest.raises(ConfigError, match="retain_rows"):
        controller.retrain_and_swap(
            WindowResult(9, 0, 1, 10, None, {}, None, retained=False), event)


def test_tree_retrain_swaps_a_tree(schema, tmp_path):
    """``stream.retrain.model=tree``: DecisionTreeBuilder refits over the
    drifted window (its model equal to the batch job's on the rows) and
    the tree servable swaps in."""
    from avenir_tpu_torch.serving import BucketedMicrobatcher, ModelRegistry

    train = tmp_path / "train.csv"
    train.write_text("\n".join(gen_lines(400, seed=51)) + "\n")
    fit = {"feature.schema.file.path": schema, "max.depth": "2"}
    get_job("DecisionTreeBuilder").run(JobConfig(dict(fit)), str(train),
                                       str(tmp_path / "tree0"), device="cpu")
    props = {**fit, "tree.model.file.path": str(tmp_path / "tree0"),
             "serve.models": "tree", "serve.bucket.sizes": "1,2",
             "stream.retrain.model": "tree",
             "stream.retrain.dir": str(tmp_path / "rt")}
    conf = JobConfig(props)
    registry = ModelRegistry.from_conf(conf, device="cpu")
    with BucketedMicrobatcher.from_conf(registry, conf) as batcher:
        before = batcher.submit("tree", "q1,r,s,1.5")
        controller = DriftRetrainController(
            conf, batcher, DriftDetector(threshold=0.005, min_windows=1,
                                         source="class"))
        ws = WindowedScan(_enc(schema), [ClassDistributionConsumer(name="cd")],
                          64, window_panes=2, retain_rows=True, device="cpu")
        versions = [v for w in ws.feed(gen_lines(128, seed=52)
                                       + gen_lines(256, seed=53, flip=True))
                    for v in [controller.on_window(w)] if v is not None]
        assert versions and registry.version("tree") == versions[0] == 2
        after = batcher.submit("tree", "q1,r,s,1.5")
    assert before.endswith(",pos") and after.endswith(",neg")
    stage = next(p for p in (tmp_path / "rt").iterdir())
    get_job("DecisionTreeBuilder").run(JobConfig(dict(fit)),
                                       str(stage / "input.csv"),
                                       str(tmp_path / "batch"), device="cpu")
    assert _part(stage / "model") == _part(tmp_path / "batch")
