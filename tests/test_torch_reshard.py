"""The port's elastic restore (``avenir_tpu_torch/checkpoint/reshard.py``
and its seams) against the JAX package's on the CPU, in one process.

``tests/conftest.py`` forces eight host devices, so ``shard.devices`` up
to 8 resolves in both packages.  Held here: the key algebra and
``reshard_state_tree`` equal to the JAX package's key for key and byte
for byte; ``ChunkFolder.adopt_state`` (re-key across mesh sizes and a
process-qualified topology, demotion onto the einsum routing, its
refusals); ``WindowCheckpointer``'s gate (kill under 8 shards, resume
under 4 and unsharded, every later window equal to the JAX package's
uninterrupted run's; refused without the gate); the same drill through
``StreamAnalytics`` part files; ``CheckpointManager.restore(reshard_to=)``
and ``StreamCheckpointer``'s gate against the JAX package's.  Tolerance:
none — counts and the part files' bytes are compared exactly.  No test
binds a socket or joins a process.
"""

import json
import os
import shutil

import numpy as np
import pytest

from avenir_tpu.checkpoint import reshard as jreshard
from avenir_tpu.core.config import ConfigError as JConfigError
from avenir_tpu.core.config import JobConfig as JConfig
from avenir_tpu.core.encoding import DatasetEncoder as JEncoder
from avenir_tpu.core.schema import FeatureSchema as JSchema
from avenir_tpu.jobs.base import StreamCheckpointer as JStreamCheckpointer
from avenir_tpu.parallel.shard import ShardSpec as JShardSpec
from avenir_tpu.pipeline import scan as jscan
from avenir_tpu.stream.windows import WindowedScan as JWindowedScan
from avenir_tpu.utils import checkpoint as jckpt
from avenir_tpu_torch.checkpoint import reshard
from avenir_tpu_torch.core.config import ConfigError, JobConfig
from avenir_tpu_torch.core.csv_io import write_csv
from avenir_tpu_torch.core.encoding import DatasetEncoder, EncodedDataset
from avenir_tpu_torch.core.schema import FeatureSchema
from avenir_tpu_torch.datagen.churn import CHURN_SCHEMA_JSON, generate_churn
from avenir_tpu_torch.jobs.base import StreamCheckpointer
from avenir_tpu_torch.ops import agg
from avenir_tpu_torch.parallel.shard import ShardSpec
from avenir_tpu_torch.pipeline import scan
from avenir_tpu_torch.stream.windows import WindowCheckpointer, WindowedScan
from avenir_tpu_torch.telemetry import spans as tel
from avenir_tpu_torch.telemetry.journal import read_events
from avenir_tpu_torch.utils import checkpoint as ckpt_mod
from avenir_tpu_torch.utils.retry import FaultPlan, InjectedFault

N, F, B, C, FC = 768, 4, 5, 2, 2


def spec_for(devices):
    return ShardSpec.from_conf(JobConfig({"shard.devices": str(devices)}),
                               "cpu")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(16)
    codes = rng.integers(0, B, size=(N, F)).astype(np.int32)
    # 1/16-grid continuous values: every partial sum is exact
    cont = (rng.integers(0, 16, size=(N, FC)) / 16.0).astype(np.float32)
    labels = rng.integers(0, C, size=N).astype(np.int32)
    return codes, cont, labels


def mk_ds(data):
    codes, cont, labels = data
    return EncodedDataset(
        codes=codes, cont=cont, labels=labels,
        n_bins=np.full(F, B, np.int32), class_values=["a", "b"],
        binned_ordinals=list(range(F)),
        cont_ordinals=list(range(F, F + FC)))


def _schema_json():
    fields = [{"name": "id", "ordinal": 0, "id": True, "dataType": "string"}]
    for j in range(F):
        fields.append({"name": f"f{j}", "ordinal": 1 + j, "feature": True,
                       "dataType": "categorical",
                       "cardinality": [str(v) for v in range(B)]})
    for j in range(FC):
        fields.append({"name": f"x{j}", "ordinal": 1 + F + j,
                       "feature": True, "dataType": "double"})
    fields.append({"name": "cls", "ordinal": 1 + F + FC,
                   "dataType": "categorical", "cardinality": ["a", "b"]})
    return {"fields": fields}


def _lines(data):
    codes, cont, labels = data
    return [",".join([f"r{i}"] + [str(int(v)) for v in codes[i]]
                     + [repr(float(x)) for x in cont[i]]
                     + [["a", "b"][int(labels[i])]])
            for i in range(len(labels))]


# ---------------------------------------------------------------------------
# the key algebra, against the JAX package's
# ---------------------------------------------------------------------------

G8 = "g:cls:f4:b5:c2:mesh:data8"


def test_split_and_spec_suffix():
    for key in (G8, "g:cls:f4:b5:c2", "g:fmaj:f10:b13:c2:mesh:proc2xdata1"):
        assert reshard.split_mesh_key(key) == jreshard.split_mesh_key(key)
    assert reshard.spec_suffix(None) == ""
    assert reshard.spec_suffix(":mesh:data4") == ":mesh:data4"
    assert reshard.spec_suffix(spec_for(8)) == ":mesh:data8" == \
        jreshard.spec_suffix(JShardSpec.from_conf(
            JConfig({"shard.devices": "8"})))
    with pytest.raises(reshard.ReshardError, match="mesh qualifier"):
        reshard.spec_suffix("data4")
    for sfx in ("", ":mesh:data8", ":mesh:proc2xdata4", ":mesh:hosts3xd1"):
        assert reshard.suffix_procs(sfx) == jreshard.suffix_procs(sfx)
        assert reshard.describe(sfx) == jreshard.describe(sfx)


def test_rekey_state_moves_only_mesh_qualified_grams():
    g = np.arange(8, dtype=np.int64)
    state = {G8: g, "class": np.ones(2, np.int64), "cont_sum": np.ones((2, 2))}
    out, moved = reshard.rekey_state(state, ":mesh:data4")
    want, jmoved = jreshard.rekey_state(state, ":mesh:data4")
    assert moved == jmoved == [G8]
    assert list(out) == list(want)
    assert out["g:cls:f4:b5:c2:mesh:data4"] is g     # the same bytes
    again, moved2 = reshard.rekey_state(out, ":mesh:data4")
    assert moved2 == [] and set(again) == set(out)


@pytest.mark.parametrize("case", ["foreign", "mixed", "collision"])
def test_rekey_state_refusals_equal_jax(case):
    mixed = {G8: np.zeros(1), "g:cls:f4:b5:c2:mesh:data4": np.zeros(1)}
    call = {"foreign": lambda m: m.rekey_state(
                {G8: np.zeros(1)}, ":mesh:data4", source=":mesh:shards2"),
            "mixed": lambda m: m.rekey_state(mixed, ":mesh:data2"),
            "collision": lambda m: m.rekey_state(
                mixed, ":mesh:data4", source=":mesh:data8")}[case]
    with pytest.raises(jreshard.ReshardError) as want:
        call(jreshard)
    with pytest.raises(reshard.ReshardError) as got:
        call(reshard)
    assert str(got.value) == str(want.value)


def test_state_and_snapshot_suffix_inference():
    cases = [{"ring": [{"state": {}}, {"state": {G8: np.ones(1)}}]},
             {"shard": ":mesh:data2"}, {"ring": [{"state": {}}]},
             {"acc": {"g:cls:f4:b5:c2": np.ones(2)}}]
    for snap in cases:
        assert reshard.snapshot_suffix(snap) == jreshard.snapshot_suffix(snap)
    assert reshard.state_suffix({"class": np.ones(2)}) is None
    bad = {"ring": [{"state": {G8: np.ones(1)}},
                    {"state": {"g:cls:f4:b5:c2": np.ones(1)}}], "acc": {}}
    with pytest.raises(reshard.ReshardError, match="topologies"):
        reshard.snapshot_suffix(bad)


@pytest.mark.parametrize("target", ["", ":mesh:data4", ":mesh:proc2xdata1"])
def test_reshard_state_tree_equals_jax_key_for_key(target):
    """The rekeyed tree equals the JAX package's ``reshard_state_tree``:
    the same keys in the same order, the same bytes under each."""
    rng = np.random.default_rng(5)
    tree = {"run": "rid", "shard": ":mesh:data8",
            "ring": [{"pane": 0, "rows": 5,
                      "state": {G8: rng.integers(0, 9, (2, 20, 20)),
                                "class": np.array([3, 2], np.int64)}},
                     {"pane": 1, "rows": 0, "state": {}}],
            "acc": {G8: rng.integers(0, 9, (2, 20, 20)),
                    "cont_sum": rng.random((2, 2))},
            "extras": {"lr": {"weights": np.ones(4), "history": [1, 2]}}}
    out, moved = reshard.reshard_state_tree(tree, target)
    want, jmoved = jreshard.reshard_state_tree(tree, target)
    assert moved == jmoved and len(moved) == 2

    def flat(node, path=""):
        if isinstance(node, dict):
            return [(f"{path}/{k}", v) for key, val in node.items()
                    for k, v in flat(val, f"{path}/{key}")] or [(path, None)]
        if isinstance(node, list):
            return [x for i, val in enumerate(node)
                    for x in flat(val, f"{path}[{i}]")] or [(path, None)]
        return [("", node)]

    got, exp = flat(out), flat(want)
    assert [k for k, _ in got] == [k for k, _ in exp]
    for (key, a), (_, b) in zip(got, exp):
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), key
        else:
            assert a == b, key
    assert out["shard"] == target


# ---------------------------------------------------------------------------
# ChunkFolder.adopt_state: refuse or reshard, never silently fold
# ---------------------------------------------------------------------------

def _fold_state(data, shard=None, pack_on=True):
    ds = mk_ds(data)
    folder = scan.ChunkFolder(
        [scan.NaiveBayesConsumer(name="nb"),
         scan.MutualInfoConsumer(name="mi")], ds, "cpu", shard=shard,
        pack_on=pack_on)
    acc = agg.Accumulator()
    folder.fold(ds, acc)
    return folder, acc.state()


def _tables(folder, state):
    acc = agg.Accumulator()
    acc.load(state)
    return folder.tables(acc, N)


def _jax_tables(data):
    """The JAX package's unsharded fold of the same chunk."""
    from avenir_tpu.core.encoding import EncodedDataset as JDataset
    from avenir_tpu.ops import agg as jagg

    codes, cont, labels = data
    ds = JDataset(codes=codes, cont=cont, labels=labels,
                  n_bins=np.full(F, B, np.int32), class_values=["a", "b"],
                  binned_ordinals=list(range(F)),
                  cont_ordinals=list(range(F, F + FC)))
    folder = jscan.ChunkFolder([jscan.NaiveBayesConsumer(name="nb"),
                                jscan.MutualInfoConsumer(name="mi")], ds)
    acc = jagg.Accumulator()
    folder.fold(ds, acc)
    return folder.tables(acc, N)


def _assert_tables(got, want):
    np.testing.assert_array_equal(np.asarray(got.fbc), np.asarray(want.fbc))
    np.testing.assert_array_equal(np.asarray(got.pcc), np.asarray(want.pcc))
    np.testing.assert_array_equal(np.asarray(got.class_counts),
                                  np.asarray(want.class_counts))


@pytest.mark.parametrize("source", [":mesh:data8", ":mesh:proc2xdata4"])
def test_adopt_state_rekeys_onto_four_shards(data, source):
    """A fold under 8 shards — or the same totals under a 2-process
    topology — adopted by a 4-shard folder reads the JAX package's
    unsharded tables."""
    f8, state8 = _fold_state(data, spec_for(8))
    state, _ = reshard.rekey_state(state8, source)
    f4, _ = _fold_state(data, spec_for(4))
    assert f4.g_suffix == ":mesh:data4"
    adopted, moved = f4.adopt_state(state)
    assert moved == [reshard.split_mesh_key(f8.gk)[0] + source]
    _assert_tables(_tables(f4, adopted), _jax_tables(data))


def test_adopt_state_demotes_gram_onto_einsum_routing(data):
    f8, state8 = _fold_state(data, spec_for(8))
    plain, plain_state = _fold_state(data, pack_on=False)
    assert plain.step == "einsum"
    adopted, moved = plain.adopt_state(state8)
    assert moved == [f8.gk]
    assert "fc" in adopted and not any(k.startswith("g:") for k in adopted)
    _assert_tables(_tables(plain, adopted), _jax_tables(data))
    same, moved_same = plain.adopt_state(plain_state)
    assert moved_same == [] and same is plain_state


def test_adopt_state_renames_packed_provenance(data):
    packed, packed_state = _fold_state(data)
    assert packed.step == "packed"
    f4, _ = _fold_state(data, spec_for(4))
    adopted, moved = f4.adopt_state(packed_state)
    assert moved == [packed.gk, "g:fmaj:f4:b5:c2"]   # renamed, re-keyed
    _assert_tables(_tables(f4, adopted), _jax_tables(data))


@pytest.mark.parametrize("case", ["promote", "layout", "mixed"])
def test_adopt_state_refusals(data, case):
    f8, state8 = _fold_state(data, spec_for(8))
    _, plain_state = _fold_state(data, pack_on=False)
    state, match = {
        "promote": (plain_state, "promotion"),
        "layout": ({"g:cls:f9:b9:c9:mesh:data8": np.zeros((2, 4, 4))},
                   "base layout"),
        "mixed": ({**state8, "fc": np.zeros((F, B, C))}, "mixed-routing"),
    }[case]
    with pytest.raises(reshard.ReshardError, match=match):
        f8.adopt_state(state)


def test_tables_refusal_names_the_reshard_gate(data):
    _, state8 = _fold_state(data, spec_for(8))
    f4, _ = _fold_state(data, spec_for(4))
    with pytest.raises(scan.ScanError, match="shard.reshard.on.restore"):
        _tables(f4, state8)


# ---------------------------------------------------------------------------
# WindowCheckpointer: kill under 8 shards, resume under 4 and unsharded
# ---------------------------------------------------------------------------

def _consumers(mod):
    return [mod.NaiveBayesConsumer(name="nb"),
            mod.MutualInfoConsumer(name="mi")]


def _windowed(enc, shard=None, checkpointer=None, fault=None, pack_on=True):
    return WindowedScan(enc, _consumers(scan), pane_rows=128,
                        window_panes=2, slide_panes=1, device="cpu",
                        shard=shard, checkpointer=checkpointer, fault=fault,
                        pack_on=pack_on)


@pytest.fixture(scope="module")
def drill(data, tmp_path_factory):
    """The JAX package's uninterrupted windows and one port run killed at
    its fifth fold under 8 shards, its ring snapshotted every 2 panes."""
    lines = _lines(data)
    jws = JWindowedScan(JEncoder(JSchema.from_json(_schema_json())),
                        _consumers(jscan), pane_rows=128, window_panes=2,
                        slide_panes=1)
    oracle = jws.feed(lines)
    oracle.extend(jws.flush())
    enc = DatasetEncoder(FeatureSchema.from_json(_schema_json()))
    ring = tmp_path_factory.mktemp("drill") / "ring"
    ws8 = _windowed(enc, shard=spec_for(8),
                    checkpointer=WindowCheckpointer(str(ring), run_id="drill",
                                                    interval_panes=2),
                    fault=FaultPlan({"fold": 5}))
    with pytest.raises(InjectedFault, match="fold boundary"):
        ws8.feed(lines)
    assert os.listdir(ring)
    return {"enc": enc, "lines": lines, "oracle": oracle, "ring": ring}


def _resume(drill, tmp_path, shard=None, pack_on=True, reshard_on=True):
    ring = tmp_path / "ring"
    shutil.copytree(drill["ring"], ring)
    ck = WindowCheckpointer(str(ring), run_id="drill", interval_panes=2,
                            resume=True, reshard=reshard_on)
    return ck, _windowed(drill["enc"], shard=shard, checkpointer=ck,
                         pack_on=pack_on)


@pytest.mark.parametrize("target", ["4", "8", "unsharded"])
def test_window_restore_equals_jax_uninterrupted(drill, tmp_path, target):
    """Resumed under 4 shards, the same 8, or unsharded (the gram demoted
    onto the einsum routing), every window after the restore equals the
    JAX package's uninterrupted run's; the crossing is journaled."""
    shard = None if target == "unsharded" else spec_for(target)
    tracer = tel.tracer().enable(str(tmp_path / "tel"))
    try:
        ck, ws = _resume(drill, tmp_path, shard=shard,
                         pack_on=target != "unsharded")
        skip = ck.restore_into(ws)
        path = tracer.journal_path
    finally:
        tel.tracer().disable()
    assert 0 < skip < len(drill["lines"])
    resumed = ws.feed(drill["lines"][skip:])
    resumed.extend(ws.flush())
    assert ws.windows_emitted == len(drill["oracle"])
    want = {w.index: w for w in drill["oracle"]}
    assert resumed
    for got in resumed:
        exp = want[got.index]
        np.testing.assert_array_equal(got.results["nb"].bin_counts,
                                      np.asarray(exp.results["nb"].bin_counts))
        np.testing.assert_array_equal(got.results["nb"].cont_sumsq,
                                      np.asarray(exp.results["nb"].cont_sumsq))
        assert got.results["mi"].to_lines() == exp.results["mi"].to_lines()
    events = [e for e in read_events(path) if e["ev"] == "checkpoint.reshard"]
    if target == "8":
        assert events == []                    # same topology: no crossing
    else:
        assert [(e["src"], e["dst"]) for e in events] == [
            (":mesh:data8", ws.folder.g_suffix or "unsharded")]
        assert events[0]["keys"] > 0


def test_window_restore_refused_without_gate(drill, tmp_path):
    """Without the gate the restore is refused with the JAX package's
    message, word for word, before any pane folds."""
    from avenir_tpu.stream.windows import WindowCheckpointer as JCheckpointer

    ck, ws4 = _resume(drill, tmp_path, shard=spec_for(4), reshard_on=False)
    with pytest.raises(ConfigError, match="shard.reshard.on.restore=true") \
            as got:
        ck.restore_into(ws4)
    assert ws4.panes_closed == 0
    jck = JCheckpointer(str(tmp_path / "ring"), run_id="drill",
                        interval_panes=2, resume=True)
    jws = JWindowedScan(JEncoder(JSchema.from_json(_schema_json())),
                        _consumers(jscan), pane_rows=128, window_panes=2,
                        slide_panes=1, shard=JShardSpec.from_conf(
                            JConfig({"shard.devices": "4"})),
                        checkpointer=jck)
    with pytest.raises(JConfigError) as want:
        jck.restore_into(jws)
    assert str(got.value) == str(want.value)
    conf = JobConfig({"stream.checkpoint.dir": str(tmp_path / "other")})
    assert WindowCheckpointer.from_conf(conf).reshard is False
    conf.set("shard.reshard.on.restore", "true")
    assert WindowCheckpointer.from_conf(conf).reshard is True


# ---------------------------------------------------------------------------
# the same drill through StreamAnalytics' part files
# ---------------------------------------------------------------------------

STREAM = {"stream.pane.rows": "128", "stream.window.panes": "2",
          "stream.consumers": "classDistribution,naiveBayes,mutualInfo",
          "stream.checkpoint.interval.panes": "2"}


@pytest.fixture(scope="module")
def churn(tmp_path_factory):
    work = tmp_path_factory.mktemp("torch_reshard")
    write_csv(str(work / "train.csv"), generate_churn(1100, seed=3))
    (work / "churn.json").write_text(json.dumps(CHURN_SCHEMA_JSON))
    from avenir_tpu.jobs import get_job as jget_job

    jget_job("StreamAnalytics").run(
        JConfig({"feature.schema.file.path": str(work / "churn.json"),
                 **STREAM}), str(work / "train.csv"), str(work / "jax"))
    return work


def _analytics(churn, out, **extra):
    from avenir_tpu_torch.jobs import get_job

    props = {"feature.schema.file.path": str(churn / "churn.json"),
             **STREAM, **extra}
    get_job("StreamAnalytics").run(JobConfig(props), str(churn / "train.csv"),
                                   str(out), device="cpu")
    return (out / "part-00000").read_text()


@pytest.mark.parametrize("resume_devices", ["4", None])
def test_stream_analytics_kill8_resume_equals_jax(churn, tmp_path,
                                                  resume_devices):
    """StreamAnalytics killed under ``shard.devices=8`` resumes under 4
    devices or unsharded with ``shard.reshard.on.restore``: its part file
    is the JAX package's uninterrupted one from the restored window on;
    without the gate the resume is refused before any output."""
    ck = {"stream.checkpoint.dir": str(tmp_path / "ck")}
    with pytest.raises(InjectedFault):
        _analytics(churn, tmp_path / "x", **ck, **{
            "shard.devices": "8", "fault.fold.crash.after": "5"})
    resume = dict(ck, **{"stream.resume": "true"})
    if resume_devices:
        resume["shard.devices"] = resume_devices
    with pytest.raises(ConfigError, match="shard.reshard.on.restore=true"):
        _analytics(churn, tmp_path / "refused", **resume)
    assert not (tmp_path / "refused").exists()
    tail = _analytics(churn, tmp_path / "r", **resume, **{
        "shard.reshard.on.restore": "true"}).splitlines()
    full = (churn / "jax" / "part-00000").read_text().splitlines()
    first = next(i for i, ln in enumerate(full)
                 if ln.startswith(tail[0].split(",")[0] + ","))
    assert first > 0 and tail == full[first:]
    assert not (tmp_path / "ck").exists()       # the clean finish sweeps


# ---------------------------------------------------------------------------
# CheckpointManager.restore(reshard_to=) and StreamCheckpointer's gate
# ---------------------------------------------------------------------------

def test_manager_restore_reshard_to_equals_jax(tmp_path):
    mgr = ckpt_mod.CheckpointManager(str(tmp_path / "ck"))
    mgr.save(3, {"run": "rid", "shard": ":mesh:data8",
                 "acc": {G8: np.arange(4, dtype=np.int64)}})
    jmgr = jckpt.CheckpointManager(str(tmp_path / "ck"))
    assert G8 in mgr.restore()["acc"]
    for target in (":mesh:data2", ""):
        got = mgr.restore(reshard_to=target)
        want = jmgr.restore(reshard_to=target)
        assert list(got["acc"]) == list(want["acc"])
        assert got["shard"] == want["shard"] == target
        for k in got["acc"]:
            assert got["acc"][k].tobytes() == want["acc"][k].tobytes()
    moved = mgr.restore(reshard_to=spec_for(4))
    assert list(moved["acc"]) == ["g:cls:f4:b5:c2:mesh:data4"]


def _seed_stream_snapshot(directory):
    mgr = ckpt_mod.CheckpointManager(str(directory), keep=2)
    mgr.save(4, {"run": "rid",
                 "acc": {G8: np.arange(6, dtype=np.int64),
                         "class": np.ones(2, np.int64)},
                 "cursor": {"file": "data.csv", "offset": 100, "chunk": 4},
                 "rows": 400})


def test_stream_checkpointer_refuses_then_reshards_as_jax(tmp_path):
    _seed_stream_snapshot(tmp_path / "sck")
    with pytest.raises(JConfigError) as want:
        JStreamCheckpointer(str(tmp_path / "sck"), resume=True, run_id="rid")
    with pytest.raises(ConfigError) as got:
        StreamCheckpointer(str(tmp_path / "sck"), resume=True, run_id="rid")
    assert str(got.value) == str(want.value)
    tracer = tel.tracer().enable(str(tmp_path / "tel"))
    try:
        ck = StreamCheckpointer(str(tmp_path / "sck"), resume=True,
                                run_id="rid", reshard=True)
        path = tracer.journal_path
    finally:
        tel.tracer().disable()
    jck = JStreamCheckpointer(str(tmp_path / "sck"), resume=True,
                              run_id="rid", reshard=True)
    assert ck.error is None and jck.error is None
    got_state, want_state = ck.accumulator.state(), jck.accumulator.state()
    assert sorted(got_state) == sorted(want_state) == ["class",
                                                       "g:cls:f4:b5:c2"]
    for k in got_state:
        assert got_state[k].tobytes() == np.asarray(want_state[k]).tobytes()
    assert ck.base_rows == jck.base_rows == 400
    assert ck.start == jck.start
    (ev,) = [e for e in read_events(path) if e["ev"] == "checkpoint.reshard"]
    assert (ev["src"], ev["dst"], ev["keys"]) == (":mesh:data8",
                                                   "unsharded", 1)
