"""The port's shard plane (``avenir_tpu_torch/parallel``) against the JAX
package's on the CPU.

``tests/conftest.py`` forces eight host devices for every test process, so
``shard.devices`` up to 8 resolves in both packages: the JAX package's
host mesh of eight CPU devices (its Pallas gram in interpret mode, psum'd
by ``shard_map``) and the port's eight CPU shard slots (each shard's block
folded through B1's plain version, the partials added in shard order).

Held here: pipeline part files (NB, MI, Cramér) byte-identical between the
packages and to the port's unsharded run at 1, 2, 3, 5 and 8 devices, one
chunk and a ragged tail; the staging pad and ballast contract; the
mesh-qualified gram key and the stale-topology refusal; the
``shard.topology`` and ``shard.skew`` events; ``from_conf``'s refusals;
sharded windows, ``StreamAnalytics`` and their snapshots; the quantized
all-reduce (bit-equal where every partial is ≤ 127, else within the JAX
package's own bound of scale/2 per device); the process plane's keys,
which one process runs as the same conf without them.  No test binds a
socket or joins a process (the fleets are tests/test_torch_multiprocess.py).
"""

import json
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avenir_tpu.core.config import ConfigError as JConfigError
from avenir_tpu.core.config import JobConfig as JConfig
from avenir_tpu.core.encoding import EncodedDataset as JDataset
from avenir_tpu.core.encoding import pad_rows as jpad_rows
from avenir_tpu.ops import agg as jagg
from avenir_tpu.parallel import collectives as jcoll
from avenir_tpu.parallel import mesh as jmesh
from avenir_tpu.parallel.shard import ShardSpec as JShardSpec
from avenir_tpu.parallel.skew import publish_skew as jpublish_skew
from avenir_tpu.pipeline import driver as jdriver
from avenir_tpu.pipeline import scan as jscan
from avenir_tpu.telemetry import spans as jtel
from avenir_tpu.telemetry.journal import read_events as jread_events
from avenir_tpu.utils.metrics import Counters as JCounters
from avenir_tpu_torch.core.config import ConfigError, JobConfig
from avenir_tpu_torch.core.csv_io import write_csv
from avenir_tpu_torch.core.encoding import EncodedDataset, pad_ballast, pad_rows
from avenir_tpu_torch.datagen.churn import CHURN_SCHEMA_JSON, generate_churn
from avenir_tpu_torch.ops import agg, hist
from avenir_tpu_torch.parallel import collectives, mesh as pmesh
from avenir_tpu_torch.parallel.shard import ShardSpec
from avenir_tpu_torch.parallel.skew import publish_skew
from avenir_tpu_torch.pipeline import driver, scan
from avenir_tpu_torch.telemetry import profile as prof_mod
from avenir_tpu_torch.telemetry import spans as tel
from avenir_tpu_torch.telemetry.journal import read_events
from avenir_tpu_torch.utils.metrics import Counters

N, F, B, C, FC = 2200, 5, 6, 2, 3
ROWS = 1100                       # churn rows: 512 + 512 + a 76-row tail
ARTIFACTS = ("nb_model", "mi_out", "cramer_out")
EVENT_ENVELOPE = ("ts", "trace", "span", "proc", "writer", "pid", "host")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(12)
    codes = rng.integers(0, B, size=(N, F)).astype(np.int32)
    # 1/16-grid continuous values: every partial sum is exact, so the
    # sharded moments equal the unsharded fold's byte for byte
    cont = (rng.integers(0, 16, size=(N, FC)) / 16.0).astype(np.float32)
    labels = rng.integers(0, C, size=N).astype(np.int32)
    return codes, cont, labels


def mk_ds(data, cls=EncodedDataset):
    codes, cont, labels = data
    return cls(codes=codes, cont=cont, labels=labels,
               n_bins=np.full(F, B, np.int32), class_values=["a", "b"],
               binned_ordinals=list(range(F)),
               cont_ordinals=list(range(F, F + FC)))


def chunks_of(data, size=700):
    ds = mk_ds(data)
    return iter([ds.slice(i, min(i + size, N)) for i in range(0, N, size)])


def spec_for(devices="8", **extra):
    props = {"shard.devices": str(devices), **extra}
    return ShardSpec.from_conf(JobConfig(props), "cpu")


def jspec_for(devices="8", **extra):
    return JShardSpec.from_conf(JConfig({"shard.devices": str(devices),
                                         **extra}))


def build_engine(shard=None, counters=None):
    eng = scan.SharedScan(device="cpu", shard=shard, counters=counters)
    eng.register(scan.NaiveBayesConsumer(name="nb"))
    eng.register(scan.MutualInfoConsumer(name="mi"))
    eng.register(scan.CorrelationConsumer(name="cramer", against_class=True))
    eng.register(scan.FisherConsumer(name="fisher"))
    eng.register(scan.MomentsConsumer(name="moments"))
    return eng


def assert_results_identical(got, want):
    eq = np.testing.assert_array_equal
    for attr in ("bin_counts", "class_counts", "cont_count", "cont_sum",
                 "cont_sumsq"):
        eq(getattr(got["nb"], attr), getattr(want["nb"], attr))
    eq(got["mi"].pair_class_counts, want["mi"].pair_class_counts)
    assert got["mi"].to_lines() == want["mi"].to_lines()
    eq(got["cramer"].contingency, want["cramer"].contingency)
    eq(got["cramer"].stat, want["cramer"].stat)
    eq(got["fisher"].boundary, want["fisher"].boundary)
    for g, w in zip(got["moments"], want["moments"]):
        eq(g, w)


def _bare(event):
    return {k: v for k, v in event.items() if k not in EVENT_ENVELOPE}


# ---------------------------------------------------------------------------
# the fused pipeline over a CSV: both packages, every device count
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def churn(tmp_path_factory):
    work = tmp_path_factory.mktemp("torch_shard")
    write_csv(str(work / "train.csv"), generate_churn(ROWS, seed=3))
    (work / "churn.json").write_text(json.dumps(CHURN_SCHEMA_JSON))
    return work


def _props(work, stages=("nb", "mi", "cramer"), **extra):
    jobs = {"nb": ("BayesianDistribution", "nb_model"),
            "mi": ("MutualInformation", "mi_out"),
            "cramer": ("CramerCorrelation", "cramer_out")}
    props = {"pipeline.stages": ",".join(stages),
             "pipeline.bind.train": str(work / "train.csv"),
             "feature.schema.file.path": str(work / "churn.json")}
    for st in stages:
        job, out = jobs[st]
        props[f"pipeline.stage.{st}.job"] = job
        props[f"pipeline.stage.{st}.input"] = "train"
        props[f"pipeline.stage.{st}.output"] = out
    props.update(extra)
    return props


def _parts(ws, artifacts=ARTIFACTS):
    return [(pathlib.Path(ws) / a / "part-00000").read_bytes()
            for a in artifacts]


OUTPUTS = dict(zip(("nb", "mi", "cramer"), ARTIFACTS))


def _run_port(work, name, stages=("nb", "mi", "cramer"), **extra):
    counters = driver.Pipeline.from_conf(
        JobConfig(_props(work, stages, **extra)), workspace=str(work / name),
        device="cpu").run()
    return counters, _parts(work / name, [OUTPUTS[s] for s in stages])


def _run_jax(work, name, stages=("nb", "mi", "cramer"), **extra):
    counters = jdriver.Pipeline.from_conf(
        JConfig(_props(work, stages, **extra)),
        workspace=str(work / name)).run()
    return counters, _parts(work / name, [OUTPUTS[s] for s in stages])


@pytest.mark.parametrize("chunk", ["512", "whole"])
@pytest.mark.parametrize("devices", ["1", "2", "3", "5", "8"])
def test_pipeline_part_files_equal_jax_and_unsharded(churn, devices, chunk):
    """NB, MI and Cramér part files of the sharded fused pipeline are
    byte-identical to the JAX package's under the same conf and to the
    port's unsharded run — in one chunk and in 512-row chunks with a
    76-row tail — and the Shard counters are the JAX package's."""
    extra = {} if chunk == "whole" else {"stream.chunk.rows": chunk}
    tag = f"{devices}_{chunk}"
    _c0, plain = _run_port(churn, f"plain_{tag}", **extra)
    got_c, got = _run_port(churn, f"port_{tag}", **extra,
                           **{"shard.devices": devices})
    want_c, want = _run_jax(churn, f"jax_{tag}", **extra,
                            **{"shard.devices": devices})
    assert got == want == plain
    chunks = 1 if chunk == "whole" else 3
    assert got_c["nb"].get("SharedScan", "FusedStages") == 3
    for name in ("chunks", "collective.bytes"):
        assert got_c["nb"].get("Shard", name) == \
            want_c["nb"].get("Shard", name)
    assert got_c["nb"].get("Shard", "chunks") == chunks


def test_singleton_stage_shards_and_journals_one_topology(churn, tmp_path):
    """A singleton count stage takes the SharedScan under a topology, its
    part file equal to the unsharded pipeline's, and the journal holds one
    ``shard.topology`` event, equal to the JAX package's."""
    extra = {"stream.chunk.rows": "512", "shard.devices": "8",
             "trace.on": "true"}
    journals = {}
    for pkg, run in (("port", _run_port), ("jax", _run_jax)):
        extra["trace.journal.dir"] = str(tmp_path / pkg)
        try:
            counters = run(churn, f"single_{pkg}", stages=("mi",), **extra)[0]
        finally:
            (tel if pkg == "port" else jtel).tracer().disable()
        assert counters["mi"].get("SharedScan", "FusedStages") == 1
        assert counters["mi"].get("Shard", "chunks") == 3
        (path,) = (tmp_path / pkg).glob("*.jsonl")
        reader = read_events if pkg == "port" else jread_events
        journals[pkg] = [_bare(e) for e in reader(str(path))
                         if e["ev"] == "shard.topology"]
    assert journals["port"] == journals["jax"]
    assert journals["port"] == [{
        "ev": "shard.topology", "devices": 8, "device_kind": "cpu",
        "mesh": {"data": 8}, "axes": ["data"], "procs": 1}]
    _c, plain = _run_port(churn, "single_plain", stages=("mi",),
                          **{"stream.chunk.rows": "512"})
    assert _parts(churn / "single_port", ("mi_out",)) == plain


PLANS = {
    # a singleton count stage stays a scan unit under a topology
    "singleton": {"pipeline.stages": "mi"},
    # two correlation stages over four of the five columns: the prune
    # rewrite gathers the kept columns of every staged chunk's blocks
    "prune": {"pipeline.stages": "c1,c2",
              "pipeline.stage.c1.job": "CramerCorrelation",
              "pipeline.stage.c1.prop.source.attributes": "1,2",
              "pipeline.stage.c1.prop.dest.attributes": "4",
              "pipeline.stage.c2.job": "CramerCorrelation",
              "pipeline.stage.c2.prop.source.attributes": "1",
              "pipeline.stage.c2.prop.dest.attributes": "5"},
}


@pytest.mark.parametrize("case", sorted(PLANS))
def test_plan_units_shard_as_the_jax_planner(churn, capsys, case):
    """Under a topology the planner's unit is the ``shard`` program and
    ``plan explain`` prints the JAX package's lines; the planned run
    writes the staged run's bytes, and the JAX package's."""
    from avenir_tpu.pipeline.__main__ import main as jmain
    from avenir_tpu_torch.pipeline.__main__ import main as pmain

    props = _props(churn, stages=("mi",), **{"shard.devices": "3",
                                             "stream.chunk.rows": "512"})
    props.update(PLANS[case])
    outs = []
    for st in props["pipeline.stages"].split(","):
        props.setdefault(f"pipeline.stage.{st}.input", "train")
        props.setdefault(f"pipeline.stage.{st}.output", f"{st}_out")
        outs.append(props[f"pipeline.stage.{st}.output"])
    conf = churn / f"plan_{case}.properties"
    conf.write_text("\n".join(f"{k}={v}" for k, v in props.items()))
    assert pmain(["plan", "explain", str(conf), "--device", "cpu"]) == 0
    port = capsys.readouterr().out
    assert jmain(["plan", "explain", str(conf)]) == 0
    assert port == capsys.readouterr().out
    assert "program: shard" in port
    assert ("prune: 5 -> 4 binned columns" in port) == (case == "prune")
    parts = {}
    for name, fn, extra in (("planned", pmain, ["-Dplan.on=true"]),
                            ("staged", pmain, ["-Dshard.devices=0"]),
                            ("jax", jmain, ["-Dplan.on=true"])):
        ws = churn / f"plan_{case}_{name}"
        argv = ["run", str(conf), f"-Dpipeline.workspace={ws}", *extra]
        assert fn(argv + (["--device", "cpu"] if fn is pmain else [])) == 0
        parts[name] = _parts(ws, outs)
    capsys.readouterr()
    assert parts["planned"] == parts["staged"] == parts["jax"]


# ---------------------------------------------------------------------------
# the SharedScan fold, chunk by chunk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("devices", ["1", "2", "3", "5", "8"])
def test_sharded_scan_every_consumer_and_odd_counts(data, devices):
    """Every consumer of a sharded SharedScan over a ragged stream (and
    over one whole input) equals the unsharded fold's; device counts that
    do not divide the pow-2 targets round the target up."""
    base = build_engine().run(chunks_of(data))
    counters = Counters()
    out = build_engine(spec_for(devices), counters).run(chunks_of(data))
    assert_results_identical(out, base)
    assert counters.get("Shard", "chunks") == 4
    assert counters.get("Shard", "collective.bytes") > 0
    assert_results_identical(build_engine(spec_for(devices)).run(mk_ds(data)),
                             build_engine().run(mk_ds(data)))


def test_quantized_small_partials_exact_and_collective_bytes(data):
    """``shard.allreduce.quantized`` with per-shard partials ≤ 127 folds
    the exact tables, and the logical payload per chunk is the JAX
    package's (int8 cells and float32 row scales)."""
    base = build_engine().run(chunks_of(data, size=550))
    counters = Counters()
    spec = spec_for("8", **{"shard.allreduce.quantized": "true"})
    out = build_engine(spec, counters).run(chunks_of(data, size=550))
    assert_results_identical(out, base)
    jcounters = JCounters()
    jeng = jscan.SharedScan(
        shard=jspec_for("8", **{"shard.allreduce.quantized": "true"}),
        counters=jcounters)
    jeng.register(jscan.NaiveBayesConsumer(name="nb"))
    jeng.register(jscan.MutualInfoConsumer(name="mi"))
    jeng.register(jscan.CorrelationConsumer(name="cramer",
                                            against_class=True))
    jeng.register(jscan.FisherConsumer(name="fisher"))
    jeng.register(jscan.MomentsConsumer(name="moments"))
    jeng.run(iter([mk_ds(data, JDataset).slice(i, min(i + 550, N))
                   for i in range(0, N, 550)]))
    assert counters.get("Shard", "collective.bytes") == \
        jcounters.get("Shard", "collective.bytes")


def test_sharded_scan_step_outputs_equal_local_oracles(rng):
    """The fused step: gram, class counts and moments summed over eight
    shards equal the one-block gram and the local moments."""
    m = pmesh.make_mesh(("data",), shape=(8,), device="cpu")
    n, f, fc = 512, 4, 2
    codes = rng.integers(0, B, size=(n, f)).astype(np.int32)
    labels = rng.integers(0, C, size=n).astype(np.int32)
    cont = (rng.integers(0, 8, size=(n, fc)) / 8.0).astype(np.float32)
    staged = pmesh.device_put_sharded_batch(m, codes, labels, cont)
    assert [b.shape for b in staged] == [(n, f), (n,), (n, fc)]
    g, cc, cnt, s1, s2 = collectives.sharded_scan_step(m, B, C)(*staged)
    tl = torch.from_numpy(labels)
    np.testing.assert_array_equal(
        g.numpy(), hist.cooc_counts(torch.from_numpy(codes), tl, B, C).numpy())
    np.testing.assert_array_equal(cc.numpy(), np.bincount(labels, minlength=C))
    for got, want in zip((cnt, s1, s2),
                         agg.class_moments(torch.from_numpy(cont), tl, C)):
        # a CPU tensor: .numpy() reads host memory and syncs nothing
        # graftlint: disable=GL005
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    g2 = collectives.sharded_cooc_step(m, B, C)(staged[0], staged[1])
    jg = jcoll.sharded_cooc_step(jmesh.make_mesh(("data",), shape=(8,)),
                                 B, C, interpret=True)(
        jnp.asarray(codes), jnp.asarray(labels))
    np.testing.assert_array_equal(g2.numpy(), np.asarray(jg))
    with pytest.raises(ValueError, match="not the mesh's 'data' devices"):
        collectives.sharded_cooc_step(m, B, C)(torch.from_numpy(codes), tl)


def _jax_quantized_reduce(x):
    """The JAX package's quantized reduce of ``x`` [8·R, W] over its eight
    host devices, one [R, W] block a device."""
    from jax.sharding import PartitionSpec as P

    m = jmesh.make_mesh(("data",), shape=(8,))
    fn = jcoll._shard_map_norep(
        lambda v: jcoll.quantized_allreduce_sum(v, "data"),
        m, P("data", None), P())
    return np.asarray(jax.jit(fn)(jnp.asarray(x)))


def test_quantized_allreduce_equals_jax(rng):
    """Bit-equal to the JAX package's where every partial cell is ≤ 127
    (the scale is 1) and where the partials pass it (the lossy regime);
    there each device's term is also within the JAX package's own bound of
    scale/2, scale = max|row| / 127 — the bound ``tests/test_shard.py``
    holds its collective to."""
    jax_reduce = _jax_quantized_reduce

    small = rng.integers(-127, 128, size=(64, 16)).astype(np.int32)
    parts = [torch.from_numpy(p) for p in small.reshape(8, 8, 16)]
    got = collectives.quantized_allreduce_sum(parts).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jax_reduce(small))
    np.testing.assert_array_equal(got, small.reshape(8, 8, 16).sum(0))

    big = rng.integers(0, 100_000, size=(64, 16)).astype(np.int32)
    parts = [torch.from_numpy(p) for p in big.reshape(8, 8, 16)]
    got = collectives.quantized_allreduce_sum(parts).numpy()
    exact = big.reshape(8, 8, 16).sum(0)
    np.testing.assert_array_equal(got, jax_reduce(big))
    bound = 8 * (big.max() / 127) / 2 + 1
    assert np.abs(got - exact).max() <= bound
    assert np.abs(jax_reduce(big) - exact).max() <= bound


@pytest.mark.parametrize("shape,seed", [((8, 32, 64), 0), ((8, 32, 64), 1),
                                        ((8, 384, 384), 2)])
def test_quantized_allreduce_lossy_equals_jax(shape, seed):
    """Random int32 partials in [0, 100000), far past 127: the port's
    float32 sum equals the JAX package's bit for bit (its scale is a
    multiply by float32(1/127) and each shard's q·s joins the sum with one
    rounding, the arithmetic XLA compiles), and so does the rounded gram
    ``sharded_scan_step`` keeps."""
    x = np.random.default_rng(seed).integers(
        0, 100_000, size=shape).astype(np.int32)
    got = collectives.quantized_allreduce_sum(
        [torch.from_numpy(p) for p in x]).numpy()
    want = _jax_quantized_reduce(x.reshape(-1, shape[-1]))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.round(got), np.round(want))
    assert np.abs(got - x.sum(0)).max() > 0          # the lossy regime


def test_quantized_shared_scan_past_127_equals_jax(tmp_path):
    """``shard.devices=8`` with ``shard.allreduce.quantized=true`` on a
    16,384-row chunk (2,048 rows a shard of a 5 × 6 × 2 schema, so many
    per-shard gram cells pass 127 and the int8 reduction rounds): NB, MI
    and Cramér part files equal the JAX package's under the same conf."""
    write_csv(str(tmp_path / "train.csv"), generate_churn(16384, seed=9))
    (tmp_path / "churn.json").write_text(json.dumps(CHURN_SCHEMA_JSON))
    quant = {"shard.devices": "8", "shard.allreduce.quantized": "true",
             "stream.chunk.rows": "16384"}
    got_c, got = _run_port(tmp_path, "port_q", **quant)
    _jc, want = _run_jax(tmp_path, "jax_q", **quant)
    _pc, exact = _run_port(tmp_path, "port_exact",
                           **{"stream.chunk.rows": "16384"})
    # NB's counts byte for byte; the statistics of MI and Cramér are
    # float32 from equal counts, within 2e-6 as everywhere (test_torch_jobs)
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        for lg, lw in zip(g.decode().splitlines(), w.decode().splitlines()):
            fg, fw = lg.split(","), lw.split(",")
            assert fg[:-1] == fw[:-1]
            if fg[-1] != fw[-1]:
                assert abs(float(fg[-1]) - float(fw[-1])) <= 2e-6, (lg, lw)
    assert got[1] != exact[1]          # the rounding showed in MI's tables
    assert got_c["nb"].get("Shard", "chunks") == 1


def test_quantized_scan_tables_past_127_equal_jax():
    """The same regime in one SharedScan a package: every table the
    quantized gram feeds (NB's bins, MI's pair tables, the against-class
    contingency) equals the JAX package's cell for cell."""
    n, f, b, c = 16384, 5, 6, 2
    rng = np.random.default_rng(21)
    kw = dict(cont=np.zeros((n, 0), np.float32),
              n_bins=np.full(f, b, np.int32), class_values=["a", "b"],
              binned_ordinals=list(range(f)), cont_ordinals=[])
    codes = rng.integers(0, b, size=(n, f)).astype(np.int32)
    labels = rng.integers(0, c, size=n).astype(np.int32)
    quant = {"shard.allreduce.quantized": "true"}
    eng = scan.SharedScan(device="cpu", shard=spec_for("8", **quant))
    jeng = jscan.SharedScan(shard=jspec_for("8", **quant))
    for e, m in ((eng, scan), (jeng, jscan)):
        e.register(m.NaiveBayesConsumer(name="nb"))
        e.register(m.MutualInfoConsumer(name="mi"))
        e.register(m.CorrelationConsumer(name="cramer", against_class=True))
    got = eng.run(EncodedDataset(codes=codes, labels=labels, ids=None, **kw))
    want = jeng.run(JDataset(codes=codes, labels=labels, ids=None, **kw))
    eq = np.testing.assert_array_equal
    eq(got["nb"].bin_counts, np.asarray(want["nb"].bin_counts))
    eq(got["mi"].pair_class_counts, np.asarray(want["mi"].pair_class_counts))
    eq(got["cramer"].contingency, np.asarray(want["cramer"].contingency))
    pairs = torch.from_numpy(got["mi"].pair_index).long()
    exact = agg.pair_class_counts_at(torch.from_numpy(codes),
                                     torch.from_numpy(labels), pairs, c,
                                     b).numpy()
    assert (got["mi"].pair_class_counts != exact).any()


# ---------------------------------------------------------------------------
# staging: pad targets, the ballast contract
# ---------------------------------------------------------------------------

def test_shard_pad_target_and_pad_rows_equal_jax():
    for d in (1, 3, 5, 8):
        targets = [pmesh.shard_pad_target(n, d) for n in range(1, 3000)]
        assert targets == [jmesh.shard_pad_target(n, d)
                           for n in range(1, 3000)]
        assert len(set(targets)) <= 13
        assert pmesh.padded_size(77, d) == jmesh.padded_size(77, d)
    with pytest.raises(ValueError, match="empty chunk"):
        pmesh.shard_pad_target(0, 8)
    codes = np.arange(6, dtype=np.int32).reshape(3, 2)
    cont = np.ones((3, 2), np.float32)
    for got, want in zip(pad_rows(5, codes, cont), jpad_rows(5, codes, cont)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    np.testing.assert_array_equal(pmesh.pad_batch(5, codes),
                                  jmesh.pad_batch(5, codes))
    assert pad_rows(3, codes) is codes


def test_ballast_never_leaks_into_counts(data):
    """Pad rows carry label −1: the padded batch and its staged blocks fold
    to the unpadded tables on every route, and ``valid_rows`` carries the
    true count through the pad and the staging."""
    ds = mk_ds(data)
    padded = pad_ballast(ds, N + 137)
    assert padded.num_rows == N + 137 and padded.valid_rows == N
    assert (padded.labels[N:] == -1).all() and (padded.codes[N:] == -1).all()
    staged = spec_for("8").stage(ds.slice(0, 100))
    assert staged.num_rows == 128 and staged.valid_rows == 100
    assert [p.shape[0] for p in staged.codes.parts] == [16] * 8
    assert spec_for("3").stage(ds.slice(0, 100)).num_rows == 129
    assert spec_for("8").stage(staged).codes is staged.codes

    def tables(fold_ds, shard=None):
        folder = scan.ChunkFolder(
            [scan.NaiveBayesConsumer(name="nb"),
             scan.MutualInfoConsumer(name="mi")], mk_ds(data), "cpu",
            shard=shard)
        acc = agg.Accumulator()
        folder.fold(fold_ds, acc)
        return folder.tables(acc, fold_ds.num_rows)

    for shard in (None, spec_for("8")):
        t0, t1 = tables(ds, shard), tables(padded, shard)
        for attr in ("class_counts", "fbc", "pcc"):
            np.testing.assert_array_equal(getattr(t1, attr),
                                          getattr(t0, attr))
        for k in range(3):
            np.testing.assert_array_equal(t1.moments[k], t0.moments[k])


# ---------------------------------------------------------------------------
# topology identity: the gram key, stale state, from_conf, the mesh
# ---------------------------------------------------------------------------

def test_g_key_equals_jax_and_stale_topology_refused(data):
    ds = mk_ds(data)
    cons = [scan.NaiveBayesConsumer(name="nb")]
    jcons = [jscan.NaiveBayesConsumer(name="nb")]
    jds = mk_ds(data, JDataset)
    for devices, axis in (("8", None), ("4", None), ("8", "shards")):
        extra = {"shard.data.axis": axis} if axis else {}
        got = scan.ChunkFolder(cons, ds, "cpu",
                               shard=spec_for(devices, **extra))
        want = jscan.ChunkFolder(jcons, jds, shard=jspec_for(devices, **extra))
        assert got.gk == want.gk and got.g_suffix == want.g_suffix
        assert got.program_tag == "shard"
    f8 = scan.ChunkFolder(cons, ds, "cpu", shard=spec_for("8"))
    f4 = scan.ChunkFolder(cons, ds, "cpu", shard=spec_for("4"))
    acc = agg.Accumulator()
    f8.fold(ds, acc)
    jf8 = jscan.ChunkFolder(jcons, jds, shard=jspec_for("8"))
    jf4 = jscan.ChunkFolder(jcons, jds, shard=jspec_for("4"))
    jacc = jagg.Accumulator()
    jf8.fold(jds, jacc)
    with pytest.raises(scan.ScanError) as got:
        f4.tables(acc, N)
    with pytest.raises(jscan.ScanError) as want:
        jf4.tables(jacc, N)
    assert str(got.value) == str(want.value)
    assert "mesh topology" in str(got.value)
    plain = scan.ChunkFolder(cons, ds, "cpu")
    with pytest.raises(scan.ScanError, match="stale"):
        plain.tables(acc, N)
    mixed = agg.Accumulator()
    f8.fold(ds, mixed)
    f4.fold(ds, mixed)
    with pytest.raises(scan.ScanError, match="mesh topology"):
        f8.tables(mixed, N)
    # same topology: the state's key family matches, and it resumes
    assert f8.state_matches_routing(acc.state())
    assert not f4.state_matches_routing(acc.state())
    assert not plain.state_matches_routing(acc.state())


@pytest.mark.parametrize("raw", ["0", "", "all", "8", "2", "eight", "-2",
                                 "9999"])
def test_from_conf_equals_jax(raw):
    conf = {"shard.devices": raw}
    try:
        want = JShardSpec.from_conf(JConfig(conf))
    except JConfigError as e:
        with pytest.raises(ConfigError) as got:
            ShardSpec.from_conf(JobConfig(conf), "cpu")
        assert str(got.value) == str(e)
        return
    got = ShardSpec.from_conf(JobConfig(conf), "cpu")
    if want is None:
        assert got is None
        return
    assert got.num_devices == want.num_devices
    assert got.g_suffix == want.g_suffix
    assert got.mesh.sizes == dict(want.mesh.shape)


def test_local_devices_follow_the_host_flag(monkeypatch):
    """The CPU's shard slots are ``XLA_FLAGS``' host device count, so one
    conf resolves alike in both packages; without the flag there is one,
    and a larger request is refused with the JAX package's message."""
    assert len(pmesh.local_devices("cpu")) == len(jax.devices()) == 8
    monkeypatch.setenv("XLA_FLAGS", "--xla_cpu_x=1 "
                       "--xla_force_host_platform_device_count=3")
    assert pmesh.host_slots() == 3
    monkeypatch.delenv("XLA_FLAGS")
    assert pmesh.local_devices("cpu") == [torch.device("cpu")]
    with pytest.raises(ConfigError) as got:
        ShardSpec.from_conf(JobConfig({"shard.devices": "2"}), "cpu")
    assert str(got.value) == \
        "shard.devices=2 but only 1 device(s) attached (cpu)"
    assert ShardSpec.from_conf(JobConfig({"shard.devices": "all"}),
                               "cpu").g_suffix == ":mesh:data1"


def test_make_mesh_shapes_equal_jax():
    for axes, shape in ((("data",), None), (("data", "model"), None),
                        (("data", "model", "x"), None), (("data",), (8,)),
                        (("a", "b"), (4, 2))):
        got = pmesh.make_mesh(axes, shape=shape, device="cpu")
        want = jmesh.make_mesh(axes, shape=shape)
        assert got.sizes == dict(want.shape)
    with pytest.raises(ValueError, match="!= device count"):
        pmesh.make_mesh(("data",), shape=(3,), device="cpu")
    m = pmesh.make_mesh(("data", "model"), device="cpu")
    assert m.axis_labels("data") == ["cpu:0", "cpu:2", "cpu:4", "cpu:6"]
    blocks = pmesh.device_put_sharded_batch(m, np.arange(10, dtype=np.int32))
    assert [p.tolist() for p in blocks.parts] == [
        [0, 1, 2], [3, 4, 5], [6, 7, 8], [9, -1, -1]]
    two_d = pmesh.device_put_sharded_batch(
        m, np.arange(12, dtype=np.int32).reshape(6, 2))[:, [1]]
    assert [p.tolist() for p in two_d.parts] == [[[1], [3]], [[5], [7]],
                                                 [[9], [11]], [[-1], [-1]]]
    assert pmesh.process_local_batch(m, np.zeros(8, np.int32)).shape == (8,)
    placed = pmesh.maybe_shard_batch(m, np.zeros(5, np.int32), None)
    assert isinstance(placed[0], pmesh.Blocks) and placed[1] is None
    again = pmesh.maybe_shard_batch(m, *placed)
    assert again[0] is placed[0] and again[1] is None
    one = pmesh.make_mesh(("data",), shape=(1,),
                          devices=[torch.device("cpu")])
    (t,) = pmesh.maybe_shard_batch(one, np.ones(3, np.int32))
    assert isinstance(t, torch.Tensor) and t.shape == (3,)
    with pytest.raises(ValueError, match="other devices"):
        pmesh.maybe_shard_batch(one, placed[0])


# ---------------------------------------------------------------------------
# windows, StreamAnalytics and their snapshots
# ---------------------------------------------------------------------------

def _encoder_and_lines(data, encoder_cls, schema_cls):
    codes, cont, labels = data
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
    enc = encoder_cls(schema_cls.from_json({"fields": fields}))
    lines = [",".join([f"r{i}"] + [str(int(v)) for v in codes[i]]
                      + [repr(float(x)) for x in cont[i]]
                      + [["a", "b"][int(labels[i])]])
             for i in range(1100)]
    return enc, lines


def test_sharded_windows_equal_unsharded_in_both_packages(data):
    """Windows inherit sharding through the ChunkFolder: in each package,
    sliding windows with a ragged tail pane equal the unsharded ones, with
    zero recompiles after warm(); across the packages the count tables are
    equal and MI within abs 2e-6 (the stream plane's bar, float32 MI)."""
    from avenir_tpu.core.encoding import DatasetEncoder as JEncoder
    from avenir_tpu.core.schema import FeatureSchema as JSchema
    from avenir_tpu.stream.windows import WindowedScan as JWindowedScan
    from avenir_tpu_torch.core.encoding import DatasetEncoder
    from avenir_tpu_torch.core.schema import FeatureSchema
    from avenir_tpu_torch.stream.windows import WindowedScan

    enc, lines = _encoder_and_lines(data, DatasetEncoder, FeatureSchema)
    jenc, _ = _encoder_and_lines(data, JEncoder, JSchema)

    def run(shard, jax_pkg=False):
        if jax_pkg:
            ws = JWindowedScan(jenc, [jscan.NaiveBayesConsumer(name="nb"),
                                      jscan.MutualInfoConsumer(name="mi")],
                               pane_rows=256, window_panes=3, slide_panes=1,
                               shard=shard)
        else:
            ws = WindowedScan(enc, [scan.NaiveBayesConsumer(name="nb"),
                                    scan.MutualInfoConsumer(name="mi")],
                              pane_rows=256, window_panes=3, slide_panes=1,
                              device="cpu", shard=shard)
        ws.warm()
        got = ws.feed(lines)
        got.extend(ws.flush())
        return ws, got

    def same(got, want):
        assert len(got) == len(want) == 3
        for a, b in zip(want, got):
            for attr in ("bin_counts", "cont_sum", "cont_sumsq"):
                np.testing.assert_array_equal(getattr(b.results["nb"], attr),
                                              getattr(a.results["nb"], attr))
            assert b.results["mi"].to_lines() == a.results["mi"].to_lines()

    _, plain = run(None)
    _, jplain = run(None, jax_pkg=True)
    for ws, sharded, want in ((*run(spec_for("8")), plain),
                              (*run(spec_for("3")), plain),
                              (*run(jspec_for("2"), jax_pkg=True), jplain)):
        same(sharded, want)
        assert (ws.counters.get("Stream", "recompiles") or 0) == 0
    assert ws.folder.g_suffix == ":mesh:data2"
    for a, b in zip(plain, jplain):
        np.testing.assert_array_equal(a.results["mi"].pair_class_counts,
                                      b.results["mi"].pair_class_counts)
        for la, lb in zip(a.results["mi"].to_lines(),
                          b.results["mi"].to_lines()):
            ha, _, va = la.rpartition(",")
            hb, _, vb = lb.rpartition(",")
            assert ha == hb and abs(float(va) - float(vb)) <= 2e-6


STREAM_BASE = {"stream.pane.rows": "128", "stream.window.panes": "2",
               "stream.consumers": "classDistribution,naiveBayes,cramer",
               "stream.drift.threshold": "0.02"}


def _stream(churn, out, jax_pkg=False, **extra):
    from avenir_tpu.jobs import get_job as jget_job
    from avenir_tpu_torch.jobs import get_job

    props = {"feature.schema.file.path": str(churn / "churn.json"),
             **STREAM_BASE, **extra}
    if jax_pkg:
        jget_job("StreamAnalytics").run(JConfig(props),
                                        str(churn / "train.csv"), str(out))
    else:
        get_job("StreamAnalytics").run(JobConfig(props),
                                       str(churn / "train.csv"), str(out),
                                       device="cpu")
    return (out / "part-00000").read_text()


@pytest.mark.parametrize("devices", ["2", "8"])
def test_stream_analytics_sharded_equals_unsharded_and_jax(churn, tmp_path,
                                                           devices):
    plain = _stream(churn, tmp_path / "plain")
    got = _stream(churn, tmp_path / "port", **{"shard.devices": devices})
    want = _stream(churn, tmp_path / "jax", jax_pkg=True,
                   **{"shard.devices": devices})
    assert got == want == plain
    assert got.count("w=") >= 8


def test_sharded_window_snapshot_resumes_under_its_topology(churn, tmp_path):
    """A pane snapshot written under ``shard.devices=2`` carries the mesh
    qualifier in its keys and its ``shard`` field; a resume under the same
    topology continues byte for byte, in the port and from a JAX-written
    snapshot; a resume under another topology is refused before any
    output."""
    from avenir_tpu_torch.utils.checkpoint import CheckpointManager
    from avenir_tpu_torch.utils.retry import InjectedFault

    full = _stream(churn, tmp_path / "full", **{"shard.devices": "2"})
    ck = tmp_path / "ck"
    durable = {"stream.checkpoint.dir": str(ck),
               "stream.checkpoint.interval.panes": "2",
               "shard.devices": "2"}
    with pytest.raises(InjectedFault):
        _stream(churn, tmp_path / "x", **durable,
                **{"fault.fold.crash.after": "5"})
    state = CheckpointManager(str(ck)).restore()
    assert state["shard"] == ":mesh:data2"
    assert any(k.endswith(":mesh:data2") for rec in state["ring"]
               for k in rec["state"])
    with pytest.raises(ConfigError,
                       match="set shard.reshard.on.restore=true") as refused:
        _stream(churn, tmp_path / "r4", **{**durable, "shard.devices": "4",
                                            "stream.resume": "true"})
    assert "':mesh:data2'" in str(refused.value)
    assert not (tmp_path / "r4").exists()
    assert not (tmp_path / "r4.inprogress").exists()
    tail = _stream(churn, tmp_path / "r2", **durable,
                   **{"stream.resume": "true"}).splitlines()
    lines = full.splitlines()
    first = next(i for i, ln in enumerate(lines)
                 if ln.startswith(tail[0].split(",")[0] + ","))
    assert tail == lines[first:]
    # the JAX package's snapshot under the same topology resumes here
    jck = tmp_path / "jck"
    jdurable = dict(durable, **{"stream.checkpoint.dir": str(jck)})
    with pytest.raises(Exception, match="injected"):
        _stream(churn, tmp_path / "jx", jax_pkg=True, **jdurable,
                **{"fault.fold.crash.after": "5"})
    jtail = _stream(churn, tmp_path / "jr", **jdurable,
                    **{"stream.resume": "true"}).splitlines()
    assert jtail == tail


# ---------------------------------------------------------------------------
# the skew probe
# ---------------------------------------------------------------------------

def _skew_ds(n=400, f=3, b=4, c=2, seed=1, cls=EncodedDataset):
    rng = np.random.default_rng(seed)
    return cls(codes=rng.integers(0, b, (n, f)).astype(np.int32),
               cont=np.zeros((n, 0), np.float32),
               labels=rng.integers(0, c, n).astype(np.int32),
               n_bins=np.full(f, b, np.int32), class_values=["a", "b"],
               binned_ordinals=list(range(f)), cont_ordinals=[])


def test_skew_probe_flags_the_injected_shard(tmp_path, capsys):
    """Under profile.on the probe times each shard, the fault-injected
    shard is flagged on every sampled chunk with the JAX package's event
    keys, the Shard counters follow, ``telemetry skew`` renders the table,
    and the tables stay the unsharded fold's."""
    from avenir_tpu_torch.telemetry.__main__ import main as tel_main

    ds = _skew_ds()

    def run(spec, counters=None):
        eng = scan.SharedScan(device="cpu", shard=spec, counters=counters)
        eng.register(scan.NaiveBayesConsumer(name="nb"))
        return eng.run(iter([ds.slice(0, 200), ds.slice(200, 400)]))

    base = run(None)
    tracer = tel.tracer().enable(str(tmp_path / "port"))
    prof_mod.profiler().enable()
    try:
        spec = spec_for("2", **{"shard.skew.sample": "1",
                                "shard.skew.threshold": "1.5",
                                "shard.skew.fault.device": "1",
                                "shard.skew.fault.ms": "60000"})
        counters = Counters()
        sharded = run(spec, counters)
        path = tracer.journal_path
    finally:
        tel.tracer().disable()
    np.testing.assert_array_equal(sharded["nb"].bin_counts,
                                  base["nb"].bin_counts)
    skews = [e for e in read_events(path) if e["ev"] == "shard.skew"]
    assert len(skews) == 2
    for e in skews:
        assert len(e["device_ms"]) == 2
        assert e["flagged"] and e["slowest"] == "cpu:1"
        assert e["device_ms"][1] >= 60000.0
    assert counters.get("Shard", "skew.flagged") == 2
    assert counters.get("Shard", "skew.pct") > 150
    assert tel_main(["skew", path]) == 0
    table = capsys.readouterr().out
    assert "◀ slowest" in table and "cpu:1" in table and "flagged: 2" in table
    # the emission itself, against the JAX package's on the same inputs
    events = {}
    for pkg, trc, pub, reader in (
            ("port", tel, publish_skew, read_events),
            ("jax", jtel, jpublish_skew, jread_events)):
        t = trc.tracer().enable(str(tmp_path / f"pub_{pkg}"))
        try:
            pub([10.0, 12.0], chunk=3, threshold=1.5,
                device_labels=["cpu:0", "cpu:1"], fault_device=1,
                fault_ms=100.0)
            p = t.journal_path
        finally:
            trc.tracer().disable()
        events[pkg] = [_bare(e) for e in reader(p)
                       if e["ev"] in ("shard.skew", "gauge")]
    assert events["port"] == events["jax"]


def test_skew_probe_never_runs_with_profiling_off(tmp_path):
    tracer = tel.tracer().enable(str(tmp_path))
    try:
        eng = scan.SharedScan(device="cpu", shard=spec_for("2"))
        eng.register(scan.NaiveBayesConsumer(name="nb"))
        eng.run(iter([_skew_ds(n=128, seed=2)]))
        path = tracer.journal_path
    finally:
        tel.tracer().disable()
    assert not any(e["ev"] == "shard.skew" for e in read_events(path))


# ---------------------------------------------------------------------------
# the process plane's keys, honoured: in one process the process axis has
# nothing to span and the gate nothing to move, as in the JAX package
# ---------------------------------------------------------------------------

PROCESS_KEYS = {
    "proc axis": {"shard.devices": "2", "shard.proc.axis": "proc"},
    "reshard": {"shard.reshard.on.restore": "true"},
    "stage proc": {"pipeline.stage.mi.prop.shard.proc.axis": "hosts"},
}


@pytest.mark.parametrize("case", sorted(PROCESS_KEYS))
def test_process_plane_keys_refused_before_output(churn, tmp_path, case):
    """Once refused before any output, the ``shard.proc.*`` and
    ``shard.reshard.*`` keys now run in one process with the part files
    of the same conf without them."""
    extra = PROCESS_KEYS[case]
    plain = {k: v for k, v in extra.items()
             if not k.split("prop.")[-1].startswith(("shard.proc.",
                                                     "shard.reshard."))}
    got, want = tmp_path / "ws", tmp_path / "ws_plain"
    driver.Pipeline.from_conf(JobConfig(_props(churn, **extra)),
                              workspace=str(got), device="cpu").run()
    driver.Pipeline.from_conf(JobConfig(_props(churn, **plain)),
                              workspace=str(want), device="cpu").run()
    assert _parts(got) == _parts(want)
    if case.startswith("stage"):
        return
    assert _stream(churn, tmp_path / "out", **extra) == \
        _stream(churn, tmp_path / "out_plain", **plain)


def test_too_many_devices_refused_before_any_stage(churn, tmp_path):
    ws = tmp_path / "ws"
    p = driver.Pipeline.from_conf(
        JobConfig(_props(churn, **{"shard.devices": "9"})),
        workspace=str(ws), device="cpu")
    with pytest.raises(ConfigError, match="only 8 device"):
        p.run()
    assert not ws.exists()
