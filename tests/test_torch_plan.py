"""The port's planner held against ``avenir_tpu`` on the CPU.

Each case of the JAX package's ``tests/test_plan.py`` runs here on the
port: a planned run's part files are byte for byte the port's staged run
(the oracle) and the JAX package's planned run, for every rewrite.  Beside
each, the plan's structure equals ``avenir_tpu.pipeline.plan.
plan_pipeline``'s on the same conf: units, members, rewrites, ``keep``,
the staged-scan count, the encode-once key, the staged units' reasons and
the routing on the CPU.

Two things differ by design and are compared as such:
- the pack rewrite is decided by timing both candidates on each
  package's own programs, so "pack" and the chosen program are compared
  as a choice between the same two candidates (and exactly under
  ``scan.pack.on=false``);
- costs are the port's analytic counts, not XLA's, so only their
  presence is compared.

The JAX package's tests run on an 8-device virtual CPU mesh, where its
``Job.auto_mesh`` routes a unit "sharded"; the structural comparisons set
``data.parallel.auto=false`` on both sides, the single-device routing the
port has on one card.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from avenir_tpu.core.config import JobConfig as JConf  # noqa: E402
from avenir_tpu.core.csv_io import write_csv  # noqa: E402
from avenir_tpu.datagen.churn import CHURN_SCHEMA_JSON, generate_churn  # noqa: E402
from avenir_tpu.pipeline import plan as jplan  # noqa: E402
from avenir_tpu.pipeline.driver import Pipeline as JPipeline  # noqa: E402
from avenir_tpu.pipeline.driver import Stage as JStage  # noqa: E402
from avenir_tpu.utils.metrics import Counters as JCounters  # noqa: E402
from avenir_tpu_torch.core.config import JobConfig  # noqa: E402
from avenir_tpu_torch.pipeline import plan as plan_mod  # noqa: E402
from avenir_tpu_torch.pipeline.driver import Pipeline, Stage  # noqa: E402
from avenir_tpu_torch.pipeline.plan import SkipUnit, StageUnit  # noqa: E402
from avenir_tpu_torch.utils.metrics import Counters  # noqa: E402

COUNT_ARTS = ("nb_model", "mi_out", "cramer_out", "het_out")
PORT = (Pipeline, Stage, JobConfig, Counters)
JAX = (JPipeline, JStage, JConf, JCounters)
SINGLE = {"data.parallel.auto": "false"}


@pytest.fixture(scope="module")
def plan_env(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_plan")
    write_csv(str(root / "train.csv"), generate_churn(2000, seed=11))
    (root / "churn.json").write_text(json.dumps(CHURN_SCHEMA_JSON))
    props = {"feature.schema.file.path": str(root / "churn.json")}
    from avenir_tpu_torch.core.schema import FeatureSchema

    class_ord = FeatureSchema.from_json(CHURN_SCHEMA_JSON).class_field.ordinal
    return root, props, class_ord


def _marker_stage(S, C, name="marker", output="marker_out"):
    """A non-fusable callable stage: breaks the staged loop's adjacency
    without touching the shared input."""

    def marker(conf, in_path, out_path):
        os.makedirs(out_path, exist_ok=True)
        with open(os.path.join(out_path, "part-00000"), "w") as fh:
            fh.write("marker\n")
        return C()

    return S(name, marker, "data", output)


def _interleaved(pkg, root, ws, props, class_ord, extra=None, mutate=None):
    """NB | marker | MI | Cramér | het over ``train.csv`` in ``pkg``: the
    staged path pays two scans, the planner hoists past the marker."""
    P, S, C, K = pkg
    conf = C(dict(props))
    for k, v in (extra or {}).items():
        conf.set(k, v)
    p = (P(str(root / ws), conf, device="cpu") if pkg is PORT
         else P(str(root / ws), conf))
    p.add(S("bayesianDistr", "BayesianDistribution", "data", "nb_model"))
    p.add(_marker_stage(S, K))
    p.add(S("mutualInfo", "MutualInformation", "data", "mi_out"))
    p.add(S("cramer", "CramerCorrelation", "data", "cramer_out",
            props={"dest.attributes": str(class_ord)}))
    p.add(S("het", "HeterogeneityReductionCorrelation", "data", "het_out",
            props={"heterogeneity.algorithm": "uncertainty"}))
    if mutate:
        mutate(p, S)
    p.bind("data", str(root / "train.csv"))
    return p


@pytest.fixture(scope="module")
def staged_outputs(plan_env):
    """The port's unfused staged run: artifact → bytes."""
    root, props, class_ord = plan_env
    p = _interleaved(PORT, root, "ws_plain", props, class_ord,
                     extra={"scan.fuse": "false"})
    p.run()
    return {art: (root / "ws_plain" / art / "part-00000").read_bytes()
            for art in COUNT_ARTS + ("marker_out",)}


def _run_both(root, props, class_ord, ws, extra=None, mutate=None,
              resume=False):
    """The planned run in the port and in the JAX package; (port pipeline,
    port counters)."""
    extra = {"plan.on": "true", **(extra or {})}
    jp = _interleaved(JAX, root, ws + "_jax", props, class_ord, extra, mutate)
    jp.run(resume=resume)
    p = _interleaved(PORT, root, ws, props, class_ord, extra, mutate)
    return p, p.run(resume=resume)


def _assert_bytes(root, ws, staged, arts=None, jax=True):
    for art in (arts or staged):
        got = (root / ws / art / "part-00000").read_bytes()
        assert got == staged[art], f"planned {art} differs from staged"
        if jax and art in COUNT_ARTS:
            jax_ = (root / (ws + "_jax") / art / "part-00000").read_bytes()
            assert got == jax_, f"planned {art} differs from the JAX package"


def _structure(plan, exact_program=False):
    """A plan's structure as comparable tuples, "pack" set aside."""
    out = []
    for u in plan.units:
        if isinstance(u, SkipUnit) or type(u).__name__ == "SkipUnit":
            out.append(("skip", u.stage.name))
        elif isinstance(u, StageUnit) or type(u).__name__ == "StageUnit":
            out.append(("stage", u.stage.name, u.reason))
        else:
            out.append(("scan", tuple(s.name for s in u.stages), u.input,
                        tuple(r for r in u.rewrites if r != "pack"),
                        None if u.keep is None else tuple(u.keep),
                        u.pruned_from, u.staged_scans,
                        u.program if exact_program else None,
                        u.cost is not None, u.cost_rows))
    return out


def _programs(plan):
    return [u.program for u in plan.units if type(u).__name__ == "ScanUnit"]


def _assert_same_plan(p_port, p_jax, resume=False):
    """Equal structure; each scan unit's program is one of the two
    candidates both packages name alike."""
    pl = plan_mod.plan_pipeline(p_port, resume=resume)
    jpl = jplan.plan_pipeline(p_jax, resume=resume)
    assert _structure(pl) == _structure(jpl)
    for u, ju in zip(pl.scan_units, jpl.scan_units):
        progs = {u.program, ju.program}
        packed = {q for q in progs if q.startswith("packed:")}
        assert len(progs) == 1 or progs == {"einsum"} | packed, progs
        assert ("pack" in u.rewrites) == (u.pack_on is True)
    return pl, jpl


# ---------------------------------------------------------------------------
# fuse
# ---------------------------------------------------------------------------

def test_plan_fuses_nonadjacent_byte_identical(plan_env, staged_outputs):
    root, props, class_ord = plan_env
    p, counters = _run_both(root, props, class_ord, "ws_planned")
    _assert_bytes(root, "ws_planned", staged_outputs)
    for name in ("bayesianDistr", "mutualInfo", "cramer", "het"):
        assert counters[name].get("SharedScan", "FusedStages") == 4
        assert counters[name].get("SharedScan", "Scans") == 1
        assert counters[name].get("Records", "Processed") == 2000
    pl = plan_mod.plan_pipeline(p)
    scans = pl.scan_units
    assert len(scans) == 1 and len(scans[0].stages) == 4
    assert "fuse" in scans[0].rewrites and scans[0].staged_scans == 2
    falls = [u for u in pl.units if isinstance(u, StageUnit)]
    assert [u.stage.name for u in falls] == ["marker"]
    assert falls[0].reason == "not a fusable count job"
    _assert_same_plan(
        _interleaved(PORT, root, "s1", props, class_ord, SINGLE),
        _interleaved(JAX, root, "s1j", props, class_ord, SINGLE))


def test_plan_streaming_ragged_chunks_byte_identical(plan_env,
                                                     staged_outputs):
    root, props, class_ord = plan_env
    p, counters = _run_both(root, props, class_ord, "ws_planned_stream",
                            extra={"stream.chunk.rows": "700"})
    _assert_bytes(root, "ws_planned_stream", staged_outputs)
    assert counters["mutualInfo"].get("SharedScan", "Chunks") == 3
    extra = {**SINGLE, "stream.chunk.rows": "700"}
    _assert_same_plan(
        _interleaved(PORT, root, "s2", props, class_ord, extra),
        _interleaved(JAX, root, "s2j", props, class_ord, extra))


def test_plan_kernel_routing_byte_identical(plan_env, staged_outputs,
                                            monkeypatch):
    """The kernel route's plumbing on the CPU: with ``hist.use_kernel``
    forced true the planned unit is one "kernel" program (the analytic
    B1 cost, no pack question) whose wrappers run their plain versions on
    CPU tensors, and the bytes are the staged run's.  The card runs the
    real kernels (tests/test_torch_cuda.py) on one device, where there is
    no data mesh."""
    from avenir_tpu_torch.ops import hist

    root, props, class_ord = plan_env
    monkeypatch.setattr(hist, "use_kernel", lambda *a: True)
    p = _interleaved(PORT, root, "ws_planned_kernel", props, class_ord,
                     {"plan.on": "true", "stream.chunk.rows": "700",
                      **SINGLE})
    pl = plan_mod.plan_pipeline(p)
    unit = pl.scan_units[0]
    assert unit.program == "kernel" and unit.pack_source == "aot"
    assert unit.pack_on is None and "pack" not in unit.rewrites
    g_cells, used = hist.gram_cells(5, 6, 2)
    assert unit.cost["output_bytes"] == 4 * g_cells
    assert unit.cost["flops"] >= used * (used + 1) * unit.cost_rows
    p.run()
    for art in COUNT_ARTS:
        got = (root / "ws_planned_kernel" / art / "part-00000").read_bytes()
        assert got == staged_outputs[art]


# ---------------------------------------------------------------------------
# share-gram and value dependencies
# ---------------------------------------------------------------------------

def _add_uses(p, S):
    p.stages[4] = S("het", "HeterogeneityReductionCorrelation", "data",
                    "het_out",
                    props={"heterogeneity.algorithm": "uncertainty"},
                    uses=("nb_model",))


def test_plan_share_gram_uses_edge(plan_env, staged_outputs):
    root, props, class_ord = plan_env
    p, _ = _run_both(root, props, class_ord, "ws_planned_uses",
                     mutate=_add_uses)
    _assert_bytes(root, "ws_planned_uses", staged_outputs)
    unit = plan_mod.plan_pipeline(p).scan_units[0]
    assert "share-gram" in unit.rewrites
    assert [s.name for s in unit.stages] == ["bayesianDistr", "mutualInfo",
                                             "cramer", "het"]
    _assert_same_plan(
        _interleaved(PORT, root, "s4", props, class_ord, SINGLE, _add_uses),
        _interleaved(JAX, root, "s4j", props, class_ord, SINGLE, _add_uses))


def test_plan_value_dependency_refuses_hoist(plan_env):
    root, props, class_ord = plan_env

    def valdep(p, S):
        p.stages[4] = S("het", "HeterogeneityReductionCorrelation", "data",
                        "het_out",
                        props={"heterogeneity.algorithm": "uncertainty",
                               "some.model.path": "@nb_model"})

    p = _interleaved(PORT, root, "ws_valdep", props, class_ord, SINGLE,
                     valdep)
    unit = plan_mod.plan_pipeline(p).scan_units[0]
    assert "het" not in [s.name for s in unit.stages]
    _assert_same_plan(p, _interleaved(JAX, root, "s5j", props, class_ord,
                                      SINGLE, valdep))


# ---------------------------------------------------------------------------
# prune
# ---------------------------------------------------------------------------

def _corr_pipeline(pkg, root, ws, props, class_ord, extra):
    P, S, C, _K = pkg
    conf = C({**props, **extra})
    p = (P(str(root / ws), conf, device="cpu") if pkg is PORT
         else P(str(root / ws), conf))
    p.add(S("cramer", "CramerCorrelation", "data", "cramer_out",
            props={"source.attributes": "1,2",
                   "dest.attributes": str(class_ord)}))
    p.add(S("het", "HeterogeneityReductionCorrelation", "data", "het_out",
            props={"heterogeneity.algorithm": "uncertainty",
                   "source.attributes": "1", "dest.attributes": "2"}))
    p.bind("data", str(root / "train.csv"))
    return p


def test_plan_prune_correlation_only_byte_identical(plan_env):
    root, props, class_ord = plan_env
    _corr_pipeline(PORT, root, "ws_corr_plain", props, class_ord,
                   {"scan.fuse": "false"}).run()
    p = _corr_pipeline(PORT, root, "ws_corr_planned", props, class_ord,
                       {"plan.on": "true"})
    unit = plan_mod.plan_pipeline(p).scan_units[0]
    assert "prune" in unit.rewrites
    assert unit.keep is not None and len(unit.keep) < unit.pruned_from
    counters = p.run()
    _corr_pipeline(JAX, root, "ws_corr_jax", props, class_ord,
                   {"plan.on": "true"}).run()
    for art in ("cramer_out", "het_out"):
        a = (root / "ws_corr_plain" / art / "part-00000").read_bytes()
        b = (root / "ws_corr_planned" / art / "part-00000").read_bytes()
        c = (root / "ws_corr_jax" / art / "part-00000").read_bytes()
        assert a == b == c, f"pruned {art} differs"
    pruned = counters["cramer"].get("SharedScan", "PrunedCols")
    assert pruned == unit.pruned_from - len(unit.keep) > 0
    _assert_same_plan(
        _corr_pipeline(PORT, root, "s6", props, class_ord, SINGLE),
        _corr_pipeline(JAX, root, "s6j", props, class_ord, SINGLE))


# ---------------------------------------------------------------------------
# encode-once
# ---------------------------------------------------------------------------

def _encode_once_pipeline(pkg, root, ws, props, class_ord, extra):
    P, S, C, _K = pkg
    conf = C({**props, **extra})
    p = (P(str(root / ws), conf, device="cpu") if pkg is PORT
         else P(str(root / ws), conf))
    p.add(S("bayesianDistr", "BayesianDistribution", "data", "nb_model"))
    p.add(S("mutualInfo", "MutualInformation", "data", "mi_out"))
    p.add(S("cramer", "CramerCorrelation", "data", "cramer_out",
            props={"dest.attributes": str(class_ord),
                   "scan.pack.on": "false"}))
    p.add(S("het", "HeterogeneityReductionCorrelation", "data", "het_out",
            props={"heterogeneity.algorithm": "uncertainty",
                   "scan.pack.on": "false"}))
    p.bind("data", str(root / "train.csv"))
    return p


def test_plan_encode_once_across_units(plan_env, staged_outputs):
    """Two scan units over one input (split by a compat-breaking
    ``scan.pack.on`` override) share one parse and encode."""
    root, props, class_ord = plan_env
    p = _encode_once_pipeline(PORT, root, "ws_encode_once", props, class_ord,
                              {"plan.on": "true"})
    scans = plan_mod.plan_pipeline(p).scan_units
    assert len(scans) == 2
    assert "encode-once" not in scans[0].rewrites
    assert "encode-once" in scans[1].rewrites
    p.run()
    _encode_once_pipeline(JAX, root, "ws_encode_once_jax", props, class_ord,
                          {"plan.on": "true"}).run()
    _assert_bytes(root, "ws_encode_once", staged_outputs, arts=COUNT_ARTS)
    _assert_same_plan(
        _encode_once_pipeline(PORT, root, "s7", props, class_ord, SINGLE),
        _encode_once_pipeline(JAX, root, "s7j", props, class_ord, SINGLE))


def test_encode_cache_is_unused_with_chunked_streams(plan_env):
    """The encode cache serves only whole-input reads: with
    ``stream.chunk.rows`` no unit is marked encode-once and nothing is
    cached."""
    from avenir_tpu_torch.pipeline import scan

    root, props, class_ord = plan_env
    p = _encode_once_pipeline(PORT, root, "ws_enc_stream", props, class_ord,
                              {"plan.on": "true",
                               "stream.chunk.rows": "700"})
    assert not any("encode-once" in u.rewrites
                   for u in plan_mod.plan_pipeline(p).scan_units)
    cache = {}
    stage = p.stages[0]
    scan.run_fused_stages(
        [(stage.name, stage.job, p.path("data"),
          str(root / "ws_enc_stream" / "nb_model"),
          p._stage_conf(stage))], device="cpu", encode_cache=cache)
    assert cache == {}


# ---------------------------------------------------------------------------
# pack at plan time
# ---------------------------------------------------------------------------

def test_plan_pack_selection_measured(plan_env):
    """Both candidates dispatch on the CPU: the planner times one of each
    over the sample (source "measured", an explicit ``pack_on``), carries
    the chosen program's analytic cost, and the JAX package's planner
    chose between the same two candidates."""
    root, props, class_ord = plan_env
    p = _interleaved(PORT, root, "ws_pack_probe", props, class_ord,
                     {"plan.on": "true", **SINGLE})
    pl, jpl = _assert_same_plan(
        p, _interleaved(JAX, root, "ws_pack_probe_jax", props, class_ord,
                        {"plan.on": "true", **SINGLE}))
    unit = pl.scan_units[0]
    assert unit.pack_source == jpl.scan_units[0].pack_source == "measured"
    assert unit.pack_on in (True, False)
    assert unit.cost is not None and unit.cost.get("flops", 0) > 0
    assert unit.cost_rows == 2000
    assert unit.wall_ms is not None and unit.wall_ms > 0
    summary = pl.summary()
    assert summary["source"] == "measured"
    assert summary["est_flops"] and summary["est_bytes"]


def test_plan_pack_opt_out_conf_wins(plan_env, staged_outputs):
    root, props, class_ord = plan_env
    p, _ = _run_both(root, props, class_ord, "ws_pack_off",
                     extra={"scan.pack.on": "false"})
    _assert_bytes(root, "ws_pack_off", staged_outputs)
    pl = plan_mod.plan_pipeline(p)
    assert "pack" not in pl.scan_units[0].rewrites
    extra = {**SINGLE, "scan.pack.on": "false"}
    port = plan_mod.plan_pipeline(
        _interleaved(PORT, root, "s9", props, class_ord, extra))
    jax_ = jplan.plan_pipeline(
        _interleaved(JAX, root, "s9j", props, class_ord, extra))
    assert _structure(port, True) == _structure(jax_, True)
    assert _programs(port) == ["einsum"]


# ---------------------------------------------------------------------------
# singleton and fallbacks
# ---------------------------------------------------------------------------

def test_plan_singleton_stays_staged(plan_env):
    root, props, _c = plan_env
    plans = []
    for pkg in (PORT, JAX):
        P, S, C, _K = pkg
        p = (P(str(root / "ws_single"), C(dict(props)), device="cpu")
             if pkg is PORT else P(str(root / "ws_single_j"), C(dict(props))))
        p.add(S("bayesianDistr", "BayesianDistribution", "data", "nb_model"))
        p.bind("data", str(root / "train.csv"))
        plans.append((plan_mod if pkg is PORT else jplan).plan_pipeline(p))
    assert len(plans[0].units) == 1 and isinstance(plans[0].units[0],
                                                   StageUnit)
    assert "singleton" in plans[0].units[0].reason
    assert _structure(plans[0]) == _structure(plans[1])


def _fallbacks(tmp):
    def mutate(p, S):
        p.stages[2].props["stream.checkpoint.dir"] = str(tmp / "ckpt")
        p.stages[0].props["tabular.input"] = "false"
    return mutate


def test_plan_fallback_drills(plan_env, tmp_path):
    """Checkpointed streams and text-mode NB stay staged with the JAX
    package's reasons; the rest still fuses.  (The JAX package's third
    drill, a multi-process runtime without a ``shard.*`` topology, has no
    counterpart: the port runs one process, ROADMAP.md, Queue 1 item 7h.)"""
    root, props, class_ord = plan_env
    mutate = _fallbacks(tmp_path)
    p = _interleaved(PORT, root, "ws_fallback", props, class_ord, SINGLE,
                     mutate)
    pl, _jpl = _assert_same_plan(
        p, _interleaved(JAX, root, "ws_fallback_j", props, class_ord, SINGLE,
                        mutate))
    reasons = {u.stage.name: u.reason for u in pl.units
               if isinstance(u, StageUnit)}
    assert reasons["mutualInfo"] == \
        "checkpointed stream (stream.checkpoint.dir)"
    assert reasons["bayesianDistr"] == "text-mode NB (tabular.input=false)"
    assert [s.name for s in pl.scan_units[0].stages] == ["cramer", "het"]


def test_plan_fallback_runs_byte_identical(plan_env, staged_outputs,
                                           tmp_path):
    root, props, class_ord = plan_env

    def add_ckpt(p, S):
        p.stages[2].props["stream.checkpoint.dir"] = str(
            tmp_path / ("ckpt_jax" if isinstance(p, JPipeline)
                        else "ckpt_port"))

    _run_both(root, props, class_ord, "ws_fallback_run", mutate=add_ckpt,
              extra={"stream.chunk.rows": "700"})
    _assert_bytes(root, "ws_fallback_run", staged_outputs)


# ---------------------------------------------------------------------------
# resume
# ---------------------------------------------------------------------------

def test_plan_resume_skips_satisfied_stages(plan_env, staged_outputs,
                                            tmp_path):
    from avenir_tpu_torch.telemetry import schema
    from avenir_tpu_torch.telemetry import spans as tel
    from avenir_tpu_torch.telemetry.journal import read_events

    root, props, class_ord = plan_env
    ws = "ws_resume"
    extra = {"plan.on": "true", "trace.on": "true",
             "trace.journal.dir": str(tmp_path / "tel")}
    p = _interleaved(PORT, root, ws, props, class_ord, extra)
    for art, payload in (("nb_model", staged_outputs["nb_model"]),
                         ("marker_out", b"marker\n")):
        os.makedirs(root / ws / art, exist_ok=True)
        (root / ws / art / "part-00000").write_bytes(payload)
    nb_before = (root / ws / "nb_model" / "part-00000").stat().st_mtime_ns
    prior = Counters()
    prior.set("Records", "Processed", 1234)
    p.counters["bayesianDistr"] = prior
    pl = plan_mod.plan_pipeline(p, resume=True)
    assert {u.stage.name for u in pl.units
            if isinstance(u, SkipUnit)} == {"bayesianDistr", "marker"}
    assert [s.name for s in pl.scan_units[0].stages] == [
        "mutualInfo", "cramer", "het"]
    try:
        counters = p.run(resume=True)
        path = tel.tracer().journal_path
    finally:
        tel.tracer().disable()
    _assert_bytes(root, ws, staged_outputs, jax=False)
    assert (root / ws / "nb_model" / "part-00000").stat().st_mtime_ns \
        == nb_before
    assert counters["bayesianDistr"].get("Pipeline", "skipped") == 1
    assert counters["bayesianDistr"].get("Records", "Processed") == 1234
    events = read_events(path)
    assert {e["stage"] for e in events if e["ev"] == "stage.skipped"} == {
        "bayesianDistr", "marker"}
    compiled = [e for e in events if e["ev"] == "plan.compiled"]
    assert len(compiled) == 1 and compiled[0]["units"] == 3
    assert frozenset(set(compiled[0]) - schema.STAMP_KEYS) in \
        schema.event_shapes("plan.compiled")
    fused = [e for e in events if e.get("ev") == "span.close"
             and e.get("name") == "scan.fused"]
    assert fused and fused[0]["attrs"]["planned"] is True


# ---------------------------------------------------------------------------
# explain, the CLI verb, the journal summary
# ---------------------------------------------------------------------------

def test_plan_explain_prints_tree_and_costs(plan_env):
    root, props, class_ord = plan_env
    p = _interleaved(PORT, root, "ws_explain", props, class_ord, SINGLE)
    text = plan_mod.plan_pipeline(p).explain()
    assert "PlanGraft: 5 stage(s) -> 2 unit(s)" in text
    assert "rewrites: fuse" in text and "staged path ~ 2 scans" in text
    assert "MFLOP" in text and "sample chunk" in text
    for name in ("bayesianDistr", "mutualInfo", "cramer", "het"):
        assert name in text
    assert "marker" in text and "not a fusable count job" in text
    jtext = jplan.plan_pipeline(_interleaved(
        JAX, root, "ws_explain_j", props, class_ord, SINGLE)).explain()
    # every line but the program/cost line and the pack rewrite is the
    # JAX package's
    strip = [ln.replace(", pack", "") for ln in text.splitlines()
             if "program:" not in ln]
    jstrip = [ln.replace(", pack", "") for ln in jtext.splitlines()
              if "program:" not in ln]
    assert strip == jstrip


def test_plan_verb_prints_explain(plan_env, capsys):
    from avenir_tpu_torch.pipeline.__main__ import main

    root, props, class_ord = plan_env
    conf = root / "plan.properties"
    lines = {**props, "pipeline.stages": "nb,mi,cramer",
             "pipeline.bind.train": str(root / "train.csv"),
             "pipeline.workspace": str(root / "ws_verb"),
             "pipeline.stage.nb.job": "BayesianDistribution",
             "pipeline.stage.mi.job": "MutualInformation",
             "pipeline.stage.cramer.job": "CramerCorrelation",
             "pipeline.stage.cramer.prop.dest.attributes": str(class_ord)}
    for s, out in (("nb", "nb_model"), ("mi", "mi_out"),
                   ("cramer", "cramer_out")):
        lines[f"pipeline.stage.{s}.input"] = "train"
        lines[f"pipeline.stage.{s}.output"] = out
    conf.write_text("".join(f"{k}={v}\n" for k, v in lines.items()))
    for verb in (["plan"], ["plan", "explain"]):
        assert main(verb + [str(conf), "--device", "cpu"]) == 0
        out = capsys.readouterr().out
        assert out.startswith("PlanGraft: 3 stage(s) -> 1 unit(s)")
        assert "rewrites: fuse" in out
    assert not (root / "ws_verb").exists()      # plan runs no stage
    assert main(["run", str(conf), "-Dplan.on=true", "--device", "cpu"]) == 0
    assert "FusedStages=3" in capsys.readouterr().out


def test_plan_refuses_shard_keys_before_output(plan_env, staged_outputs):
    """The process plane's shard.* keys, refused before the planner ran
    until the process plane landed, now plan and run: in one process the
    process axis spans nothing, and the planned run under
    ``shard.devices=2`` writes the staged run's bytes, as the JAX
    package's planned run under the same keys does."""
    root, props, class_ord = plan_env
    _p, _counters = _run_both(root, props, class_ord, "ws_shard",
                              {"shard.devices": "2",
                               "shard.proc.axis": "proc",
                               "shard.reshard.on.restore": "true"})
    _assert_bytes(root, "ws_shard", staged_outputs)


def test_plan_sentinel_rows_and_baseline_band():
    """The bench's nested "planned" block surfaces as ``planned.*`` rows
    through the port's sentinel as through the JAX package's."""
    from avenir_tpu.telemetry import sentinel as jsentinel
    from avenir_tpu_torch.telemetry import sentinel

    line = {
        "metric": "e2e_csv_nb_mi_pipeline", "value": 1.0e5,
        "unit": "rows/sec/chip", "value_canary_clean": 1.0e5,
        "planned": {
            "plan_speedup": {"value": 2.4, "unit": "x"},
            "staged_scan_seconds": {"value": 1.9, "unit": "seconds"},
            "planned_scan_seconds": {"value": 0.8, "unit": "seconds"},
            "byte_identical": True,
            "rewrites": ["fuse", "pack"],
        },
    }
    m = sentinel.extract_metrics(line)
    assert m == jsentinel.extract_metrics(line)
    assert m["planned.plan_speedup"]["value"] == 2.4
    assert "planned.byte_identical" not in m
    baseline = json.load(open(os.path.join(os.path.dirname(__file__), "..",
                                           "BASELINE.json")))
    slow = {**line, "planned": {**line["planned"],
                                "plan_speedup": {"value": 0.9, "unit": "x"}}}
    got = sentinel.evaluate(slow, baseline)
    assert "planned.plan_speedup" in got["regressed"]
    assert got["regressed"] == jsentinel.evaluate(slow, baseline)["regressed"]


def test_plan_summary_schema_matches_journal_event(plan_env):
    from avenir_tpu_torch.telemetry import schema

    root, props, class_ord = plan_env
    summary = plan_mod.plan_pipeline(_interleaved(
        PORT, root, "ws_summary", props, class_ord)).summary()
    assert set(summary) == {"units", "stages", "fused", "rewrites",
                            "source", "est_flops", "est_bytes"}
    assert set(summary) | {"ev", "ts", "trace", "span"} == \
        schema.GOLDEN_EVENT_KEYS["plan.compiled"]
    assert summary["stages"] == 5 and summary["fused"] == 4
    jsummary = jplan.plan_pipeline(_interleaved(
        JAX, root, "ws_summary_j", props, class_ord, SINGLE)).summary()
    for key in ("units", "stages", "fused"):
        assert summary[key] == jsummary[key]


def test_analytic_costs_count_the_sample(plan_env):
    """The einsum and packed families' analytic counts scale with the
    sample's rows and name the tables each writes."""
    from avenir_tpu_torch.core.encoding import DatasetEncoder
    from avenir_tpu_torch.core.schema import FeatureSchema
    from avenir_tpu_torch.pipeline import scan

    enc = DatasetEncoder(FeatureSchema.from_json(CHURN_SCHEMA_JSON))
    rows = np.asarray(generate_churn(400, seed=5), dtype=object)
    ds = enc.fit_transform(rows)
    cons = [scan.MutualInfoConsumer(name="mi"),
            scan.NaiveBayesConsumer(name="nb")]
    e = scan.ChunkFolder(cons, ds, "cpu", pack_on=False)
    pk = scan.ChunkFolder(cons, ds, "cpu", pack_on=True)
    assert e.step == "einsum" and pk.step == "packed"
    half = ds.slice(0, 200)
    for fn, folder in ((plan_mod._einsum_cost, e),
                       (plan_mod._packed_cost, pk)):
        full, part = fn(folder, ds), fn(folder, half)
        assert full["flops"] > part["flops"] > 0
        assert full["output_bytes"] == part["output_bytes"]
    f, b, c = e.f, e.b, e.c
    p = len(e.pair_index)
    assert plan_mod._einsum_cost(e, ds)["output_bytes"] == \
        8 * c + 8 * f * b * c + 8 * p * b * b * c
