"""In-process pipeline driver — port of ``avenir_tpu/pipeline/driver.py``
(the staged loop and the planner's route, with the tenancy arbiter's
``tenant.*`` contracts and the ``shard.*`` topology, on local devices or,
in a fleet, across processes).

The reference's multi-stage pipelines are shell scripts staging files
through HDFS (resource/knn.sh:16-137).  Here a :class:`Pipeline` is an
ordered list of named stages over an artifact workspace: each stage is a
job bound to input/output artifact names, consecutive count stages over
one artifact fuse into one SharedScan (``pipeline/scan.py``), and the
driver collects per-stage counters.  Every stage and the scan run on the
pipeline's device: ``cuda`` unless the caller asks for the CPU.
``plan.on=true`` runs the planned program instead (``pipeline/plan.py``:
non-adjacent fusion, share-gram, prune, encode-once, pack), with the same
output bytes.

Telemetry as in the JAX package: a ``pipeline.run`` root span, a span per
stage (``stage.<name>``) or fused group (``scan.fused``), each stage's
counter snapshot, ``stage.skipped`` on a resume, and with
``trace.xla.dir`` each executed stage or group under
``utils/profiling.trace`` into ``<trace.xla.dir>/<stage name>/``.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

from avenir_tpu_torch.core.config import ConfigError, JobConfig
from avenir_tpu_torch.utils.metrics import Counters

@dataclass
class Stage:
    """One pipeline step: a registered job name (or a callable with the
    signature ``(conf, in_path, out_path) -> Counters``), the artifact it
    reads, the artifact it writes, and per-stage property overrides."""

    name: str
    job: str | Callable[[JobConfig, str, str], Counters]
    input: str
    output: str
    props: Dict[str, str] = field(default_factory=dict)
    # artifacts this stage consumes via config paths (dependency edges only)
    uses: Sequence[str] = ()

    def run(self, conf: JobConfig, in_path: str, out_path: str,
            device=None) -> Counters:
        if not isinstance(self.job, str):
            return self.job(conf, in_path, out_path)
        from avenir_tpu_torch.jobs import get_job

        return get_job(self.job).run(conf, in_path, out_path, device=device)


class Pipeline:
    """Artifact-addressed stage runner.

    Artifacts are named paths in a workspace directory; ``bind`` points a
    name at an existing external path (the input dataset, a schema file).
    ``run`` executes stages in order, skipping any whose output artifact
    already exists when ``resume=True``."""

    def __init__(self, workspace: str, conf: JobConfig,
                 stages: Optional[List[Stage]] = None, device=None):
        self.workspace = workspace
        self.conf = conf
        self.device = device
        self.stages: List[Stage] = list(stages or [])
        self.bindings: Dict[str, str] = {}
        self.counters: Dict[str, Counters] = {}

    @classmethod
    def from_conf(cls, conf: JobConfig, workspace: Optional[str] = None,
                  device=None) -> "Pipeline":
        """The conf-declared pipeline:

        - ``pipeline.workspace`` — artifact directory (or pass it here);
        - ``pipeline.stages`` — stage names, comma-separated, in order;
        - ``pipeline.stage.<name>.job`` / ``.input`` / ``.output`` /
          ``.uses`` (comma list) / ``.prop.<key>`` (per-stage override,
          ``@artifact`` references resolve like :class:`Stage` props);
        - ``pipeline.bind.<artifact>`` — external path bindings."""
        names = conf.get_list("pipeline.stages")
        if not names:
            raise ConfigError(
                "pipeline.stages must list the stage names in execution "
                "order (see docs/jobs.md, 'Conf-declared pipelines')")
        ws = workspace or conf.get("pipeline.workspace") or "pipeline_ws"
        p = cls(ws, conf, device=device)
        bind_pref = "pipeline.bind."
        for key in sorted(conf.props):
            if key.startswith(bind_pref):
                p.bind(key[len(bind_pref):], conf.props[key])
        for name in names:
            pref = f"pipeline.stage.{name}."
            job = conf.get(pref + "job")
            inp = conf.get(pref + "input")
            out = conf.get(pref + "output")
            if not (job and inp and out):
                raise ConfigError(
                    f"stage {name!r} needs {pref}job, {pref}input and "
                    f"{pref}output")
            prop_pref = pref + "prop."
            props = {k[len(prop_pref):]: v for k, v in conf.props.items()
                     if k.startswith(prop_pref)}
            p.add(Stage(name, job, inp, out, props=props,
                        uses=tuple(conf.get_list(pref + "uses") or ())))
        return p

    def add(self, stage: Stage) -> "Pipeline":
        self.stages.append(stage)
        return self

    def bind(self, artifact: str, path: str) -> "Pipeline":
        self.bindings[artifact] = path
        return self

    def path(self, artifact: str) -> str:
        if artifact in self.bindings:
            return self.bindings[artifact]
        return os.path.join(self.workspace, artifact)

    def _deps(self, stage: Stage) -> List[str]:
        """Artifacts a stage consumes: its input, declared ``uses``, and any
        ``@artifact`` references in its property overrides."""
        deps = [stage.input] + list(stage.uses)
        deps += [v[1:] for v in stage.props.values()
                 if isinstance(v, str) and v.startswith("@")]
        return deps

    def _stage_conf(self, stage: Stage) -> JobConfig:
        conf = JobConfig(dict(self.conf.props), prefix=self.conf.prefix)
        for k, v in stage.props.items():
            # per-stage overrides may reference artifacts as @name
            if isinstance(v, str) and v.startswith("@"):
                v = self.path(v[1:])
            conf.set(k, v)
        return conf

    def _scan_group(self, todo: List[Stage], i: int, resume: bool):
        """Maximal run of consecutive stages starting at ``todo[i]`` that
        one SharedScan can serve: every stage a fusable count job over the
        same input artifact, none consuming another member's output, none
        already satisfied under ``resume``, all stage confs compatible.
        Returns ``(stages, confs, fuse)``."""
        from avenir_tpu_torch.pipeline import scan

        first = todo[i]
        in_path = self.path(first.input)
        group: List[Stage] = []
        confs: List[JobConfig] = []
        outputs: set = set()
        for s in todo[i:]:
            if self.path(s.input) != in_path:
                break
            if resume and os.path.exists(self.path(s.output)):
                break
            if any(a in outputs for a in self._deps(s)):
                break          # consumes an output of an earlier group member
            conf = self._stage_conf(s)
            if not scan.stage_fusable(s.job, conf):
                break
            group.append(s)
            confs.append(conf)
            outputs.add(s.output)
        # a singleton count stage still takes the SharedScan under a
        # shard.* topology: the sharded fold lives only there
        from avenir_tpu_torch.parallel.shard import ShardSpec

        if group and scan.stages_compatible(confs) and (
                len(group) > 1 or ShardSpec.requested(confs[0])):
            return group, confs, True
        return [first], confs[:1], False

    def rollup(self) -> Counters:
        """Run-level counter rollup: the SUM of every stage's counters."""
        total = Counters()
        for stage_counters in self.counters.values():
            total.merge_add(stage_counters)
        return total

    def run(self, only: Optional[Sequence[str]] = None,
            resume: bool = False) -> Dict[str, Counters]:
        if only is None:
            todo = list(self.stages)
        else:
            # transitive closure over artifact edges: a requested stage pulls
            # in the producers of every artifact it consumes
            producers = {s.output: s for s in self.stages}
            needed = {name: True for name in only}
            frontier = [s for s in self.stages if s.name in needed]
            while frontier:
                stage = frontier.pop()
                for art in self._deps(stage):
                    prod = producers.get(art)
                    if prod is not None and prod.name not in needed:
                        needed[prod.name] = True
                        frontier.append(prod)
            todo = [s for s in self.stages if s.name in needed]
        from avenir_tpu_torch.device import resolve_device
        from avenir_tpu_torch.parallel.shard import ShardSpec
        from avenir_tpu_torch.telemetry import profile as _profile
        from avenir_tpu_torch.telemetry import spans as tel

        from avenir_tpu_torch import tenancy

        self.device = resolve_device(self.device)
        # an impossible shard.* topology (more devices than are attached)
        # fails here, before any stage runs; the seams that fold sharded
        # journal shard.topology
        ShardSpec.from_conf(self.conf, self.device)
        # arm the device arbiter from tenant.* contracts (a no-op without
        # them; a malformed one raises before anything is written) and run
        # the whole pipeline as this conf's tenant: every stage's chunk
        # folds, fused or not, draw slots under it
        tenancy.configure(self.conf)
        tracer = tel.configure(self.conf)
        tenant = self.conf.get("tenant.id")
        run_attrs = {"workspace": self.workspace, "stages": len(todo),
                     "resume": bool(resume)}
        if tenant:
            run_attrs["tenant"] = tenant
        os.makedirs(self.workspace, exist_ok=True)
        with tel.label_scope(tenant=tenant), \
                tracer.span("pipeline.run", attrs=run_attrs):
            if self.conf.get_bool("plan.on", False):
                # the planned program: same output bytes as the staged
                # loop below, which stays the default
                from avenir_tpu_torch.pipeline import plan as plan_mod

                pl = plan_mod.plan_pipeline(self, todo, resume=resume)
                plan_mod.journal_plan(pl.summary(), tracer)
                plan_mod.run_plan(self, pl, tracer)
            else:
                self._run_stages(todo, resume, tracer)
            tracer.counters("pipeline", self.rollup())
        # fused-scan samples never pass through Job.run: flush here so the
        # journal's program totals are complete at the pipeline's end
        _profile.profiler().flush()
        return self.counters

    def _xla_trace(self, name: str, tracer):
        """The device trace of one executed stage or fused group: with
        ``trace.xla.dir`` set, ``utils/profiling.trace`` records it into
        ``<trace.xla.dir>/<stage name>/`` (a ``torch.profiler`` Chrome
        trace where the JAX package writes an XProf capture) and the path
        is journaled as ``xla.trace``, the JAX package's event.  Unset: a
        null context."""
        xla_dir = self.conf.get("trace.xla.dir")
        if not xla_dir:
            return contextlib.nullcontext()
        from avenir_tpu_torch.utils import profiling

        path = os.path.join(xla_dir, name)
        tracer.event("xla.trace", stage=name, dir=path)
        return profiling.trace(path, device=self.device)

    def _mark_skipped(self, stage: Stage, tracer) -> None:
        """A resume-satisfied stage still appears in the run report (and
        the journal), marked in place when it already has counters."""
        marked = self.counters.setdefault(stage.name, Counters())
        marked.set("Pipeline", "skipped", 1)
        tracer.event("stage.skipped", stage=stage.name,
                     output=self.path(stage.output))

    def _run_single(self, stage: Stage, conf: JobConfig, tracer) -> None:
        """One stage on its own job path: the staged loop's per-stage body,
        shared with the planner's staged units."""
        out = self.path(stage.output)
        attrs = {"job": (stage.job if isinstance(stage.job, str)
                         else getattr(stage.job, "__name__", "callable")),
                 "output": out}
        from avenir_tpu_torch.parallel.shard import ShardSpec

        if ShardSpec.requested(conf):
            # shard.* covers the SharedScan fold (fused count stages,
            # streaming); say whether this stage's path is sharded
            attrs["sharded"] = stage.job == "StreamAnalytics"
        with tracer.span(f"stage.{stage.name}", attrs=attrs), \
                self._xla_trace(stage.name, tracer):
            self.counters[stage.name] = stage.run(
                conf, self.path(stage.input), out, device=self.device)
            tracer.counters(stage.name, self.counters[stage.name])

    def _run_fused(self, group: List[Stage], gconfs: List[JobConfig],
                   tracer, extra_attrs: Optional[dict] = None,
                   **fused_kwargs) -> None:
        """A stage group through ONE SharedScan: the staged loop's fused
        branch, shared with the planner's scan units, which pass their
        span attrs and prune / pack / encode-cache decisions."""
        from avenir_tpu_torch.pipeline import scan

        attrs = {"stages": [s.name for s in group],
                 "input": self.path(group[0].input)}
        if extra_attrs:
            attrs.update(extra_attrs)
        with tracer.span("scan.fused", attrs=attrs) as sp, \
                self._xla_trace(group[0].name, tracer):
            fused = scan.run_fused_stages(
                [(s.name, s.job, self.path(s.input), self.path(s.output),
                  conf) for s, conf in zip(group, gconfs)],
                device=self.device, **fused_kwargs)
            self.counters.update(fused)
            first = fused[group[0].name]
            sp.set("chunks", first.get("SharedScan", "Chunks"))
            sp.set("rows", first.get("Records", "Processed"))
            for s in group:
                tracer.counters(s.name, fused[s.name])

    def _run_stages(self, todo: List[Stage], resume: bool, tracer) -> None:
        i = 0
        while i < len(todo):
            stage = todo[i]
            if resume and os.path.exists(self.path(stage.output)):
                self._mark_skipped(stage, tracer)
                i += 1
                continue
            # consecutive count jobs reading the same artifact with a
            # compatible schema collapse into ONE SharedScan
            # (scan.fuse=false opts a stage or the whole pipeline out)
            group, gconfs, fuse = self._scan_group(todo, i, resume)
            if fuse:
                self._run_fused(group, gconfs, tracer)
                i += len(group)
                continue
            self._run_single(stage, gconfs[0] if gconfs
                             else self._stage_conf(stage), tracer)
            i += 1


def knn_pipeline(workspace: str, conf: JobConfig, train_path: str,
                 test_path: str, class_cond: bool = False,
                 device=None) -> Pipeline:
    """resource/knn.sh as a pipeline: [bayesianDistr →] the kNN classifier
    (which fuses computeDistance / joinFeatureDistr / knnClassifier into
    one device pass)."""
    p = Pipeline(workspace, conf, device=device)
    p.bind("train", train_path)
    p.bind("test", test_path)
    if class_cond:
        p.add(Stage("bayesianDistr", "BayesianDistribution", "train", "bayes_model"))
        p.add(Stage("knnClassifier", "NearestNeighbor", "test", "predictions",
                    props={"training.data.path": "@train",
                           "class.condition.weighted": "true",
                           "bayesian.model.file.path": "@bayes_model"},
                    uses=("bayes_model",)))
    else:
        p.add(Stage("knnClassifier", "NearestNeighbor", "test", "predictions",
                    props={"training.data.path": "@train"}))
    return p


def decision_tree_pipeline(workspace: str, conf: JobConfig,
                           data_path: str, device=None) -> Pipeline:
    """The SplitGenerator/DataPartitioner runbook as one stage (the in-memory
    frontier loop) plus the root split artifact for inspection."""
    p = Pipeline(workspace, conf, device=device)
    p.bind("data", data_path)
    p.add(Stage("splitGenerator", "ClassPartitionGenerator", "data", "splits"))
    p.add(Stage("treeBuilder", "DecisionTreeBuilder", "data", "tree"))
    return p
