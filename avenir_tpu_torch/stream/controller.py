"""Drift→retrain→hot-swap — closing the train→deploy loop online; port of
``avenir_tpu/stream/controller.py``.

The reference closes this loop only for Storm RL (the learner updates in
the bolt); every supervised model retrains offline and redeploys by hand.
:class:`DriftRetrainController` automates the supervised case end to end:

1. every completed window flows through the :class:`~avenir_tpu_torch.stream.drift.DriftDetector`;
2. on SUSTAINED drift, the controller writes the window's retained rows to
   a per-event workspace under ``stream.retrain.dir`` and runs the model's
   OWN batch fit job over them (the same job a pipeline stage runs — not a
   shadow trainer, so the retrained artifact is byte-compatible with every
   offline tool);
3. the fresh artifact is loaded through the family's servable loader and
   hot-swapped into the live scoring plane via the batcher's swap barrier
   (:meth:`~avenir_tpu_torch.serving.batcher.BucketedMicrobatcher.swap`):
   the incoming entry's bucket shapes compile BEFORE publish, in-flight
   requests finish on the old params, and the registry version bumps.

The fit and the servable's load run on the live entry's device (``cuda``
unless the served model was loaded on the CPU): a tree retrain on ``cuda``
launches B4 once per level.  Drift-to-swap latency is measured per event
(``last_swap_s``).
"""

from __future__ import annotations

import os
import time
from typing import Optional

from avenir_tpu_torch.core.config import ConfigError, JobConfig
from avenir_tpu_torch.stream.drift import DriftDetector, DriftEvent
from avenir_tpu_torch.stream.windows import WindowResult
from avenir_tpu_torch.telemetry import spans as tel
from avenir_tpu_torch.utils.metrics import Counters

# family → (batch fit job, the artifact key its servable loader reads) —
# the SAME job/key contract the serving registry documents, so a retrain
# artifact is indistinguishable from a pipeline stage's output
RETRAIN_JOBS = {
    "naiveBayes": ("BayesianDistribution", "bayesian.model.file.path"),
    "logistic": ("LogisticRegressionJob", "coeff.file.path"),
    "tree": ("DecisionTreeBuilder", "tree.model.file.path"),
}


class DriftRetrainController:
    """Window tap: detector → batch refit over retained rows → hot-swap."""

    def __init__(self, conf: JobConfig, batcher, detector: DriftDetector,
                 model: Optional[str] = None,
                 counters: Optional[Counters] = None, device=None):
        self.conf = conf
        self.batcher = batcher
        self.detector = detector
        self.model = model or conf.get("stream.retrain.model", "naiveBayes")
        self.workdir = conf.get("stream.retrain.dir")
        if not self.workdir:
            raise ConfigError(
                "drift retraining requires stream.retrain.dir (the "
                "workspace retrain inputs and artifacts are staged under)")
        live = batcher.registry.get(self.model)
        # the fit and the load run where the live model serves, never on
        # a default device
        self.device = live.device if device is None else device
        family = live.family
        if family not in RETRAIN_JOBS:
            raise ConfigError(
                f"no retrain job mapped for serving family {family!r}; "
                f"retrainable: {sorted(RETRAIN_JOBS)}")
        self.family = family
        self.job_name, self.artifact_key = RETRAIN_JOBS[family]
        self.counters = counters if counters is not None else Counters()
        self.swaps = 0
        self.last_swap_s: Optional[float] = None
        self.last_version: Optional[int] = None

    def on_window(self, window: WindowResult) -> Optional[int]:
        """Feed one completed window; returns the new model version when
        this window tripped a retrain+swap, else None.

        The firing is committed into the detector (rebase + streak reset)
        only AFTER the retrain+swap landed: a deferred or failed response
        leaves the firing unconsumed, so a one-time step change keeps
        re-firing on subsequent (fully-retained) windows instead of
        silently becoming the new reference with the stale model still
        serving."""
        event = self.detector.update(window, commit=False)
        if event is None:
            return None
        try:
            version = self.retrain_and_swap(window, event)
        except ConfigError:
            raise                    # misconfiguration never self-heals
        except Exception as exc:
            # a transient retrain/load/swap failure (full disk, malformed
            # artifact, warmup OOM) must not kill the live analytics
            # plane: the firing stays unconsumed, so sustained drift
            # re-fires on the next window against the old reference
            self.counters.increment("Stream", "retrain.failed")
            tel.tracer().event("drift.retrain.failed", window=window.index,
                               model=self.model,
                               error=f"{type(exc).__name__}: {exc}")
            return None
        if version is not None:
            self.detector.commit_fire(window.tables)
        return version

    def _artifact_value(self, artifact: str) -> str:
        """What ``self.artifact_key`` must point at for this family — THE
        single definition shared by the fit conf and the servable-loader
        conf, so the swap always loads exactly what the retrain wrote."""
        if self.family == "logistic":
            # the LR job WRITES through its artifact key rather than the
            # output path
            return os.path.join(artifact, "coeff.txt")
        return artifact

    def _train_conf(self, artifact: str) -> JobConfig:
        """A minimal batch-fit conf derived from the live one.  Keys that
        must NOT leak from the serving/stream conf into the fit: the
        family's own artifact key (a set ``tree.model.file.path`` flips
        DecisionTreeBuilder into its PREDICT mode — the retrain would
        score rows with the old model instead of training), and the live
        stream's durability/fault keys (a set ``stream.checkpoint.dir``
        would point the fit's own StreamCheckpointer at the stream's
        pane-ring snapshot directory — tag conflict or sweep either way)."""
        drop = {self.artifact_key, "stream.checkpoint.dir", "stream.resume",
                "stream.fault.crash.after.chunks",
                "stream.fault.crash.after.panes"}
        # JobConfig accepts every key both bare and prefix-namespaced
        # (``avenir.tree.model.file.path`` == ``tree.model.file.path``), so
        # the namespaced spelling leaks through a bare-only drop set
        drop |= {f"{self.conf.prefix}.{k}" for k in tuple(drop)}
        conf = JobConfig({k: v for k, v in self.conf.props.items()
                          if k not in drop}, prefix=self.conf.prefix)
        if self.family == "logistic":
            conf.set(self.artifact_key, self._artifact_value(artifact))
        return conf

    def retrain_and_swap(self, window: WindowResult,
                         event: DriftEvent) -> Optional[int]:
        """The drift response: batch fit over the window's rows, publish,
        swap.  Raises if the scan does not retain rows at all — a detector
        wired to a retraining controller needs
        ``WindowedScan(retain_rows=True)``.  A retaining window whose raw
        rows are nevertheless missing (it contains panes restored from a
        checkpoint — snapshots persist counts, not rows) DEFERS instead:
        the firing is dropped, and genuinely sustained drift re-fires
        against the rebased reference on fully-retained windows."""
        if not window.lines:
            if not window.retained:
                raise ConfigError(
                    "drift fired but the scan does not retain rows — "
                    "construct the WindowedScan with retain_rows=True "
                    "(stream.retain.rows) when a DriftRetrainController "
                    "is attached")
            self.counters.increment("Stream", "retrain.deferred")
            return None
        from avenir_tpu_torch.jobs import get_job          # lazy: avoid the cycle
        from avenir_tpu_torch.serving.registry import FAMILIES

        t0 = time.perf_counter()
        # workspace per firing, keyed by window index (monotonic within a
        # run; two firings can never share a window)
        stage_dir = os.path.join(self.workdir, f"retrain-w{window.index}")
        os.makedirs(stage_dir, exist_ok=True)
        input_path = os.path.join(stage_dir, "input.csv")
        with open(input_path, "w") as fh:
            for line in window.lines:
                fh.write(line)
                fh.write("\n")
        artifact = os.path.join(stage_dir, "model")
        get_job(self.job_name).run(self._train_conf(artifact), input_path,
                                   artifact, device=self.device)
        serve_conf = JobConfig(dict(self.conf.props), prefix=self.conf.prefix)
        serve_conf.set(self.artifact_key, self._artifact_value(artifact))
        entry = FAMILIES[self.family].from_conf(serve_conf,
                                                device=self.device)
        version = self.batcher.swap(
            self.model, entry,
            warm=self.conf.get_bool("serve.swap.warmup", True))
        dur = time.perf_counter() - t0
        self.swaps += 1
        self.last_swap_s = dur
        self.last_version = version
        self.counters.increment("Stream", "retrains")
        tel.tracer().event("drift.retrain", window=window.index,
                           model=self.model, version=version,
                           rows=len(window.lines), dur_ms=round(dur * 1e3, 3))
        return version
