"""Regression jobs — iterative logistic regression and the Fisher
discriminant (regress/LogisticRegressionJob.java,
discriminant/FisherDiscriminant.java); port of
``avenir_tpu/jobs/regress.py``."""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from avenir_tpu_torch.core.config import ConfigError, JobConfig
from avenir_tpu_torch.jobs.base import Job, write_output
from avenir_tpu_torch.models import fisher as mfisher
from avenir_tpu_torch.models import logistic as mlr
from avenir_tpu_torch.utils.locking import FileLock, atomic_write
from avenir_tpu_torch.utils.metrics import Counters


class LogisticRegressionJob(Job):
    """Batch-gradient LR to convergence, with the reference's coefficient
    history file as the checkpoint it resumes from
    (LogisticRegressionJob.java:238-255, 279-289): the driver loop and its
    per-iteration MR job become one gradient loop on the device, with a
    learning rate applied.

    Properties: ``coeff.file.path`` (the history; resumed from its last
    row if present, default ``<output>/coefficients.txt``),
    ``iteration.limit``, ``convergence.criteria`` (all|average),
    ``convergence.threshold`` (percent), ``learning.rate``, ``l2.weight``,
    ``coeff.lock.timeout.sec``.  The history file is locked for the whole
    read-resume-train-rewrite cycle, so a concurrent run raises
    ``LockHeldError`` instead of interleaving, and rewritten atomically.

    In a fleet only process 0 (the writer) takes the lock and reads the
    history; the others receive it through one collective
    (:meth:`_broadcast_resume`), and each iteration merges the owned
    chunks' gradient partials (``fit_chunked(merge=)``)."""

    name = "LogisticRegressionJob"

    def execute(self, conf: JobConfig, input_path: str, output_path: str,
                counters: Counters) -> None:
        coeff_path = conf.get("coeff.file.path") or os.path.join(
            output_path, "coefficients.txt")
        est = mlr.LogisticRegression(
            learning_rate=conf.get_float("learning.rate", 0.5),
            max_iterations=conf.get_int("iteration.limit", 200),
            convergence=conf.get("convergence.criteria", "average"),
            threshold_pct=conf.get_float("convergence.threshold", 0.5),
            l2=conf.get_float("l2.weight", 0.0), mesh=self.auto_mesh(conf),
            device=self.device)
        os.makedirs(os.path.dirname(coeff_path) or ".", exist_ok=True)
        writer = self.is_output_writer()
        lock = (FileLock(coeff_path,
                         timeout_s=conf.get_float("coeff.lock.timeout.sec",
                                                  10.0))
                if writer else contextlib.nullcontext())
        with lock:
            resume = None
            read_err = None
            if writer and os.path.exists(coeff_path):
                try:
                    with open(coeff_path) as fh:
                        lines = [ln for ln in fh if ln.strip()]
                    if lines:
                        resume = mlr.LogisticRegressionModel.from_history_lines(
                            lines, delim=conf.field_delim)
                except Exception as e:
                    # in a fleet the failure travels through the broadcast
                    # collective, so no peer is left waiting in it
                    if self.process_grid()[1] <= 1:
                        raise
                    read_err = f"{type(e).__name__}: {e}"
            resume = self._broadcast_resume(resume, read_err)
            if conf.get("stream.chunk.rows"):
                model = self._fit_streaming(conf, input_path, counters, est,
                                            resume)
                n_rows = model.n_rows
            else:
                _enc, ds, _rows = self.encode_input(conf, input_path,
                                                    need_rows=False)
                x = mlr.design_matrix(ds, device=self.device)
                y = torch.as_tensor(ds.labels).to(self.device)
                model = est.fit(x, y, resume_from=resume)
                n_rows = ds.num_rows
            hist = model.history_lines(delim=conf.field_delim)
            if writer:
                with atomic_write(coeff_path) as fh:
                    fh.write("\n".join(hist) + "\n")
        status = "converged" if model.converged else "iterationLimit"
        if writer:
            write_output(output_path,
                         hist + [f"status{conf.field_delim}{status}"])
        counters.set("Records", "Processed", n_rows)
        counters.set("Iterations", "Run", model.iterations)
        counters.set("Iterations", "Converged", int(model.converged))

    @classmethod
    def _broadcast_resume(cls, resume, read_err=None):
        """Ship the writer's locked resume history to every process through
        the gradient fold's collective (``all_process_sum_state``): process
        0 contributes the [iters, D] float64 stack, the others nothing, and
        every process rebuilds the same model bit for bit.  A read or pack
        failure on the writer rides the same payload and raises on every
        process.  One process returns ``resume`` as it is."""
        if cls.process_grid()[1] <= 1:
            return resume
        from avenir_tpu_torch.parallel.mesh import all_process_sum_state

        state = {}
        if read_err is None and resume is not None:
            try:
                state["lr_resume_hist"] = np.stack(resume.history).astype(
                    np.float64)
            except Exception as e:     # a ragged history: still enter the
                read_err = f"{type(e).__name__}: {e}"   # collective below
        if read_err is not None:
            state["lr_resume_error"] = np.frombuffer(
                read_err.encode(), np.uint8).copy()
        folded = all_process_sum_state(state)
        err = folded.get("lr_resume_error")
        if err is not None:
            raise ValueError(
                "coefficient-history resume failed on the writer: "
                + err.tobytes().decode(errors="replace"))
        hist = folded.get("lr_resume_hist")
        if hist is None:
            return None
        rows = [np.asarray(r) for r in hist]
        return mlr.LogisticRegressionModel(
            weights=rows[-1], history=rows, converged=False,
            iterations=len(rows))

    def _fit_streaming(self, conf: JobConfig, input_path: str,
                       counters: Counters, est, resume):
        """Streamed LR: each ``stream.chunk.rows`` chunk is encoded once
        into a design-matrix block that stays on the device across the
        iterations; every iteration folds the blocks' gradient partials in
        chunk order (``LogisticRegression.fit_chunked``), as the reference's
        per-iteration MR job folded its mappers' partials
        (LogisticRegressionJob.java:169-176, 279-289); in a fleet each
        process encodes only the chunks it owns."""
        if conf.get("stream.checkpoint.dir"):
            raise ConfigError(
                "stream.checkpoint.dir does not apply to "
                "LogisticRegressionJob: the coefficient history file IS "
                "the checkpoint (every completed iteration is durable and a "
                "re-run resumes from its last row, "
                "LogisticRegressionJob.java:238-255) — unset the key")
        owner, _acc, distributed = self.distributed_plan(conf, None)
        enc = self.encoder_for(conf)
        chunks = [(cur["chunk"] - 1,
                   mlr.design_matrix(ds, device=self.device),
                   torch.as_tensor(ds.labels).to(self.device))
                  for ds, cur in self.iter_encoded_retrying(
                      conf, input_path, enc, counters, emit_cursor=True,
                      owner=owner)]
        merge = None
        if distributed:
            from avenir_tpu_torch.parallel.mesh import all_process_sum_state

            merge = all_process_sum_state
        return est.fit_chunked(chunks, resume_from=resume, merge=merge)


class FisherDiscriminant(Job):
    """Per-attribute univariate Fisher/LDA for a binary class: one line per
    continuous attribute with its pooled variance, the log-odds prior and
    the decision boundary (FisherDiscriminant.java:83-117)."""

    name = "FisherDiscriminant"

    def execute(self, conf: JobConfig, input_path: str, output_path: str,
                counters: Counters) -> None:
        _enc, ds, _rows = self.encode_input(conf, input_path, need_rows=False)
        schema = self.load_schema(conf)
        names = [schema.field_by_ordinal(o).name for o in ds.cont_ordinals]
        model = mfisher.FisherDiscriminant(mesh=self.auto_mesh(conf),
                                           device=self.device).fit(ds)
        write_output(output_path,
                     model.to_lines(feature_names=names, delim=conf.field_delim))
        counters.set("Records", "Processed", ds.num_rows)
