"""StreamAnalytics job — windowed streaming analytics as a pipeline stage;
port of ``avenir_tpu/stream/job.py``.

Replays a CSV artifact through
:class:`~avenir_tpu_torch.stream.windows.WindowedScan` via the in-proc
queue transport (the push/pop surface a live source drives), and writes one
deterministic summary block per window: window identity, the class
distribution, and — when a drift threshold is configured — the window's
divergence and detection state.  The job is the batch-replayable face of
the continuous plane: the same windows a live stream would emit,
reproducible from a file, and the seam the kill-and-resume drills drive.

The ``shard.*`` topology is honoured on local devices: the job builds
one ``ShardSpec``, journals its ``shard.topology`` and folds every pane
over its mesh, with window lines byte-identical to the unsharded run's.
Without a ``shard.*`` plan the panes fold over the job's data mesh
(``Job.auto_mesh``, ``data.parallel.auto``), as in the JAX package.  In a
fleet a ``shard.*`` plan is the global (proc × data) mesh: every process
folds the same windows to the same totals and process 0 writes.  A pane
snapshot of another topology resumes under ``shard.reshard.on.restore``.
"""

from __future__ import annotations

import os
from typing import List

from avenir_tpu_torch.core.config import ConfigError, JobConfig
from avenir_tpu_torch.jobs.base import Job, input_files, output_target
from avenir_tpu_torch.pipeline import scan
from avenir_tpu_torch.pipeline.streaming import InProcQueue
from avenir_tpu_torch.stream.drift import DriftDetector
from avenir_tpu_torch.stream.windows import (
    ClassDistributionConsumer,
    WindowCheckpointer,
    WindowedScan,
)
from avenir_tpu_torch.utils.metrics import Counters

# stream.consumers ids → consumer factories (conf-parameterized where the
# batch job is)
CONSUMER_IDS = ("classDistribution", "naiveBayes", "mutualInfo", "cramer",
                "fisher")


def consumers_from_conf(conf: JobConfig) -> List[scan.ScanConsumer]:
    out: List[scan.ScanConsumer] = []
    for cid in conf.get_list("stream.consumers", ["classDistribution"]):
        if cid == "classDistribution":
            out.append(ClassDistributionConsumer(name=cid))
        elif cid == "naiveBayes":
            out.append(scan.NaiveBayesConsumer(
                laplace=conf.get_float("laplace.smoothing", 1.0), name=cid))
        elif cid == "mutualInfo":
            out.append(scan.MutualInfoConsumer(name=cid))
        elif cid == "cramer":
            out.append(scan.CorrelationConsumer(against_class=True, name=cid))
        elif cid == "fisher":
            out.append(scan.FisherConsumer(name=cid))
        else:
            raise ConfigError(
                f"unknown stream consumer {cid!r}; known: {CONSUMER_IDS}")
    return out


class StreamAnalytics(Job):
    """Windowed scan replay: ``input`` rows → per-window summary lines."""

    name = "StreamAnalytics"

    def execute(self, conf: JobConfig, input_path: str, output_path: str,
                counters: Counters) -> None:
        from avenir_tpu_torch.parallel.shard import ShardSpec
        from avenir_tpu_torch.utils.retry import FaultPlan

        enc = self.encoder_for(conf)
        pane_rows = conf.get_int("stream.pane.rows", 1024)
        window_panes = conf.get_int("stream.window.panes", 1)
        shard = ShardSpec.from_conf(conf, self.device)
        if shard is not None:
            shard.announce()
        detector = DriftDetector.from_conf(conf, counters)
        # one conf-driven fault plan shared by every seam: fold boundaries
        # (WindowedScan) and checkpoint save/restore (WindowCheckpointer)
        # count against the same schedule
        fault = FaultPlan.from_conf(conf)
        ckpt = WindowCheckpointer.from_conf(conf, fault=fault)
        if ckpt is not None and detector is not None:
            # the detector's reference/streak ride the ring snapshot: the
            # handle callback below runs at EMISSION, before the pane's
            # snapshot, so a resumed run's drift sequence is byte-identical
            # to an uninterrupted one
            ckpt.attach("drift", detector)
        delim = conf.field_delim
        # under a global plan every process folds the same windows: process
        # 0 writes, the others stream to devnull; _window_lines still runs
        # everywhere, as it advances the drift detector whose state rides
        # each process's snapshot
        writer = self.is_output_writer()

        def handle(window):
            for ln in self._window_lines(window, detector, delim):
                out_fh.write(ln)
                out_fh.write("\n")

        ws = WindowedScan(
            enc, consumers_from_conf(conf), pane_rows,
            window_panes=window_panes,
            slide_panes=conf.get_int("stream.slide.panes", window_panes),
            delim=conf.field_delim_regex,
            device=self.device,
            pad_pow2=conf.get_bool("stream.pane.pad.pow2", True),
            retain_rows=conf.get_bool("stream.retain.rows", False),
            counters=counters, checkpointer=ckpt,
            crash_after_panes=conf.get_int("stream.fault.crash.after.panes",
                                           0),
            on_window=handle, fault=fault,
            pack_on=conf.get_bool("scan.pack.on", True),
            pack_max_width=conf.get_int("scan.pack.max.width", 0) or None,
            shard=shard,
            mesh=None if shard is not None else self.auto_mesh(conf))
        skip = ckpt.restore_into(ws) if ckpt is not None else 0
        if conf.get_bool("stream.warmup.on.start", True):
            ws.warm()
        queue = InProcQueue(conf.get_int("stream.queue.depth",
                                         InProcQueue.DEFAULT_DEPTH))
        # window blocks stream to a sibling .inprogress file as they close
        # (output-side memory stays O(window) like the input side), renamed
        # into the real artifact only on clean completion: a failed run
        # leaves no output path a resume-skip could mistake for a completed
        # stage, and never truncates a previous good artifact
        tmp_path = output_path.rstrip(os.sep) + ".inprogress"
        parent = os.path.dirname(tmp_path)
        if parent and writer:
            os.makedirs(parent, exist_ok=True)
        out_fh = open(tmp_path, "w") if writer else open(os.devnull, "w")
        step = max(min(queue.depth or pane_rows, pane_rows), 1)
        batch: List[str] = []
        try:
            for line in self._iter_lines(input_path, skip):
                batch.append(line)
                if len(batch) >= step:
                    queue.push_all(batch)
                    batch.clear()
                    ws.pump(queue)
            queue.push_all(batch)
            ws.pump(queue)
            ws.flush()
        finally:
            out_fh.close()
        if writer:
            os.replace(tmp_path, output_target(output_path))
        if ckpt is not None:
            ckpt.finish()                # clean completion: sweep snapshots
        counters.set("Records", "Processed", ws.rows_consumed)

    @staticmethod
    def _iter_lines(input_path: str, skip: int):
        """Non-blank input lines after the resume cursor, streamed — the
        replay never materializes the whole artifact."""
        seen = 0
        for path in input_files(input_path):
            with open(path) as fh:
                for raw in fh:
                    line = raw.rstrip("\r\n")
                    if not line.strip():
                        continue
                    seen += 1
                    if seen > skip:
                        yield line

    @staticmethod
    def _window_lines(window, detector, delim: str) -> List[str]:
        out = [delim.join(
            [f"w={window.index}",
             f"panes={window.first_pane}-{window.last_pane}",
             f"rows={window.rows}"])]
        summary = window.results.get("classDistribution")
        if summary is not None:
            for value, count in zip(summary["classes"], summary["counts"]):
                out.append(delim.join(
                    [f"w={window.index}", "class", value, str(int(count))]))
        if detector is not None:
            fired = detector.update(window) is not None
            div = detector.last_divergence
            out.append(delim.join(
                [f"w={window.index}", "drift",
                 f"{0.0 if div is None else div:.6f}",
                 "detected" if fired else "ok"]))
        return out


# self-registration (see the matching comment at the bottom of
# jobs/__init__.py): by the time this body line runs, avenir_tpu_torch.jobs
# has REGISTRY/JOB_CLASSES bound no matter which side of the cycle was
# imported first
from avenir_tpu_torch.jobs import JOB_CLASSES, REGISTRY  # noqa: E402

JOB_CLASSES.append(StreamAnalytics)
REGISTRY[StreamAnalytics.name] = StreamAnalytics
