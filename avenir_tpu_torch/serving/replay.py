"""ScoringPlane job — a pipeline's ``serve`` stage; port of
``avenir_tpu/serving/replay.py``.

Replays a CSV artifact through the ONLINE scoring plane (registry +
bucketed microbatcher) and writes the responses as a batch output artifact.
Two uses:

- in a :class:`~avenir_tpu_torch.pipeline.driver.Pipeline`, a trained artifact
  hands off to serving in the same DAG (``Stage("serve", "ScoringPlane",
  input="test", output="scored", props={"serve.models": "naiveBayes",
  "bayesian.model.file.path": "@bayes_model"}, uses=("bayes_model",))``);
- as the parity oracle: the replay output must be byte-identical to the
  corresponding batch predictor job's output on the same rows
  (tests/test_torch_serving.py asserts it for every family).

It runs on ``cuda`` unless the caller asks for the CPU, like every job;
the kNN family launches B5 or B6 once per bucket dispatch there.

In-flight requests are capped below the queue depth, so a replay can never
shed against itself — backpressure is for *concurrent* online clients.
"""

from __future__ import annotations

from collections import deque

from avenir_tpu_torch.core.config import ConfigError, JobConfig
from avenir_tpu_torch.jobs.base import Job, read_lines, write_output
from avenir_tpu_torch.utils.metrics import Counters


class ScoringPlane(Job):
    """Replay ``input`` through the serving plane for ``serve.replay.model``
    (defaults to the single loaded family); merges the serving counters —
    requests, batch-size histogram, recompiles — into the job counters."""

    name = "ScoringPlane"

    def execute(self, conf: JobConfig, input_path: str, output_path: str,
                counters: Counters) -> None:
        from avenir_tpu_torch.serving.batcher import BucketedMicrobatcher
        from avenir_tpu_torch.serving.registry import ModelRegistry

        registry = ModelRegistry.from_conf(conf, device=self.device)
        model = conf.get("serve.replay.model")
        if not model:
            names = registry.names()
            if len(names) != 1:
                raise ConfigError(
                    f"serve.replay.model must pick one of the loaded "
                    f"models {names}")
            model = names[0]
        batcher = BucketedMicrobatcher.from_conf(registry, conf)
        lines = read_lines(input_path)
        max_inflight = max(batcher.queue_depth - 1, 1)
        from avenir_tpu_torch.telemetry import spans as tel

        # every submit below runs inside this job's span, so each request's
        # PendingRequest captures it and the serving spans join THIS trace
        tel.tracer().event("serve.replay", model=model, rows=len(lines),
                           max_inflight=max_inflight)
        outs = [None] * len(lines)
        wait_s = batcher.request_timeout_s + 30.0
        pending = deque()
        try:
            for i, line in enumerate(lines):
                if len(pending) >= max_inflight:
                    j, req = pending.popleft()
                    outs[j] = req.wait(wait_s)
                pending.append((i, batcher.submit_nowait(model, line)))
            for j, req in pending:
                outs[j] = req.wait(wait_s)
        finally:
            batcher.close()
        write_output(output_path, outs)
        counters.merge(batcher.counters)
        counters.set("Records", "Processed", len(outs))
        for name, stats in batcher.stats().items():
            counters.set(f"Serving.{name}", "p99_us",
                         int(stats["p99_ms"] * 1000))
            counters.set(f"Serving.{name}", "p50_us",
                         int(stats["p50_ms"] * 1000))
