"""The hospital configuration's unit of work: one fused NB + MI job,
``SharedScan.run`` with a ``NaiveBayesConsumer`` and a
``MutualInfoConsumer`` over the rows staged on the card, in the chunks
the traffic mix names.

Traffic parameters: ``rows`` (rows a job), ``chunk_rows``,
``slack_rows`` and ``granule_rows``.  ``rows + slack_rows`` rows are
staged, and each job reads ``rows`` of them from its own start, a
multiple of ``granule_rows`` up to ``slack_rows``: the starts walk
through every such multiple in an order drawn from the seed, so no two
jobs of a window read the same rows and no job's answer can stand in
for another's.  Every job's outputs are held to the reference's tables
for its own rows, worked out after the window.
"""

from __future__ import annotations

import math
import random
from typing import Dict, List

import torch

from cardbench import program

from . import compare, generator, reference


class Workload:
    items = "rows"

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.schema = config["schema"]
        self.rows = int(traffic["rows"])
        self.chunk_rows = int(traffic["chunk_rows"])
        self.slack = int(traffic["slack_rows"])
        self.granule = int(traffic["granule_rows"])
        if self.slack % self.granule or self.slack > self.rows:
            raise ValueError("slack_rows is a multiple of granule_rows, "
                             "at most rows")
        self.starts = self.slack // self.granule + 1
        rng = random.Random(seed)
        self._first = rng.randrange(self.starts)
        self._step = rng.randrange(1, max(2, self.starts))
        while math.gcd(self._step, self.starts) != 1:
            self._step = rng.randrange(1, self.starts)
        self.block = int(traffic.get("block", generator.BLOCK))
        self.seed = seed
        self.device = torch.device(device)
        self.n_bins = generator.n_bins(self.schema)
        self.class_values = generator.class_values(self.schema)
        self.names = [f["name"] for f in generator.binned_fields(self.schema)]
        self.laplace = float(config["laplace"])
        self.outputs: List[tuple] = []      # (start, the job's outputs)

    def shape(self) -> Dict[str, object]:
        return {"chunk_rows": self.chunk_rows, "n_bins": self.n_bins,
                "num_classes": len(self.class_values)}

    def start(self, index: int) -> int:
        """The first staged row of the window's job ``index`` (the warm-up
        job at set-up is index -1)."""
        return self.granule * ((self._first + (index + 1) * self._step)
                               % self.starts)

    def make_inputs(self) -> None:
        """The rows, drawn on the card from the seed."""
        self.codes, self.labels = generator.generate(
            self.schema, self.rows + self.slack, self.seed, self.device,
            block=self.block)

    def setup(self) -> None:
        import numpy as np

        self._cont = torch.zeros((self.rows + self.slack, 0),
                                 dtype=torch.float32, device=self.device)
        self._n_bins = np.asarray(self.n_bins, np.int32)
        self._ords = [f["ordinal"]
                      for f in generator.binned_fields(self.schema)]
        self._job(self.start(-1))   # builds the kernels, warms every shape

    def _chunks(self, first: int) -> list:
        """The job's chunks: views of the staged rows from ``first``."""
        from avenir_tpu_torch.core.encoding import EncodedDataset

        cr = self.chunk_rows
        return [EncodedDataset(codes=self.codes[s:s + cr],
                               cont=self._cont[s:s + cr],
                               labels=self.labels[s:s + cr],
                               n_bins=self._n_bins,
                               class_values=self.class_values,
                               binned_ordinals=self._ords, cont_ordinals=[])
                for s in range(first, first + self.rows, cr)]

    def _job(self, first: int) -> dict:
        from avenir_tpu_torch.pipeline.scan import (MutualInfoConsumer,
                                                    NaiveBayesConsumer,
                                                    SharedScan)

        scan = SharedScan(device=self.device)
        scan.register(NaiveBayesConsumer(laplace=self.laplace, name="nb"))
        scan.register(MutualInfoConsumer(feature_names=self.names, name="mi"))
        with program.span(program.SCAN_RUN_SPAN):
            return scan.run(self._chunks(first))

    def unit(self, index: int) -> int:
        first = self.start(index)
        self.outputs.append((first, self._job(first)))
        return self.rows

    def release(self) -> None:
        """Nothing of the program outlives its job; the staged rows are
        the benchmark's own inputs, which the reference reads."""
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _tables(self) -> reference.JobTables:
        return reference.JobTables(self.codes, self.labels, self.n_bins,
                                   len(self.class_values), self.rows,
                                   self.slack, self.granule)

    def check(self) -> Dict[str, float]:
        tables = self._tables()
        refs: Dict[int, object] = {}

        def ref(first):
            if first not in refs:
                refs[first] = reference.from_tables(
                    tables.at(first), self.n_bins, self.laplace)
            return refs[first]

        return compare.worst(compare.job_gaps(o, ref(first))
                             for first, o in self.outputs)

    def control(self) -> Dict[str, float]:
        """The control's readings (after :meth:`make_inputs`): the
        reference one precision step down, in the program's place, over
        the rows of the window's first job."""
        first = self.start(0)
        rows = slice(first, first + self.rows)
        out = reference.control_outputs(
            self.codes[rows], self.labels[rows], self.n_bins,
            len(self.class_values), self.laplace)
        ref = reference.from_tables(self._tables().at(first), self.n_bins,
                                    self.laplace)
        return compare.job_gaps(out, ref)
