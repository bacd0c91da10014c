"""The e-learning configuration's unit of work: one ``KNN.predict`` call
on a batch of queries, against a model ``fit_knn`` built at set-up from
the references.

Traffic parameters: ``refs`` (reference rows), ``batch`` (queries a
call), ``pool_rows`` (query rows made at set-up from the seed) and
``check_batches`` (calls of the window whose answers are checked, drawn
from the seed).  Each call's batch is the ``batch`` pool rows from a
start of its own: the starts walk through every row of the pool in an
order drawn from the seed, so no two calls of a window ask the same
batch and no call's answer can stand in for another's.
"""

from __future__ import annotations

import math
import random
from typing import Dict, List

import numpy as np
import torch

from cardbench import program
from cardbench.yardstick import work

from . import compare, generator, reference

WARM_BATCHES = (3, 16)      # at least, at most


class Workload:
    items = "queries"

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config = config
        self.k = int(config["k"])
        self.refs = int(traffic["refs"])
        self.batch = int(traffic["batch"])
        self.pool_rows = int(traffic["pool_rows"])
        self.check_batches = int(traffic["check_batches"])
        self.seed = seed
        self.device = torch.device(device)
        self.class_values = [f for f in config["schema"]["fields"]
                             if f["name"] == "status"][0]["cardinality"]
        self.kept: List[tuple] = []         # (start, dist, idx, pred)
        self.starts = self.pool_rows - self.batch + 1
        rng = random.Random(seed)
        self._first = rng.randrange(self.starts)
        self._step = rng.randrange(1, max(2, self.starts))
        while math.gcd(self._step, self.starts) != 1:
            self._step = rng.randrange(1, self.starts)
        self._rng = rng
        self._seen = 0

    def shape(self) -> Dict[str, object]:
        return {"batch": self.batch, "refs": self.refs, "k": self.k,
                "used_lanes": work.knn_used_lanes(0, 0,
                                                  len(generator.FEATURES))}

    def _dataset(self, x, y):
        from avenir_tpu_torch.core.encoding import EncodedDataset

        return EncodedDataset(
            codes=np.zeros((x.shape[0], 0), np.int32), cont=x, labels=y,
            n_bins=np.zeros(0, np.int32), class_values=self.class_values,
            binned_ordinals=[], cont_ordinals=list(range(1, x.shape[1] + 1)))

    def start(self, index: int) -> int:
        """The first pool row of the window's call ``index`` (the warm-up
        calls at set-up are the negative indices)."""
        return (self._first + index * self._step) % self.starts

    def queries(self, index: int):
        """The batch of call ``index``: views of the pool."""
        s = self.start(index)
        return self._dataset(self.pool_x[s:s + self.batch],
                             self.pool_y[s:s + self.batch])

    def make_inputs(self) -> None:
        """The references and the query pool, drawn from the seed."""
        self.ref_x, self.ref_y = generator.generate(self.refs, self.seed, 0)
        self.pool_x, self.pool_y = generator.generate(self.pool_rows,
                                                      self.seed, 1)

    def setup(self) -> None:
        from avenir_tpu_torch.models.knn import KNN, fit_knn

        self.model = fit_knn(self._dataset(self.ref_x, self.ref_y))
        self.knn = KNN(k=self.k, metric=self.config["metric"],
                       kernel=self.config["kernel"], device=self.device)
        # the first calls pack and upload the references and build the
        # kernels; go on until a certificate has failed once, so that the
        # exact scan's tiles are resident too
        fallback0 = program.read_counters()["knn_fallback_rows"]
        least, most = WARM_BATCHES
        for i in range(most):
            self.knn.predict(self.model, self.queries(-1 - i))
            fell = program.read_counters()["knn_fallback_rows"]
            if i + 1 >= least and (fallback0 is None or fell != fallback0):
                break

    def unit(self, index: int) -> int:
        res = self.knn.predict(self.model, self.queries(index))
        # a sample of the window's calls, drawn from the seed (reservoir)
        self._seen += 1
        item = (self.start(index), res.neighbor_dist, res.neighbor_idx, res.predicted)
        if len(self.kept) < self.check_batches:
            self.kept.append(item)
        else:
            slot = self._rng.randrange(self._seen)
            if slot < self.check_batches:
                self.kept[slot] = item
        return self.batch

    def release(self) -> None:
        """Frees the program's model and its resident copies."""
        self.model = self.knn = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _answers(self, start: int, precision: str = "exact"):
        return reference.answers(self.ref_x, self.ref_y,
                                 self.pool_x[start:start + self.batch],
                                 self.k, len(self.class_values), self.device,
                                 precision)

    def check(self) -> Dict[str, float]:
        return compare.total(
            compare.batch_gaps(dist, idx, pred, self._answers(s))
            for s, dist, idx, pred in self.kept)

    def control(self) -> Dict[str, float]:
        """The control's readings (after :meth:`make_inputs`): the
        reference's search in bfloat16 in the program's place, on the
        batches of as many of the window's first calls as a run checks."""
        picks = [self.start(i) for i in range(self.check_batches)]
        return compare.total(
            compare.batch_gaps(*self._answers(s, "bf16"), self._answers(s))
            for s in picks)
