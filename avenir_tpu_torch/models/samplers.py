"""Class-balancing and bootstrap samplers — port of
``avenir_tpu/models/samplers.py`` (the reference's
explore/BaggingSampler.java :100-122 and UnderSamplingBalancer.java
:92-164).

The draws come from ``utils/prng.py``, the port's copy of ``jax.random``,
so a seeded sample is the JAX package's row for row.  A key is the uint32
``[2]`` array of ``prng.prng_key`` / ``prng.split``.  The index gather and
the keep-mask compare run where the dataset lives: on its device when the
feeder has staged a chunk as tensors, on the host for numpy arrays.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from avenir_tpu_torch.core.encoding import EncodedDataset
from avenir_tpu_torch.utils import prng


def bootstrap_indices(key: np.ndarray, n: int, k: Optional[int] = None
                      ) -> np.ndarray:
    """k (default n) int32 indices drawn uniformly with replacement from
    [0, n)."""
    return prng.randint(key, (k if k is not None else n,), 0, n)


def _take(ds: EncodedDataset, idx: np.ndarray) -> EncodedDataset:
    """The rows ``idx`` of every column, gathered where each column lives."""
    def take(a):
        if a is None:
            return None
        if isinstance(a, torch.Tensor):
            return a[torch.as_tensor(idx, device=a.device).long()]
        return a[idx]

    return EncodedDataset(
        codes=take(ds.codes), cont=take(ds.cont), labels=take(ds.labels),
        ids=None if ds.ids is None else ds.ids[idx],
        n_bins=ds.n_bins, class_values=ds.class_values,
        binned_ordinals=ds.binned_ordinals, cont_ordinals=ds.cont_ordinals,
    )


def bagging_sample(key: np.ndarray, ds: EncodedDataset,
                   k: Optional[int] = None) -> EncodedDataset:
    """Bootstrap resample of a batch (with replacement), every column."""
    return _take(ds, bootstrap_indices(key, ds.num_rows, k))


def undersample_mask(key: np.ndarray, labels, class_counts):
    """Keep-mask balancing classes: minority rows always kept; class c rows
    kept with probability min_count / count_c (the reference's acceptance
    rule), in float32 as the JAX package computes it.  ``labels`` is a
    tensor (the mask comes back a bool tensor on its device) or a numpy
    array (a bool numpy array)."""
    on_tensor = isinstance(labels, torch.Tensor)
    lab = labels if on_tensor else torch.from_numpy(np.asarray(labels))
    dev = lab.device
    cc = torch.as_tensor(class_counts).to(device=dev, dtype=torch.float32)
    counts = torch.clamp(cc, min=1.0)
    min_count = torch.where(cc > 0, counts,
                            torch.full_like(counts, float("inf"))).min()
    keep_prob = min_count / counts                               # [C]
    u = torch.from_numpy(prng.uniform(key, tuple(lab.shape))).to(dev)
    mask = u < keep_prob[lab.long()]
    return mask if on_tensor else mask.numpy()


def _labels_numpy(labels) -> np.ndarray:
    return (labels.cpu().numpy() if isinstance(labels, torch.Tensor)
            else np.asarray(labels))


def undersample(key: np.ndarray, ds: EncodedDataset,
                class_counts: Optional[np.ndarray] = None) -> EncodedDataset:
    """Balanced subsample of a batch.  ``class_counts`` defaults to the
    batch's own counts (whole-dataset mode); pass running counts to
    stream."""
    if ds.labels is None:
        raise ValueError("undersampling requires labels")
    if class_counts is None:
        class_counts = np.bincount(_labels_numpy(ds.labels),
                                   minlength=ds.num_classes)
    mask = undersample_mask(key, ds.labels, class_counts)
    if isinstance(mask, torch.Tensor):
        mask = mask.cpu().numpy()
    return _take(ds, np.flatnonzero(mask))


class StreamingUnderSampler:
    """Streaming variant: the class distribution is estimated from the rows
    seen so far, as the reference does; the first batches are held until
    ``bootstrap_rows`` rows have arrived, then flushed and sampling
    begins.  Each sampled batch draws with the next key of
    ``prng.split``'s chain, as the JAX package's does."""

    def __init__(self, key: np.ndarray, bootstrap_rows: int = 10_000):
        self.key = np.asarray(key, np.uint32)
        self.bootstrap_rows = bootstrap_rows
        self._counts: Optional[np.ndarray] = None
        self._buffered = 0

    def process(self, chunks: Iterable[EncodedDataset]
                ) -> Iterator[EncodedDataset]:
        pending = []
        for ds in chunks:
            if ds.labels is None:
                raise ValueError("undersampling requires labels")
            batch_counts = np.bincount(_labels_numpy(ds.labels),
                                       minlength=ds.num_classes)
            self._counts = (batch_counts if self._counts is None
                            else self._counts + batch_counts)
            if self._buffered < self.bootstrap_rows:
                pending.append(ds)
                self._buffered += ds.num_rows
                if self._buffered >= self.bootstrap_rows:
                    for p in pending:
                        yield self._sample(p)
                    pending = []
            else:
                yield self._sample(ds)
        for p in pending:              # the stream ended before bootstrap
            yield self._sample(p)

    def _sample(self, ds: EncodedDataset) -> EncodedDataset:
        self.key, sub = prng.split(self.key)
        return undersample(sub, ds, self._counts)
