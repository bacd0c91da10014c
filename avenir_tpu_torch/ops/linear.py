"""float32 matrix products shared by the models and the mesh steps: the
precision they run under, and the logistic regression's gradient
partial (the quantity the reference's mapper emitted,
regress/LogisticRegressionJob.java:169-176)."""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch


@contextlib.contextmanager
def full_float32() -> Iterator[None]:
    """float32 matrix products in full float32 on the card (no TF32), as
    the JAX package's ``precision="highest"`` asks; restores the flags."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])


def chunk_grad(w: torch.Tensor, x: torch.Tensor, y: torch.Tensor
               ) -> torch.Tensor:
    """A chunk's or a shard's unscaled gradient partial Σ x·(y−σ(wᵀx))."""
    p = torch.sigmoid(x @ w)
    return x.t() @ (y - p)
