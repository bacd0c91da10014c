"""Binary logistic regression, full-batch gradient ascent — port of
``avenir_tpu/models/logistic.py`` (the reference's
regress/LogisticRegressionJob.java).

The gradient Σ x·(y−σ(wᵀx)) (:178-195 via LogisticRegressor.java:61-73)
is two float32 matrix-vector products on the device; the loop, the
coefficient history (one row per iteration, the checkpoint the job resumes
from, :238-255) and the convergence test (all or average relative
coefficient change under a percent threshold, LogisticRegressor.java
:105-163) run on the host.  As in the JAX package a learning rate and an
optional L2 term are applied, the documented fix of the reference's raw
aggregate update.

Precision: :meth:`LogisticRegression.fit` keeps float32 weights and
gradients, as the JAX package does; :meth:`~LogisticRegression.fit_chunked`
keeps float64 weights on the host and folds float32 chunk partials in
chunk order.  TF32 is held off while a step runs, so CUDA and the CPU
differ only in the order a matmul sums in (relative 1e-5 on the history).

Under a data ``mesh`` of two or more devices, :meth:`~LogisticRegression.fit`
splits x and y over the mesh (0.0 pad rows add a zero gradient term) and
runs ``parallel/collectives.py::sharded_lr_step`` each iteration: the
shards' float32 partials summed in shard order, scaled by the true row
count.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from avenir_tpu_torch.core.encoding import EncodedDataset, NoDataError
from avenir_tpu_torch.device import resolve_device
from avenir_tpu_torch.ops.linear import chunk_grad, full_float32
from avenir_tpu_torch.parallel.mesh import is_wide, place_batch


def design_matrix(ds: EncodedDataset, include_binned: bool = True,
                  intercept: bool = True, device=None) -> torch.Tensor:
    """[N, D] float32 design matrix on ``device``: a leading intercept
    column, the continuous features, then the one-hot binned features over
    each feature's valid bins (a −1 code indexes the last bin, as numpy's
    and the JAX package's ``np.eye(B)[codes]`` does)."""
    dev = resolve_device(device)
    n = ds.num_rows
    parts = []
    if intercept:
        parts.append(torch.ones((n, 1), dtype=torch.float32, device=dev))
    if ds.num_cont:
        parts.append(torch.as_tensor(ds.cont, dtype=torch.float32).to(dev))
    if include_binned and ds.num_binned:
        b = ds.max_bins
        codes = torch.as_tensor(ds.codes).to(dev).long()
        onehot = torch.eye(b, dtype=torch.float32, device=dev)[codes]
        mask = torch.from_numpy(
            np.arange(b)[None, :] < np.asarray(ds.n_bins)[:, None]).to(dev)
        parts.append(onehot[:, mask])                      # [N, Σ bins]
    if not parts:
        return torch.zeros((n, 0), dtype=torch.float32, device=dev)
    return torch.cat(parts, dim=1)


def _grad_step(w: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
               n: torch.Tensor, lr: torch.Tensor, l2: torch.Tensor
               ) -> torch.Tensor:
    """One full-batch gradient-ascent step on the log-likelihood, float32."""
    return w + lr * (chunk_grad(w, x, y) / n - l2 * w)


def _sigmoid_scores(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[N] σ(x·w)."""
    return torch.sigmoid(x @ w)


def predict_batch(model_or_weights, x, threshold: float = 0.5,
                  device=None) -> Tuple[np.ndarray, np.ndarray]:
    """([N] float32 probabilities, [N] int32 0/1 labels) scored on
    ``device``, from a :class:`LogisticRegressionModel` or a weight
    vector; a tensor operand already on ``device`` is used as it is."""
    dev = resolve_device(device)
    w = getattr(model_or_weights, "weights", model_or_weights)

    def on_device(a):
        if isinstance(a, torch.Tensor):
            return a.to(dev, torch.float32)
        return torch.as_tensor(np.array(a, np.float32)).to(dev)

    w, xt = on_device(w), on_device(x)
    with full_float32():
        probs = _sigmoid_scores(w, xt).cpu().numpy()
    return probs, (probs >= threshold).astype(np.int32)


def _converged(prev: np.ndarray, cur: np.ndarray, criterion: str,
               threshold_pct: float) -> bool:
    """Relative per-coefficient change in percent (LogisticRegressor.java
    :105-163): 'all' = every coefficient under the threshold, 'average' =
    their mean under it."""
    denom = np.maximum(np.abs(prev), 1e-9)
    diff_pct = 100.0 * np.abs(cur - prev) / denom
    if criterion == "all":
        return bool((diff_pct < threshold_pct).all())
    if criterion == "average":
        return bool(diff_pct.mean() < threshold_pct)
    raise ValueError(f"unknown convergence criterion {criterion!r}")


@dataclass
class LogisticRegressionModel:
    weights: np.ndarray                      # [D]
    history: List[np.ndarray] = dc_field(default_factory=list)
    converged: bool = False
    iterations: int = 0
    n_rows: int = 0                          # rows fit_chunked saw

    def history_lines(self, delim: str = ",") -> List[str]:
        """The coefficient file: one row per iteration, ``repr`` of each
        coefficient as a Python float."""
        return [delim.join(repr(float(v)) for v in row) for row in self.history]

    @classmethod
    def from_history_lines(cls, lines: Iterable[str], delim: str = ","
                           ) -> "LogisticRegressionModel":
        hist = [np.array([float(v) for v in line.split(delim)])
                for line in lines if line.strip()]
        if not hist:
            raise ValueError("empty coefficient history")
        return cls(weights=hist[-1], history=hist, converged=False,
                   iterations=len(hist))


class LogisticRegression:
    def __init__(self, learning_rate: float = 0.5, max_iterations: int = 200,
                 convergence: str = "average", threshold_pct: float = 0.5,
                 l2: float = 0.0, mesh=None, device=None):
        if convergence not in ("all", "average"):
            raise ValueError("convergence must be 'all' or 'average'")
        self.learning_rate = learning_rate
        self.max_iterations = max_iterations
        self.convergence = convergence
        self.threshold_pct = threshold_pct
        self.l2 = l2
        self.mesh = mesh          # optional data mesh (parallel/mesh.py)
        self.device = resolve_device(device)

    def _f32(self, v: float) -> torch.Tensor:
        return torch.tensor(v, dtype=torch.float32, device=self.device)

    def fit(self, x, y, resume_from: Optional[LogisticRegressionModel] = None
            ) -> LogisticRegressionModel:
        """``x`` [N, D], ``y`` [N] in {0, 1} (numpy or tensors).
        ``resume_from`` continues a run from its last coefficient row, as
        the reference's driver restarts from the last line of its
        coefficient file.  Under a data mesh each iteration is
        ``collectives.sharded_lr_step`` over x and y split across it."""
        dev = self.device
        if is_wide(self.mesh):
            from avenir_tpu_torch.parallel.collectives import sharded_lr_step

            step = sharded_lr_step(self.mesh)
            xd, yd = place_batch(self.mesh, dev,
                                 *(torch.as_tensor(a, dtype=torch.float32)
                                   for a in (x, y)))
        else:
            step = _grad_step
            xd = torch.as_tensor(x).to(device=dev, dtype=torch.float32)
            yd = torch.as_tensor(y).to(device=dev, dtype=torch.float32)
        n, lr, l2 = self._f32(x.shape[0]), self._f32(self.learning_rate), \
            self._f32(self.l2)
        if resume_from is not None:
            w = torch.from_numpy(np.asarray(resume_from.weights,
                                            np.float32)).to(dev)
            history = list(resume_from.history)
        else:
            w = torch.zeros(xd.shape[1], dtype=torch.float32, device=dev)
            history = []
        converged = False
        with full_float32():
            for _ in range(self.max_iterations):
                w = step(w, xd, yd, n, lr, l2)
                # one [D] fetch per iteration by design: every iteration's weights
                # are the history the job writes, and the convergence test reads
                # them on the host
                # graftlint: disable=GL005
                cur = w.cpu().numpy()
                history.append(cur)
                if len(history) >= 2 and _converged(
                        history[-2], cur, self.convergence,
                        self.threshold_pct):
                    converged = True
                    break
        return LogisticRegressionModel(weights=w.cpu().numpy(),
                                       history=history, converged=converged,
                                       iterations=len(history))

    def fit_chunked(self, chunks: Sequence[Tuple[int, object, object]],
                    resume_from: Optional[LogisticRegressionModel] = None,
                    merge=None) -> LogisticRegressionModel:
        """Fit over design-matrix chunks ``(chunk_index, x [n_c, D],
        y [n_c])``, kept on the device across iterations.  Each chunk's
        gradient partial is float32 on the device, fetched as float64 and
        summed in global chunk-index order; the weights live in float64 on
        the host (the reducer's role).

        ``merge`` folds a ``{key: array}`` state across processes
        (``parallel/mesh.py::all_process_sum_state``; None in one
        process): in a fleet each process passes only the chunks it owns,
        and every iteration merges the per-chunk partials in one
        collective, keyed by chunk index, so the float64 addition order —
        and the whole history — is the same for any process count.  Every
        process must call this with the same settings."""
        from avenir_tpu_torch.core.config import ConfigError

        merge = merge if merge is not None else (
            lambda st: {k: np.asarray(v) for k, v in st.items()})
        dev = self.device
        dev_chunks = [
            (idx, torch.as_tensor(x).to(device=dev, dtype=torch.float32),
             torch.as_tensor(y).to(device=dev, dtype=torch.float32))
            for idx, x, y in chunks]
        local_n = sum(x.shape[0] for _, x, _ in dev_chunks)
        local_d = max((x.shape[1] for _, x, _ in dev_chunks), default=0)
        hand = merge({"n": np.array([local_n], np.int64),
                      "max:d": np.array([local_d], np.int64)})
        n_total = int(hand["n"][0])
        d = int(hand["max:d"][0])
        if n_total == 0:
            raise NoDataError("no data")
        for _, x, _ in dev_chunks:
            if x.shape[1] != d:
                raise ValueError(
                    f"chunk design width {x.shape[1]} != global width {d} — "
                    "schema mismatch across chunks/processes")
        for idx, _x, _y in dev_chunks:
            if idx >= 10 ** 8:
                # the gradient keys are 8-digit zero-padded and summed in
                # sorted order: a wider index would reorder the sum
                raise ConfigError(
                    f"chunk index {idx} exceeds the 8-digit gradient-key "
                    f"width; raise stream.chunk.rows")
        if resume_from is not None:
            w = np.asarray(resume_from.weights, np.float64)
            history = list(resume_from.history)
        else:
            w = np.zeros(d, np.float64)
            history = []
        converged = False
        with full_float32():
            for _ in range(self.max_iterations):
                wf = torch.from_numpy(w.astype(np.float32)).to(dev)
                # one fetch per chunk and iteration by design: the partials merge on
                # the host in float64, keyed by global chunk index, so a fleet's
                # history equals one process's bit for bit
                # graftlint: disable=GL005
                state = {f"g{idx:08d}": chunk_grad(wf, xd, yd).cpu().numpy(
                             ).astype(np.float64)
                         for idx, xd, yd in dev_chunks}
                tot = merge(state)
                grad = np.zeros(d, np.float64)
                for k in sorted(tot):                # global chunk order
                    grad = grad + tot[k]
                w = w + self.learning_rate * (grad / n_total - self.l2 * w)
                history.append(w.copy())
                if len(history) >= 2 and _converged(
                        history[-2], history[-1], self.convergence,
                        self.threshold_pct):
                    converged = True
                    break
        return LogisticRegressionModel(weights=w.copy(), history=history,
                                       converged=converged,
                                       iterations=len(history),
                                       n_rows=n_total)

    @staticmethod
    def predict_proba(model: LogisticRegressionModel, x: np.ndarray
                      ) -> np.ndarray:
        z = x @ model.weights
        return 1.0 / (1.0 + np.exp(-z))

    @staticmethod
    def predict_batch(model_or_weights, x, threshold: float = 0.5,
                      device=None) -> Tuple[np.ndarray, np.ndarray]:
        return predict_batch(model_or_weights, x, threshold=threshold,
                             device=device)

    @staticmethod
    def predict(model: LogisticRegressionModel, x: np.ndarray,
                threshold: float = 0.5) -> np.ndarray:
        return (LogisticRegression.predict_proba(model, x)
                >= threshold).astype(np.int32)
