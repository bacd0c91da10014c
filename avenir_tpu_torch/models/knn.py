"""k-nearest-neighbor engine — port of ``avenir_tpu/models/knn.py``.

Capability parity with the reference's kNN stack: the external all-pairs
distance job it outsources to sifarish ``SameTypeSimilarity``
(resource/knn.sh:47-60, per-attribute distances scaled to ints by
``distance.scale``), ``knn/NearestNeighbor.java`` (top ``top.match.count``
neighbors via secondary sort :317-349) and ``knn/Neighborhood.java``:
kernels none / linearMultiplicative / linearAdditive / gaussian,
class-conditional probability weighting, inverse-distance weighting,
classification by argmax, decision threshold or cost arbitration,
regression average / median / linear, and validation counters.

Three search routes, decided once a call by :func:`neighbor_route` with
the same gates on every device.  One loop over query tiles serves them
all (:func:`_search`): the queries normalised once, each tile uploaded,
the route's step enqueued, and after the loop one fetch.  Only the step
depends on the route:

- the sharded route when a ``mesh`` has a data axis of two or more
  devices and k fits a shard (the JAX package's gate): the references
  split over the axis, ``parallel/collectives.py::sharded_knn_topk``
  scans each block on its device and merges the candidates in shard
  order.  It follows the JAX package on every kind of mesh: each shard
  runs the tile scan, as the JAX package's sharded route runs no Pallas
  kernel on a TPU mesh either;
- the kernel route (:func:`_nearest_neighbors_kernel`) for the euclidean
  metric with k + 1 ≤ ``SLOTS``: ``ops/knn.search`` — query pack, B5
  (``csrc/knn_tourney.cu``) or B6 (``csrc/knn_topk.cu``) on ``cuda`` and
  their plain versions on the CPU, exact re-rank and certificate; after
  the fetch, rows whose certificate fails are served by the exact
  kernel, ``ops/knn.knn_exact`` (``csrc/knn_exact.cu``, its plain version
  on the CPU): every reference's exact d² in one pass;
- the exact scan: ``ops/knn.topk_over_tiles``, float32 distances by the
  norm expansion over reference tiles (TF32 off), merged into a running
  top-k.

The scan and sharded routes re-rank their candidates by the kernel
route's exact tail (``ops/knn.rerank_topk``), so all three order the
top-k by (exact distance, reference index), and a row's answer does not
depend on the route or the device.  The jobs' search mode "approx" runs
the exact route: the JAX package's ``approx_min_k`` is exact off the TPU,
and the port adds no approximate search.  Distances are true floats in
[0, 1]; the reference's ×1000 integer scaling is applied only in the
serde view.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from avenir_tpu_torch.core.encoding import EncodedDataset
from avenir_tpu_torch.device import resolve_device
from avenir_tpu_torch.ops import knn as kops
from avenir_tpu_torch.parallel.mesh import (device_put_sharded_batch,
                                            is_wide, pad_batch)
from avenir_tpu_torch.telemetry import spans as tel
from avenir_tpu_torch.utils.metrics import (ConfusionMatrix,
                                            CostBasedArbitrator, Counters)

KERNELS = ("none", "linearMultiplicative", "linearAdditive", "gaussian")


@dataclass
class KNNModel:
    """Reference set, with its packed operand and re-rank arrays cached
    per device."""

    codes: np.ndarray                   # [N, F] int32 categorical/binned codes
    cont: np.ndarray                    # [N, Fc] float32 raw continuous
    labels: Optional[np.ndarray]        # [N] class ids (classification)
    values: Optional[np.ndarray]        # [N] float regression targets
    class_probs: Optional[np.ndarray]   # [N, C] NB posteriors (class-cond weighting)
    n_bins: np.ndarray
    class_values: List[str]
    cont_lo: np.ndarray                 # [Fc] train min (normalization)
    cont_hi: np.ndarray                 # [Fc] train max

    @property
    def num_refs(self) -> int:
        return self.codes.shape[0] if self.codes.size else self.cont.shape[0]

    @property
    def num_bins(self) -> int:
        return int(self.n_bins.max()) if self.n_bins.size else 1

    def cont01(self) -> np.ndarray:
        """Train-range-normalized continuous columns (cached)."""
        c = self.__dict__.get("_cont01")
        if c is None:
            c = self.__dict__["_cont01"] = _normalize01(
                self.cont, self.cont_lo, self.cont_hi)
        return c

    def _cached(self, key, make):
        cache = self.__dict__.setdefault("_dev_cache", {})
        if key not in cache:
            cache[key] = make()
        return cache[key]

    def device_packed(self, device: torch.device) -> Tuple[torch.Tensor, int]:
        """Packed bf16 reference operand on ``device`` (cached: repeated
        queries must not re-pack or re-upload the reference set)."""
        def make():
            r_mat, n = kops.prepare_refs(self.codes, self.cont01(),
                                         self.num_bins)
            return r_mat.to(device), n
        return self._cached(("packed", str(device)), make)

    def device_rerank_arrays(self, device: torch.device):
        """Reference codes and normalized continuous columns on ``device``
        (cached), gathered by the search's exact re-rank."""
        return self._cached(("rerank", str(device)), lambda: (
            torch.from_numpy(self.codes).to(device),
            torch.from_numpy(self.cont01()).to(device)))

    def device_tiles(self, ref_tile: int, device: torch.device):
        """Reference set as resident [T, ref_tile, ·] tensors, padded to a
        whole number of tiles (pad rows masked by index in the scan)."""
        def make():
            n = self.num_refs
            t = max(-(-n // ref_tile), 1)
            pad = t * ref_tile - n
            codes = np.pad(self.codes, ((0, pad), (0, 0)))
            cont = np.pad(self.cont, ((0, pad), (0, 0)))
            return (torch.from_numpy(codes.reshape(t, ref_tile, -1)).to(device),
                    torch.from_numpy(cont.reshape(t, ref_tile, -1)).to(device))
        return self._cached(("tiles", ref_tile, str(device)), make)

    def device_sharded(self, mesh, ref_tile: int):
        """Reference codes and raw continuous columns split over ``mesh``'s
        data axis (cached per mesh and tile): padded to a whole number of
        ``ref_tile`` tiles a shard (−1 codes, 0.0 continuous; pad rows
        are masked by index in the scan), block i on the axis' i-th
        device."""
        def make():
            d = mesh.size("data")
            local = -(-_shard_rows(self.num_refs, d) // ref_tile) * ref_tile
            return device_put_sharded_batch(
                mesh, *pad_batch(local * d, self.codes, self.cont))
        return self._cached(("sharded", mesh, ref_tile), make)


def fit_knn(
    ds: EncodedDataset,
    values: Optional[np.ndarray] = None,
    class_probs: Optional[np.ndarray] = None,
) -> KNNModel:
    lo = ds.cont.min(axis=0) if ds.num_cont else np.zeros(0, np.float32)
    hi = ds.cont.max(axis=0) if ds.num_cont else np.zeros(0, np.float32)
    return KNNModel(
        codes=ds.codes, cont=ds.cont, labels=ds.labels,
        values=None if values is None else np.asarray(values, np.float32),
        class_probs=None if class_probs is None else np.asarray(class_probs, np.float32),
        n_bins=ds.n_bins, class_values=list(ds.class_values),
        cont_lo=lo.astype(np.float32), cont_hi=hi.astype(np.float32),
    )


# ---------------------------------------------------------------------------
# the search: one loop over query tiles, the route's step inside it
# ---------------------------------------------------------------------------

def _normalize01(cont: np.ndarray, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    span = np.maximum(hi - lo, 1e-9)
    return np.clip((cont - lo) / span, 0.0, 1.0).astype(np.float32)


def kernel_route(model: KNNModel, k: int, metric: str) -> bool:
    """The kernel route's gate, the same on every device and at every
    width: the euclidean metric, k + 1 candidate slots and at least k
    references."""
    return (metric == "euclidean" and k + 1 <= kops.SLOTS
            and min(k, model.num_refs) == k)


def _shard_rows(n: int, d_par: int) -> int:
    """ceil(n / d_par): a shard's real reference rows, read by the mesh
    gate and the sharded route alike."""
    return max(-(-n // d_par), 1)


def neighbor_route(model: KNNModel, k: int, metric: str,
                   device: torch.device, mesh=None) -> str:
    """The route :func:`nearest_neighbors` takes: ``sharded``, the kernel
    route's kernel as ``ops.knn.search`` picks it over the packed
    references (``b5`` or ``b6``), or the exact ``scan``."""
    if is_wide(mesh) and min(k, model.num_refs) <= _shard_rows(
            model.num_refs, mesh.size("data")):
        return "sharded"
    if not kernel_route(model, k, metric):
        return "scan"
    r_mat, n = model.device_packed(device)
    kk = min(k + kops.MARGIN, kops.SLOTS)
    return "b5" if kops.use_tourney(n, r_mat.shape[0], kk) else "b6"


def _nearest_neighbors_kernel(model: KNNModel, k: int, total_attrs: int,
                              device: torch.device):
    """The kernel route's step: fn(codes_q, cont01_q) of one query tile →
    ``ops.knn.search``'s ([m, k] distances, [m, k] indices, [m]
    certificate), enqueued.  Its attributes ``fallback_rows`` and
    ``last_fallback`` count the refused rows (:func:`_search`)."""
    r_mat, n = model.device_packed(device)
    codes_r, cont01_r = model.device_rerank_arrays(device)
    return lambda codes_q, cont01_q: kops.search(
        codes_q, cont01_q, r_mat, codes_r, cont01_r, n, model.num_bins, k,
        total_attrs)


_nearest_neighbors_kernel.fallback_rows = 0
_nearest_neighbors_kernel.last_fallback = np.zeros(0, np.int64)


def _scan_step(route: str, model: KNNModel, k: int, metric: str,
               ref_tile: int, total_attrs: int, device: torch.device, mesh):
    """The scan and sharded routes' step: fn(codes_q, cont01_q, cont_q) of
    one query tile → ([m, ≤ k] distances, their indices, [m] certificate,
    all True), enqueued in one ``knn.launch`` span.  The candidates are
    each row's k + MARGIN float32-nearest references: the tile scan
    (``ops.knn.topk_over_tiles``) over the resident tiles, or under a
    ``mesh`` each shard's, merged in shard order
    (``collectives.sharded_knn_topk``).  They are re-ranked by their
    exact distance sums (``ops.knn.rerank_topk``), as the kernel route
    re-ranks its own, so float32 rounding never reorders a row's
    neighbors."""
    n = model.num_refs
    lo = torch.from_numpy(model.cont_lo).to(device)
    hi = torch.from_numpy(model.cont_hi).to(device)
    codes_r, cont01_r = model.device_rerank_arrays(device)
    if route == "sharded":
        from avenir_tpu_torch.parallel import collectives

        shard = _shard_rows(n, mesh.size("data"))
        tile = min(ref_tile, shard)
        rc, rx = model.device_sharded(mesh, tile)
        topk = collectives.sharded_knn_topk(
            mesh, k=min(min(k, n) + kops.MARGIN, shard),
            num_bins=model.num_bins, metric=metric, ref_tile=tile)
        candidates = lambda c, x: topk(c, x, rc, rx, lo, hi, n)  # noqa: E731
    else:
        tile = min(ref_tile, max(-(-n // 8), 1024))   # ≤8 scan steps small-N
        rc_t, rx_t = model.device_tiles(tile, device)
        candidates = lambda c, x: kops.topk_over_tiles(  # noqa: E731
            c, x, rc_t, rx_t, n, lo, hi, min(k + kops.MARGIN, n),
            model.num_bins, metric)
    tracer = tel.tracer()

    def step(codes_q, cont01_q, cont_q):
        with tracer.span("knn.launch"):
            sums, idx = kops.rerank_topk(
                codes_q, cont01_q, codes_r, cont01_r,
                candidates(codes_q, cont_q)[1], k, metric)
            return (kops.distances(sums, total_attrs, metric), idx,
                    torch.ones(idx.shape[0], dtype=torch.bool, device=device))
    return step


def _search(route: str, model: KNNModel, test: EncodedDataset, k: int,
            metric: str, ref_tile: int, test_tile: int, device: torch.device,
            mesh) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`nearest_neighbors`'s answers by ``route``, which the caller
    decides once (:func:`neighbor_route`); only the step inside the loop
    over query tiles depends on it.  The rows whose certificate fails are
    served after the loop by the exact kernel (:func:`_exact_rows`): their
    count adds to ``_nearest_neighbors_kernel.fallback_rows``, and
    ``_nearest_neighbors_kernel.last_fallback`` holds this call's row
    indices.  Traced: the queries' normalisation and each tile's upload
    are ``knn.prep`` spans, the step's ``knn.prep`` and ``knn.launch``,
    the one fetch after the loop ``knn.fetch`` (attr ``bytes``), the exact
    kernel's call on the refused rows ``knn.fallback`` (attr ``rows``)."""
    if route == "sharded":
        device = mesh.axis_devices("data")[0]
    tracer = tel.tracer()
    total_attrs = test.codes.shape[1] + test.cont.shape[1]
    with tracer.span("knn.prep"):
        cont01_q = _normalize01(test.cont, model.cont_lo, model.cont_hi)
    if route in ("b5", "b6"):
        queries = (test.codes, cont01_q)
        step = _nearest_neighbors_kernel(model, k, total_attrs, device)
    else:
        # the tile scan normalises the raw continuous columns itself
        queries = (test.codes, cont01_q, test.cont)
        step = _scan_step(route, model, k, metric, ref_tile, total_attrs,
                          device, mesh)
    tiles = []
    for m0 in range(0, test.num_rows, test_tile):
        with tracer.span("knn.prep"):
            tile = [torch.from_numpy(a[m0:m0 + test_tile]).to(device)
                    for a in queries]
        tiles.append(step(*tile))
    with tracer.span("knn.fetch") as sp:
        # a lone tile's tensors cross as they are, with no copy on the card
        d, idx, cert = ((torch.cat(parts) if len(parts) > 1 else parts[0])
                        .cpu().numpy() for parts in zip(*tiles))
        sp.set("bytes", d.nbytes + idx.nbytes + cert.nbytes)
    rows = np.flatnonzero(~cert)
    _nearest_neighbors_kernel.fallback_rows += len(rows)
    _nearest_neighbors_kernel.last_fallback = rows
    if len(rows):
        # the candidate set might miss a true neighbor: recompute those
        # rows exactly over every reference
        with tracer.span("knn.fallback") as sp:
            sp.set("rows", len(rows))
            codes_r, cont01_r = model.device_rerank_arrays(device)
            d[rows], idx[rows] = _exact_rows(
                test.codes[rows], cont01_q[rows], codes_r, cont01_r, k,
                total_attrs, device)
    # degenerate tiny reference sets: keep the [M, k] shape
    return _pad_topk(d, idx, k, min(k, model.num_refs))


def _exact_rows(codes: np.ndarray, cont01: np.ndarray, codes_r: torch.Tensor,
                cont01_r: torch.Tensor, k: int, total_attrs: int,
                device: torch.device) -> Tuple[np.ndarray, np.ndarray]:
    """([R, k] distances, [R, k] int64 indices) on the host of the query
    rows ``codes`` [R, F] and normalized ``cont01`` [R, Fc] by
    ``ops.knn.knn_exact`` against the resident re-rank arrays: one upload
    (the codes and the continuous columns' bits side by side as int32),
    one kernel call, the [R, k] answers fetched.  ``ops.knn.distances``
    gives the same bits on every device, so it runs on the fetched d²:
    seven ops on a few rows, with no launch."""
    f = codes.shape[1]
    q = torch.from_numpy(np.concatenate(
        [codes.astype(np.int32), cont01.view(np.int32)], axis=1)).to(device)
    d2, idx = kops.knn_exact(q[:, :f], q[:, f:].view(torch.float32), codes_r,
                             cont01_r, k)
    return kops.distances(d2.cpu(), total_attrs).numpy(), idx.cpu().numpy()


def _pad_topk(d: np.ndarray, i: np.ndarray, k: int, k_eff: int
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Keep the [M, k] contract when the reference set has fewer than k
    rows: pad with +inf distances and -1 indices."""
    if k_eff < k:
        d = np.pad(d, ((0, 0), (0, k - k_eff)), constant_values=np.inf)
        i = np.pad(i, ((0, 0), (0, k - k_eff)), constant_values=-1)
    return d, i


def nearest_neighbors(
    model: KNNModel, test: EncodedDataset, k: int,
    metric: str = "euclidean", ref_tile: int = 65536, test_tile: int = 8192,
    device=None, mesh=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """([M, k] float32 distances, [M, k] int64 reference indices),
    ascending by (distance, index), on ``device`` (``cuda`` unless the
    caller asks for the CPU).  A ``mesh`` whose data axis spans two or
    more devices takes the sharded route where k fits a shard (the JAX
    package's gate); otherwise the kernel route serves the euclidean
    metric (:func:`kernel_route`), the exact scan everything else."""
    device = resolve_device(device)
    return _search(neighbor_route(model, k, metric, device, mesh), model,
                   test, k, metric, ref_tile, test_tile, device, mesh)


# ---------------------------------------------------------------------------
# neighborhood scoring
# ---------------------------------------------------------------------------

def kernel_weights(dists: np.ndarray, kernel: str, sigma: float = 0.3,
                   inverse_distance: bool = False) -> np.ndarray:
    """[M, k] vote weights from [0,1] distances (float forms of
    Neighborhood.java's integer-scaled kernels)."""
    if kernel == "none":
        w = np.ones_like(dists)
    elif kernel == "linearMultiplicative":
        w = 1.0 / np.maximum(dists, 5e-4)          # d==0 → 2×SCALE in the reference
    elif kernel == "linearAdditive":
        w = 1.0 - dists
    elif kernel == "gaussian":
        w = np.exp(-0.5 * (dists / max(sigma, 1e-6)) ** 2)
    else:
        raise ValueError(f"unknown kernel {kernel!r}; known: {KERNELS}")
    if inverse_distance and kernel not in ("linearMultiplicative",):
        w = w / np.maximum(dists, 5e-4)
    return w


@dataclass
class KNNResult:
    predicted: np.ndarray              # [M]
    class_scores: np.ndarray           # [M, C] normalized vote shares
    neighbor_idx: np.ndarray           # [M, k]
    neighbor_dist: np.ndarray          # [M, k]
    confusion: Optional[ConfusionMatrix] = None
    counters: Optional[Counters] = None


class KNN:
    """Estimator facade: classification + regression over a fitted model;
    ``device`` defaults to ``cuda``; an optional data ``mesh`` shards the
    reference set (:func:`nearest_neighbors`)."""

    def __init__(
        self,
        k: int = 5,
        metric: str = "euclidean",
        kernel: str = "none",
        kernel_sigma: float = 0.3,
        inverse_distance: bool = False,
        class_cond_weighting: bool = False,
        decision_threshold: Optional[float] = None,
        pos_class: Optional[str] = None,
        cost: Optional[np.ndarray] = None,
        ref_tile: int = 65536,
        test_tile: int = 8192,
        mesh=None,
        device=None,
    ):
        if kernel not in KERNELS:
            raise ValueError(f"unknown kernel {kernel!r}; known: {KERNELS}")
        self.k = k
        self.metric = metric
        self.kernel = kernel
        self.kernel_sigma = kernel_sigma
        self.inverse_distance = inverse_distance
        self.class_cond_weighting = class_cond_weighting
        self.decision_threshold = decision_threshold
        self.pos_class = pos_class
        self.cost = cost
        self.ref_tile = ref_tile
        self.test_tile = test_tile
        self.mesh = mesh
        self.device = resolve_device(device)

    def fit(self, ds: EncodedDataset, values: Optional[np.ndarray] = None,
            class_probs: Optional[np.ndarray] = None) -> KNNModel:
        return fit_knn(ds, values=values, class_probs=class_probs)

    def _neighbors(self, model: KNNModel, test: EncodedDataset):
        """(route, distances, indices) of :func:`nearest_neighbors`."""
        route = neighbor_route(model, self.k, self.metric, self.device,
                               self.mesh)
        return (route, *_search(route, model, test, self.k, self.metric,
                                self.ref_tile, self.test_tile, self.device,
                                self.mesh))

    # -- classification ------------------------------------------------------
    def predict(self, model: KNNModel, test: EncodedDataset,
                validate: bool = False) -> KNNResult:
        """Classify ``test``'s rows by their neighbours' votes.  Traced:
        one ``knn.predict`` span (attrs ``queries``, ``route``) around
        the search's spans and ``knn.vote``."""
        if model.labels is None:
            raise ValueError("classification requires labels in the reference set")
        tracer = tel.tracer()
        with tracer.span("knn.predict") as sp:
            sp.set("queries", test.num_rows)
            route, dists, idx = self._neighbors(model, test)
            sp.set("route", route)
            with tracer.span("knn.vote"):
                result = self._vote(model, dists, idx)
        if validate:
            if test.labels is None:
                raise ValueError("validation requires test labels")
            cm = ConfusionMatrix(model.class_values, pos_class=self.pos_class)
            cm.add_batch(test.labels, result.predicted)
            counters = Counters()
            cm.publish(counters)
            result.confusion = cm
            result.counters = counters
        return result

    def _vote(self, model: KNNModel, dists: np.ndarray,
              idx: np.ndarray) -> KNNResult:
        """Weights, class scores and the decision from the neighbours."""
        w = kernel_weights(dists, self.kernel, self.kernel_sigma, self.inverse_distance)
        neigh_labels = model.labels[idx]                        # [M, k]
        c = len(model.class_values)
        if self.class_cond_weighting:
            if model.class_probs is None:
                raise ValueError("class_cond_weighting requires class_probs in the model")
            post = np.take_along_axis(model.class_probs[idx], neigh_labels[..., None],
                                      axis=2)[..., 0]           # [M, k]
            w = w * post
        scores = np.zeros((dists.shape[0], c), np.float32)
        for cls in range(c):
            scores[:, cls] = (w * (neigh_labels == cls)).sum(axis=1)
        shares = scores / np.maximum(scores.sum(axis=1, keepdims=True), 1e-9)
        if self.cost is not None:
            predicted = CostBasedArbitrator(model.class_values, self.cost).arbitrate(shares)
        elif self.decision_threshold is not None:
            # binary pos-score threshold, as in NearestNeighbor.java:253-262
            if self.pos_class is None:
                raise ValueError("decision_threshold requires pos_class")
            if c != 2:
                raise ValueError("decision_threshold supports binary classification only")
            p = model.class_values.index(self.pos_class)
            predicted = np.where(shares[:, p] >= self.decision_threshold, p, 1 - p).astype(np.int32)
        else:
            predicted = np.argmax(shares, axis=1).astype(np.int32)
        return KNNResult(predicted=predicted, class_scores=shares,
                         neighbor_idx=idx, neighbor_dist=dists)

    # -- regression ----------------------------------------------------------
    def regress(self, model: KNNModel, test: EncodedDataset,
                method: str = "average",
                input_var: Optional[np.ndarray] = None,
                ref_input_var: Optional[np.ndarray] = None) -> np.ndarray:
        """[M] predictions. ``linear`` fits a per-test-record simple
        regression of neighbor target on ``ref_input_var`` evaluated at the
        test record's ``input_var`` (Neighborhood.java:244-250)."""
        if model.values is None:
            raise ValueError("regression requires target values in the model")
        _route, dists, idx = self._neighbors(model, test)
        vals = model.values[idx]                                # [M, k]
        if method == "average":
            w = kernel_weights(dists, self.kernel, self.kernel_sigma, self.inverse_distance)
            return (w * vals).sum(1) / np.maximum(w.sum(1), 1e-9)
        if method == "median":
            return np.median(vals, axis=1)
        if method == "linear":
            if input_var is None or ref_input_var is None:
                raise ValueError("linear regression requires input_var and ref_input_var")
            x = ref_input_var[idx].astype(np.float64)           # [M, k]
            y = vals.astype(np.float64)
            xm, ym = x.mean(1, keepdims=True), y.mean(1, keepdims=True)
            sxx = ((x - xm) ** 2).sum(1)
            sxy = ((x - xm) * (y - ym)).sum(1)
            slope = np.where(sxx > 1e-12, sxy / np.maximum(sxx, 1e-12), 0.0)
            intercept = ym[:, 0] - slope * xm[:, 0]
            return slope * np.asarray(input_var, np.float64) + intercept
        raise ValueError(f"unknown regression method {method!r}")


# ---------------------------------------------------------------------------
# all-pairs distance serde (the sifarish SameTypeSimilarity drop-in view)
# ---------------------------------------------------------------------------

def pairwise_distance_lines(
    model: KNNModel, test: EncodedDataset, test_ids: Sequence[str],
    k: int, distance_scale: int = 1000, delim: str = ",",
    metric: str = "euclidean", ref_ids: Optional[Sequence[str]] = None,
    device=None,
) -> List[str]:
    """(testID, refID, scaledIntDistance) rows — the record-pair distance
    file format the reference's pipeline stages exchange. ``ref_ids``
    defaults to reference-row indices."""
    dists, idx = nearest_neighbors(model, test, k, metric, device=device)
    if ref_ids is None:
        ref_ids = [str(i) for i in range(model.num_refs)]
    else:
        ref_ids = [str(r) for r in ref_ids]
    lines = []
    for m, tid in enumerate(test_ids):
        for j in range(k):
            lines.append(delim.join([
                str(tid), ref_ids[idx[m, j]], str(int(round(dists[m, j] * distance_scale)))]))
    return lines
