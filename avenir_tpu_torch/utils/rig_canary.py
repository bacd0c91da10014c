"""Rig-state canaries: bare library products on the card that separate
"the card is slow right now" from "a kernel regressed"; port of
``avenir_tpu/utils/rig_canary.py``.

Two reference timings, measured in the same process moments before the
numbers they stand beside:

- :func:`matmul_canary_ms`: a chained 4096 × 4096 × 4096 bf16 matmul
  (2·4096³ = 137.4 GFLOP a call, float32 accumulation).  cuBLAS and the
  card, no kernel of the port: if this is slow, the card is slow (shared,
  throttled, capped below its power limit).
- :func:`knn_dot_canary_ms`: the bare distance dot at the kNN serving
  shape ([16,384, 128] × [999,424, 128]ᵀ bf16, 4.19 TFLOP a call) with a
  running row max, in 16,384-row reference tiles.  If a kNN number drops
  while this stays put, the kernel regressed; if both drop by the same
  factor, the card did.

Timing: each step is one device program returning a 0-d carry that
chains into the next step's operand (data-dependent, scaled by 1e-30 so
it never moves the operand), so a chain is a strict dependency sequence
with nothing to sync inside it.  Each chain is timed between two CUDA
events on the card (``perf_counter`` on the CPU), after a short chain
and a full-length warm one; each point is the faster of two chains, and
the per-call time is the two-point slope ``(t_hi - t_lo) / (reps_hi -
reps_lo)``, which drops the chain's constant cost.  The JAX module's
reasons for this shape (a host fetch as its only barrier, a ~100 ms
round trip per fetch through its transport) do not apply on a local
card; the shape is kept so both canaries read the same quantity.

:data:`CANARY_HEALTHY_MS` is the bar the perf sentinel holds a reading
against (``telemetry/sentinel.py``).  The module imports only the
standard library at import time, so the sentinel stays stdlib-only.
"""

from __future__ import annotations

import time

MATMUL_DIM = 4096        # the matmul canary's default side (2·dim³ a call)
KNN_TILE = 16384         # reference rows a tile of the kNN dot canary

# A matmul canary reading above this reads "contended": twice the median
# healthy 4096³ reading on an NVIDIA H100 80GB HBM3 at 700 W, rounded up
# to 0.1 ms (the readings: PERF.md §6, from chip_smoke.py's canary phase).
CANARY_HEALTHY_MS = 0.5


def _normal_bf16(shape, seed: int, device):
    """Seeded standard normals in bf16, drawn on ``device``."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32).to(torch.bfloat16)


def dot_f32(x, y):
    """``x @ y`` of bf16 operands with float32 accumulation and a float32
    result (the JAX step's ``preferred_element_type=float32``): cuBLAS's
    mixed-output GEMM on the card, the product of the exactly widened
    operands on the CPU."""
    import torch

    if x.is_cuda:
        return torch.mm(x, y, out_dtype=torch.float32)
    return torch.mm(x.float(), y.float())


def matmul_step(a):
    """The matmul canary's step over ``a`` [dim, dim] bf16:
    ``(x, carry) -> ((x + carry) @ a)[0, 0] · 1e-30``."""
    import torch

    def step(x, carry):
        out = dot_f32(x + carry.to(torch.bfloat16), a)
        return out[0, 0] * 1e-30
    return step


def knn_dot_step(r_tiles):
    """The kNN dot canary's step over ``r_tiles`` [T, tile, width] bf16:
    ``(q, carry) -> (row max over every tile of (q + carry) @ rᵀ)[0] ·
    1e-30``, the [batch, tile] float32 product made one tile at a time."""
    import torch

    def step(x, carry):
        xq = x + carry.to(x.dtype)
        best = torch.full((x.shape[0],), float("-inf"), dtype=torch.float32,
                          device=x.device)
        for r in r_tiles:
            best = torch.maximum(best, dot_f32(xq, r.T).amax(dim=1))
        return best[0] * 1e-30
    return step


def _slope_ms(step_scalar, operand, reps_lo: int = 2,
              reps_hi: int = 10) -> float:
    """Per-call ms of ``step_scalar(operand, carry) -> 0-d carry`` by the
    two-point chained slope (see the module doc)."""
    import torch

    dev = operand.device

    def run(n: int) -> float:
        carry = torch.zeros((), dtype=torch.float32, device=dev)
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                carry = step_scalar(operand, carry)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        for _ in range(n):
            carry = step_scalar(operand, carry)
        float(carry)
        return time.perf_counter() - t0

    run(2)                  # first calls: library handles and workspaces
    run(reps_hi)            # a full-length warm chain
    # the faster of two chains a point: one stall in either chain would
    # collapse (or inflate) the slope
    t_lo = min(run(reps_lo) for _ in range(2))
    t_hi = min(run(reps_hi) for _ in range(2))
    return max((t_hi - t_lo) * 1e3 / (reps_hi - reps_lo), 0.0)


def matmul_canary_ms(dim: int = MATMUL_DIM, reps: int = 32,
                     device=None) -> float:
    """Chained ``dim³`` bf16 matmul, per-call ms (2·dim³ FLOPs a call) on
    ``device`` (``None`` means ``cuda``; ``"cpu"`` runs on the host)."""
    from avenir_tpu_torch.device import resolve_device

    a = _normal_bf16((dim, dim), 0, resolve_device(device))
    return _slope_ms(matmul_step(a), a, reps_lo=2, reps_hi=2 + reps)


def knn_dot_canary_ms(batch: int = 16384, n_refs: int = 1_000_000,
                      width: int = 128, reps: int = 8, refs=None,
                      device=None) -> float:
    """Chained bare distance dot at the kNN serving shape, per-call ms.

    ``refs`` may pass an existing [n_refs, width] bf16 tensor on the card
    (e.g. the packed reference matrix) so the canary reads the very buffer
    the kernel reads; by default a seeded one is drawn on ``device``.  The
    references are cut to whole :data:`KNN_TILE`-row tiles (999,424 of 1M
    at the default), each tile's [batch, tile] float32 product reduced to
    a running row max: 2·batch·(whole tiles' rows)·width FLOPs a call."""
    import torch

    from avenir_tpu_torch.device import resolve_device

    dev = refs.device if refs is not None and device is None \
        else resolve_device(device)
    if refs is None:
        refs = _normal_bf16((n_refs, width), 0, dev)
    refs = refs.to(device=dev, dtype=torch.bfloat16)
    n = refs.shape[0] - refs.shape[0] % KNN_TILE
    if n == 0:
        raise ValueError(f"knn_dot_canary_ms: {refs.shape[0]} references "
                         f"make no whole {KNN_TILE}-row tile")
    q = _normal_bf16((batch, refs.shape[1]), 1, dev)
    r_tiles = refs[:n].reshape(-1, KNN_TILE, refs.shape[1])
    return _slope_ms(knn_dot_step(r_tiles), q, reps_lo=1, reps_hi=1 + reps)
