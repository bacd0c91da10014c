"""Roofline accounting: the attached card's peaks and achieved rates; port
of ``avenir_tpu/utils/roofline.py``.

A kernel time means little alone: each time is judged against the card's
ceiling, as achieved FLOP/s (compute-bound work) and/or bytes/s
(bandwidth-bound work) over the card's peak.  Peaks are the published
dense per-card figures keyed by the CUDA device name
(``torch.cuda.get_device_name``); an unknown CUDA card falls back to an
empirical probe (a chained bf16 matmul timed on the spot) with a
warning, so a share is never silently taken against another card's
peaks.  On the CPU every peak is 0 and callers leave the share out.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Optional

# Published dense peaks per card: bf16 FLOP/s, int8 OP/s, HBM bytes/s
# (NVIDIA H100 Tensor Core GPU data sheet; dense, without sparsity).
_PEAKS: Dict[str, Dict[str, float]] = {
    "H100 80GB HBM3": {"bf16_flops": 989e12, "int8_ops": 1979e12,
                       "hbm_bytes": 3.35e12},                    # SXM5
    "H100 PCIe": {"bf16_flops": 756e12, "int8_ops": 1513e12,
                  "hbm_bytes": 2.0e12},
    "H100 NVL": {"bf16_flops": 835e12, "int8_ops": 1671e12,
                 "hbm_bytes": 3.9e12},
}


def _lookup_row(kind: str) -> Optional[str]:
    """The table key for a device name: exact, then the longest key
    contained in the normalized name.  One-directional on purpose: a
    short or generic name ("nvidia") matched against the keys would take
    some other card's peaks, where the probe (with its warning) is right."""
    if kind in _PEAKS:
        return kind
    norm = kind.strip().lower()
    for key in sorted(_PEAKS, key=len, reverse=True):
        if key.lower() in norm:
            return key
    return None


def _lookup_peaks(kind: str) -> Optional[Dict[str, float]]:
    """The table row for a device name (see :func:`_lookup_row`), or
    None."""
    key = _lookup_row(kind)
    return None if key is None else _PEAKS[key]


def chip_peaks(device=None, probe_fallback: bool = True) -> Dict[str, float]:
    """``{"device_kind", "bf16_flops", "int8_ops", "hbm_bytes", "source"}``
    for ``device`` (``None`` means ``cuda``, and raises where there is
    none, as every entry point of the port does).

    ``source`` names where the peaks came from: ``table:<key>``, ``probe``
    (an unknown CUDA card, bf16 only) or ``none``.  The CPU reports peaks
    of 0, so callers skip the share rather than print a wrong one."""
    from avenir_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cpu":
        return {"device_kind": "cpu", "bf16_flops": 0.0, "int8_ops": 0.0,
                "hbm_bytes": 0.0, "source": "none"}
    import torch

    kind = torch.cuda.get_device_name(dev)
    key = _lookup_row(kind)
    if key is not None:
        return {"device_kind": kind, **_PEAKS[key], "source": f"table:{key}"}
    if probe_fallback:
        logging.getLogger("avenir_tpu_torch").warning(
            "unknown CUDA device %r: falling back to the empirical matmul "
            "probe (hbm_bytes unknown -> bandwidth roofline fields will be "
            "absent)", kind)
        return {"device_kind": kind, "bf16_flops": probe_matmul_flops(
            device=dev), "int8_ops": 0.0, "hbm_bytes": 0.0, "source": "probe"}
    return {"device_kind": kind, "bf16_flops": 0.0, "int8_ops": 0.0,
            "hbm_bytes": 0.0, "source": "none"}


def probe_matmul_flops(dim: int = 4096, iters: int = 30,
                       device=None) -> float:
    """Empirical bf16 matmul FLOP/s: ``iters`` chained square products
    x ← x·xᵀ (the library's GEMM: this measures the card, not a kernel of
    the port), the best of two chains, each timed between two CUDA events
    (``perf_counter`` on the CPU) after a warm call."""
    import numpy as np
    import torch

    from avenir_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    a = torch.from_numpy(np.random.default_rng(0).random(
        (dim, dim), dtype=np.float32)).to(dev).to(torch.bfloat16)

    def chain(n: int) -> float:
        x = a
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                x = torch.matmul(x, x.T)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        for _ in range(n):
            x = torch.matmul(x, x.T)
        return time.perf_counter() - t0

    chain(1)                                    # warm: handles, workspace
    best = min(chain(iters) for _ in range(2))
    return 2.0 * dim * dim * dim * iters / best


def mfu_fields(flops: Optional[float] = None, dt: Optional[float] = None,
               bytes_moved: Optional[float] = None,
               peaks: Optional[Dict[str, float]] = None,
               int8_ops: Optional[float] = None) -> Dict[str, float]:
    """Fields to merge into a result line: achieved FLOP/s and its share
    of the bf16 peak, achieved int8 OP/s and its share of the int8 peak,
    and/or achieved bytes/s and its share of the HBM peak, for work done
    in ``dt`` seconds.  ``peaks`` defaults to :func:`chip_peaks`."""
    out: Dict[str, float] = {}
    p = peaks or chip_peaks()
    out["device_kind"] = p["device_kind"]
    if flops and dt:
        out["achieved_tflops"] = round(flops / dt / 1e12, 2)
        if p["bf16_flops"]:
            out["mfu_pct"] = round(100.0 * flops / dt / p["bf16_flops"], 2)
    if int8_ops and dt:
        out["achieved_int8_tops"] = round(int8_ops / dt / 1e12, 2)
        if p.get("int8_ops"):
            out["int8_mxu_pct"] = round(
                100.0 * int8_ops / dt / p["int8_ops"], 2)
    if bytes_moved and dt:
        out["achieved_gbps"] = round(bytes_moved / dt / 1e9, 2)
        if p["hbm_bytes"]:
            out["hbm_pct"] = round(
                100.0 * bytes_moved / dt / p["hbm_bytes"], 2)
    return out
