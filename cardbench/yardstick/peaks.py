"""Published dense peaks of the cards the benchmark may run on.

A frozen copy of the table in ``avenir_tpu_torch/utils/roofline.py``
(NVIDIA H100 Tensor Core GPU data sheet; dense rates, without sparsity),
keyed by the name ``torch.cuda.get_device_name`` gives.  The rates assume
the card's full power limit; the run prints the limit beside them.
"""

from __future__ import annotations

from typing import Dict, Optional

PEAKS: Dict[str, Dict[str, float]] = {
    "H100 80GB HBM3": {"bf16_flops": 989e12, "int8_ops": 1979e12,
                       "hbm_bytes": 3.35e12},                    # SXM5
    "H100 PCIe": {"bf16_flops": 756e12, "int8_ops": 1513e12,
                  "hbm_bytes": 2.0e12},
    "H100 NVL": {"bf16_flops": 835e12, "int8_ops": 1671e12,
                 "hbm_bytes": 3.9e12},
}


def row_for(kind: str) -> Optional[str]:
    """The table key for a device name: exact, else the longest key the
    name contains (case-insensitive); None for a card the table lacks, so
    no share is ever taken against another card's peaks."""
    if kind in PEAKS:
        return kind
    norm = kind.strip().lower()
    for key in sorted(PEAKS, key=len, reverse=True):
        if key.lower() in norm:
            return key
    return None


def peaks_for(kind: str) -> Optional[Dict[str, float]]:
    key = row_for(kind)
    return None if key is None else PEAKS[key]
