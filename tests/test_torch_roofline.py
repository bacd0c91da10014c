"""The port's roofline accounting (``avenir_tpu_torch/utils/roofline.py``)
against the JAX package's (``avenir_tpu/utils/roofline.py``), on the CPU.

- ``_lookup_peaks`` answers as the JAX one over device names (exact,
  case-drifted, a longer name holding a key, a short name, an unknown
  name), both modules reading one shared table (monkeypatched);
- ``mfu_fields`` returns the JAX dict for the same explicit peaks over a
  grid of FLOPs, bytes, int8 operations and seconds, ``None`` and 0
  included;
- ``chip_peaks``: zero peaks on the CPU, a raise with no CUDA device, each
  H100 name on its own row, an unknown card's probe (with its warning) or
  zero peaks without it.
"""

import itertools
import logging

import pytest
import torch

from avenir_tpu.utils import roofline as jroofline
from avenir_tpu_torch.utils import roofline

# both modules' rows under one table, so the lookup rule alone differs
SHARED = {**roofline._PEAKS,
          "TPU v5 lite": {"bf16_flops": 197e12, "int8_ops": 394e12,
                          "hbm_bytes": 819e9},
          "TPU v5": {"bf16_flops": 459e12, "int8_ops": 918e12,
                     "hbm_bytes": 2765e9}}

KINDS = ["H100 PCIe",                   # exact
         "NVIDIA H100 80GB HBM3",       # longer name holding a key
         "nvidia h100 nvl",             # case drift
         "  NVIDIA H100 PCIe  ",        # padding
         "TPU v5 lite",                 # exact
         "tpu v5 lite",                 # case drift: the longer key wins
         "TPU v5p",                     # holds the shorter key
         "H100",                        # short: holds no key
         "nvidia",                      # generic
         "NVIDIA A100-SXM4-80GB",       # unknown card
         ""]


@pytest.mark.parametrize("kind", KINDS)
def test_lookup_peaks_equals_jax(kind, monkeypatch):
    monkeypatch.setattr(roofline, "_PEAKS", SHARED)
    monkeypatch.setattr(jroofline, "_PEAKS", SHARED)
    assert roofline._lookup_peaks(kind) == jroofline._lookup_peaks(kind)


PEAKS = {
    "h100": {"device_kind": "NVIDIA H100 80GB HBM3",
             **roofline._PEAKS["H100 80GB HBM3"]},
    "cpu": {"device_kind": "cpu", "bf16_flops": 0.0, "int8_ops": 0.0,
            "hbm_bytes": 0.0},
    "probed": {"device_kind": "NVIDIA X", "bf16_flops": 612.5e12,
               "int8_ops": 0.0, "hbm_bytes": 0.0},
}


@pytest.mark.parametrize("which", sorted(PEAKS))
def test_mfu_fields_equal_jax(which):
    peaks = PEAKS[which]
    grid = itertools.product((None, 0, 1e12, 137.4e9, 4.19e15),
                             (None, 0, 1e-6, 2.3e-4, 2.5),
                             (None, 0, 7e9, 3.35e6),
                             (None, 0, 5e12))
    n = 0
    for flops, dt, nbytes, int8 in grid:
        ours = roofline.mfu_fields(flops=flops, dt=dt, bytes_moved=nbytes,
                                   peaks=peaks, int8_ops=int8)
        want = jroofline.mfu_fields(flops=flops, dt=dt, bytes_moved=nbytes,
                                    peaks=peaks, int8_ops=int8)
        assert ours == want, (flops, dt, nbytes, int8)
        n += 1
    assert n == 5 * 5 * 4 * 3


@pytest.mark.parametrize("name,key", [
    ("NVIDIA H100 80GB HBM3", "H100 80GB HBM3"),
    ("NVIDIA H100 PCIe", "H100 PCIe"),
    ("NVIDIA H100 NVL", "H100 NVL")])
def test_each_h100_name_resolves_to_its_row(name, key, monkeypatch):
    assert roofline._lookup_row(name) == key
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None: name)
    peaks = roofline.chip_peaks()
    assert peaks == {"device_kind": name, **roofline._PEAKS[key],
                     "source": f"table:{key}"}


def test_h100_rows_hold_the_published_dense_peaks():
    assert roofline._PEAKS == {
        "H100 80GB HBM3": {"bf16_flops": 989e12, "int8_ops": 1979e12,
                           "hbm_bytes": 3.35e12},
        "H100 PCIe": {"bf16_flops": 756e12, "int8_ops": 1513e12,
                      "hbm_bytes": 2.0e12},
        "H100 NVL": {"bf16_flops": 835e12, "int8_ops": 1671e12,
                     "hbm_bytes": 3.9e12}}


def test_chip_peaks_cpu_is_zero_and_cuda_raises_without_a_card():
    peaks = roofline.chip_peaks(device="cpu")
    assert peaks == {"device_kind": "cpu", "bf16_flops": 0.0,
                     "int8_ops": 0.0, "hbm_bytes": 0.0, "source": "none"}
    # zero peaks: the share fields are left out, as on the JAX CPU backend
    assert roofline.mfu_fields(flops=1e12, dt=1.0, bytes_moved=1e9,
                               peaks=peaks) == {
        "device_kind": "cpu", "achieved_tflops": 1.0, "achieved_gbps": 1.0}
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is attached: chip_peaks() reads it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        roofline.chip_peaks()


def test_unknown_card_probes_with_a_warning_or_reads_zero(monkeypatch,
                                                          caplog):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda dev=None: "NVIDIA A100-SXM4-80GB")
    monkeypatch.setattr(roofline, "probe_matmul_flops",
                        lambda device=None: 312e12)
    with caplog.at_level(logging.WARNING, logger="avenir_tpu_torch"):
        peaks = roofline.chip_peaks()
    assert peaks == {"device_kind": "NVIDIA A100-SXM4-80GB",
                     "bf16_flops": 312e12, "int8_ops": 0.0,
                     "hbm_bytes": 0.0, "source": "probe"}
    assert "unknown CUDA device" in caplog.text
    assert roofline.chip_peaks(probe_fallback=False)["bf16_flops"] == 0.0


def test_probe_matmul_flops_runs_on_the_cpu():
    rate = roofline.probe_matmul_flops(dim=32, iters=3, device="cpu")
    assert rate > 0 and rate != float("inf")
