"""The frozen yardstick: peaks, work counts, rates and percentiles, and
the reading of a profiler trace."""

import pytest

from cardbench.yardstick import peaks, stats, work
from cardbench.yardstick.trace import Trace, merge, short_name


def test_peaks_are_the_published_dense_rates():
    sxm = peaks.PEAKS["H100 80GB HBM3"]
    assert (sxm["bf16_flops"], sxm["int8_ops"], sxm["hbm_bytes"]) == (
        989e12, 1979e12, 3.35e12)
    assert peaks.PEAKS["H100 PCIe"]["hbm_bytes"] == 2.0e12
    assert peaks.PEAKS["H100 NVL"]["bf16_flops"] == 835e12


@pytest.mark.parametrize("kind,row", [
    ("NVIDIA H100 80GB HBM3", "H100 80GB HBM3"),
    ("H100 80GB HBM3", "H100 80GB HBM3"),
    ("NVIDIA H100 PCIe", "H100 PCIe"),
    ("NVIDIA H100 NVL", "H100 NVL"),
    ("NVIDIA A100-SXM4-80GB", None),
    ("nvidia", None),
])
def test_peak_row_by_device_name(kind, row):
    assert peaks.row_for(kind) == row


def test_b1_bytes_count_the_problem_not_the_layout():
    n_bins = [9, 13, 6, 4, 3, 4, 4, 4, 3, 4]
    cells = work.count_table_cells(n_bins, 2)
    pairs = sum(n_bins[i] * n_bins[j] for i in range(10)
                for j in range(i + 1, 10))
    assert cells == 2 * (sum(n_bins) + pairs)
    rows = 16_000_000
    assert work.b1_bytes(rows, n_bins, 2) == 4 * 10 * rows + 4 * rows \
        + 4 * cells


def test_knn_work_uses_the_used_lanes():
    assert work.knn_used_lanes(0, 0, 9) == 60
    assert work.knn_used_lanes(3, 5, 2) == 15 + 12 + 6
    assert work.knn_flops(4096, 1_000_000, 60) == 2 * 4096 * 1_000_000 * 60
    assert work.knn_bytes(4096, 1_000_000, 60, 10) == \
        2 * 60 * (4096 + 1_000_000) + 8 * 4096 * 10


def test_roofline_takes_the_larger_bound():
    # operations bound: 989e12 ops at 989e12 ops/s take 1 s
    assert work.roofline_pct(2.0, 989e12, 989e12, 3.35e12, 1e9) == \
        pytest.approx(50.0)
    # bytes bound, no operations counted
    assert work.roofline_pct(1.0, 1979e12, 0, 3.35e12, 3.35e12) == \
        pytest.approx(100.0)


def test_rate_over_every_unit_of_the_window():
    assert stats.rate([10, 10, 20], 100.0, 102.0) == 20.0
    with pytest.raises(ValueError):
        stats.rate([], 0.0, 1.0)


def test_percentile_by_nearest_rank_over_all_values():
    values = list(range(1, 101))
    assert stats.percentile(values, 95) == 95
    assert stats.percentile(values, 50) == 50
    assert stats.percentile([7.0], 95) == 7.0
    assert stats.percentile([3, 1, 2, 4], 95) == 4


def _events():
    def x(name, cat, ts, dur):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}

    return [
        x("cardbench.window", "user_annotation", 0.0, 100.0),
        x("aten::copy_", "cpu_op", 5.0, 20.0),
        x("scan", "user_annotation", 30.0, 60.0),
        x("void (anonymous namespace)::pair_kernel(Params)", "kernel",
          10.0, 10.0),
        x("void (anonymous namespace)::pair_kernel(Params)", "kernel",
          15.0, 10.0),
        x("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 50.0, 10.0),
        x("void other_kernel<8>(int*)", "kernel", 95.0, 10.0),
    ]


def test_trace_busy_idle_and_kernels():
    tr = Trace(_events())
    assert tr.window_s == pytest.approx(100e-6)
    assert merge([(10, 20), (15, 25), (50, 60)]) == [(10, 25), (50, 60)]
    assert tr.busy_s == pytest.approx((15 + 10 + 5) * 1e-6)   # clipped at 100
    assert tr.idle_pct() == pytest.approx(70.0)
    assert tr.kernel_s(r"\bpair_kernel\b") == pytest.approx(20e-6)
    assert len(tr.kernels(r"\bpair_kernel\b")) == 2
    assert tr.top_ops(2)[0] == ["pair_kernel", pytest.approx(20e-6)]


def test_trace_idle_gaps_by_host_activity():
    gaps = dict((k, v) for k, v in Trace(_events()).idle_by_host())
    # [0, 10): copy_ is open at 5 → 'aten::copy_'; [25, 50) and [60, 95)
    # inside 'scan'; the gap at [0,10) midpoint 5 lies in copy_
    assert gaps["aten::copy_"] == pytest.approx(10e-6)
    assert gaps["scan"] == pytest.approx((25 + 35) * 1e-6)


def test_device_only_trace_takes_the_host_window():
    events = [e for e in _events() if e["cat"] in ("kernel", "gpu_memcpy")]
    tr = Trace(events, window_s=200e-6)
    assert tr.window_s == pytest.approx(200e-6)
    assert tr.busy_s == pytest.approx((15 + 10 + 10) * 1e-6)


def test_short_names():
    assert short_name("void (anonymous namespace)::f<8>(int*, float)") \
        == "f<8>"
    assert short_name("void tourney_half_kernel<2, 4>(bf16 const*)") \
        == "tourney_half_kernel<2, 4>"
    assert short_name("Memcpy DtoH (Device -> Pageable)") == "Memcpy DtoH"
