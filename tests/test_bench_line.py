"""bench.py prints one JSON line that must stay short enough to read from
the end of a run's output.  These tests pin that contract: the final line
stays under bench.COMPACT_LINE_BUDGET (1600) in the worst case — every
config erroring with a full-length truncated message.  They also pin the
peak table and the refusal to run without a GPU."""

import json

import pytest

import bench


def _worst_headline():
    return {
        "metric": "batched_fft_gflops_n1024_fp32",
        "value": 99999.99,
        "unit": "GFLOP/s",
        "vs_baseline": 11764.705,
        "platform": "gpu",
        "device_kind": "NVIDIA H100 80GB HBM3",
        "device_count": 1,
        "card": "NVIDIA H100 80GB HBM3, 700.00 W",
        "max_rel_err": 9.99e-05,
        "error_budget_ok": False,
        "pct_fp32_peak_n32768": 100.0,
        "pct_fp32_peak_n65536": 100.0,
        "detail_file": bench.DETAIL_FILE,
    }


def test_budget_all_configs_erroring():
    # worst case: every runner fails with the longest message main() stores
    names = [name for name, _ in bench._runners()]
    assert len(names) >= 25  # the r4 inventory; guards accidental shrink
    compact = {n: "err:" + "x" * 40 for n in names}
    line = bench.compose_line(_worst_headline(), compact)
    assert len(line) <= bench.COMPACT_LINE_BUDGET
    parsed = json.loads(line)  # stays valid JSON after trimming
    assert parsed["metric"] == "batched_fft_gflops_n1024_fp32"


def test_budget_full_numeric_run():
    # the happy path: every config records a 4-significant-digit scalar
    names = [name for name, _ in bench._runners()]
    compact = {n: bench._compact(12345.6789) for n in names}
    line = bench.compose_line(_worst_headline(), compact)
    assert len(line) <= bench.COMPACT_LINE_BUDGET
    parsed = json.loads(line)
    # the full numeric run must fit WITHOUT dropping any config
    assert "_dropped" not in parsed["configs"]
    assert len(parsed["configs"]) == len(names)


def test_compact_scalars():
    assert bench._compact(123456.789) == 123500.0  # 4 sig figs
    assert bench._compact(1.23456e-7) == 1.235e-7
    assert bench._compact(float("nan")) is None  # NaN is not valid JSON
    assert bench._compact(True) is True
    assert bench._compact("lost") == "lost"


def test_compose_line_drops_tail_first():
    # priority order: when trimming, the FIRST configs must survive
    headline = _worst_headline()
    compact = {f"cfg{i:03d}": "err:" + "y" * 40 for i in range(60)}
    line = bench.compose_line(headline, compact)
    assert len(line) <= bench.COMPACT_LINE_BUDGET
    parsed = json.loads(line)
    kept = [k for k in parsed["configs"] if k != "_dropped"]
    assert kept == [f"cfg{i:03d}" for i in range(len(kept))]
    assert parsed["configs"]["_dropped"] == 60 - len(kept)


@pytest.mark.parametrize("kind", ["NVIDIA H100 80GB HBM3", "NVIDIA H100 PCIe"])
def test_peak_table_known_h100(kind):
    peaks = bench.device_peaks(kind)
    assert peaks["hbm_gb"] == 80.0
    # tensor-core rates above the fp32 rate, bf16 twice TF32
    assert peaks["fp32_gflops"] < peaks["tf32_gflops"] < peaks["bf16_gflops"]
    assert peaks["bf16_gflops"] == pytest.approx(2 * peaks["tf32_gflops"],
                                                 rel=0.01)


def test_peak_table_sxm_row_matches_data_sheet():
    sxm = bench.device_peaks("NVIDIA H100 80GB HBM3")
    assert sxm["fp32_gflops"] == 67_000.0
    assert sxm["hbm_gbps"] == 3_350.0


@pytest.mark.parametrize("kind", ["cpu", "Tesla V100-SXM2-16GB", "NVIDIA A100-SXM4-80GB",
                                  ""])
def test_peak_table_unknown_kind_raises(kind):
    with pytest.raises(ValueError, match="no published peaks"):
        bench.device_peaks(kind)


def test_bench_refuses_without_gpu(capsys):
    with pytest.raises(SystemExit) as ei:
        bench.main([])
    assert ei.value.code != 0
    out = capsys.readouterr()
    assert out.out == ""  # no device-metric names for a CPU run
    assert "no GPU" in out.err


def test_bench_config_pct_of_fp32_peak(monkeypatch):
    monkeypatch.setattr(bench, "device_peaks",
                        lambda kind: {"fp32_gflops": 1.0})
    stats, err = bench.bench_config(64, 2, 2)
    assert err <= 1e-5
    assert "pct_fp32_peak" in stats
    assert stats["pct_fp32_peak"] == pytest.approx(
        100.0 * stats["gflops_actual"], rel=1e-2)
