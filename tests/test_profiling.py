"""Roofline cost model + timing utilities."""

import jax.numpy as jnp
import numpy as np
import pytest

from mixed_radix_fast_fourier_transform_tpu.plan import get_plan
from mixed_radix_fast_fourier_transform_tpu.utils.profiling import (
    marginal_time,
    plan_cost,
    roofline_summary,
    trace,
)


class TestPlanCost:
    def test_mixed_radix_model(self):
        plan = get_plan(1024, -1, "complex")
        cost = plan_cost(plan)
        assert cost.n == 1024
        assert cost.fft_model_flops == 5 * 1024 * 10
        # stages (64, 16): the 64-stage is a stacked matmul (8·n·f) plus
        # one split-twiddle pass (6·n); the 16-tail runs as the radix-16
        # butterfly (11 real ops per point)
        assert plan.factors == (64, 16) and plan.butterfly
        assert cost.flops == 8 * 1024 * 64 + 6 * 1024 + 11 * 1024
        assert cost.arithmetic_intensity > 1.0

    def test_bluestein_model(self):
        # 10007 stays Bluestein (10006 = 2·5003 is not stage-smooth)
        plan = get_plan(10007, -1, "complex")
        cost = plan_cost(plan)
        assert cost.n == 10007
        inner = plan_cost(plan.inner)
        assert cost.flops > 2 * inner.flops

    def test_real_model(self):
        plan = get_plan(4096, -1, "real")
        cost = plan_cost(plan)
        assert cost.n == 4096
        assert cost.fft_model_flops == 2.5 * 4096 * 12


class TestTiming:
    def test_marginal_time_positive(self):
        x = jnp.ones((8, 128), jnp.float32)
        t = marginal_time(lambda a: (a * 2.0,), (x,), short=5, long=25, reps=1)
        assert 0 < t < 1.0

    def test_roofline_summary_keys(self):
        plan = get_plan(256, -1, "complex")
        s = roofline_summary(plan, 1e-5, 64)
        assert set(s) >= {"gflops_fft_model", "hbm_gbps_lower_bound", "seconds"}
        assert s["gflops_fft_model"] > 0

    def test_trace_noop_tolerant(self, tmp_path):
        with trace(str(tmp_path)):
            _ = jnp.sum(jnp.ones(8)).block_until_ready()
        assert list(tmp_path.rglob("*.xplane.pb"))

    def test_trace_raises_when_profiler_fails(self, tmp_path, monkeypatch):
        import jax

        def boom(*a, **k):
            raise RuntimeError("no profiler")

        monkeypatch.setattr(jax.profiler, "start_trace", boom)
        with pytest.raises(RuntimeError, match="no profiler"):
            with trace(str(tmp_path)):
                pass


class TestPlanPersistence:
    def test_manifest_roundtrip(self, tmp_path):
        from mixed_radix_fast_fourier_transform_tpu.plan import clear_plan_cache, get_plan
        from mixed_radix_fast_fourier_transform_tpu.utils.cache import (
            load_plans,
            save_plans,
            warm_plans,
        )

        clear_plan_cache()
        n_built = warm_plans([64, 360], kinds=("complex", "real"))
        assert n_built == 8
        path = str(tmp_path / "plans.npz")
        n_saved = save_plans(path)
        assert n_saved >= 8
        clear_plan_cache()
        assert load_plans(path) == n_saved


def test_estimate_four_step_hbm_config5():
    """BASELINE config 5 (65536-pt, batch 4096, 8 devices) fits an 80 GB
    card with margin."""
    from mixed_radix_fast_fourier_transform_tpu.utils.profiling import (
        HBMBudgetError,
        estimate_four_step_hbm,
        require_four_step_hbm,
    )

    b = estimate_four_step_hbm(65536, 4096, 8)
    assert b["per_copy_bytes"] == 4096 * 8192 * 2 * 4  # 256 MiB
    assert 1.0 < b["total_gb"] < 4.0
    assert require_four_step_hbm(65536, 4096, 8, limit_gb=80.0)["limit_gb"] == 80.0
    # and a shape that should NOT fit is rejected
    with pytest.raises(HBMBudgetError):
        require_four_step_hbm(1 << 22, 65536, 8, limit_gb=80.0)


class _FakeDevice:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize("limit_gib, fits", [(60.0, True), (1.0, False)])
def test_hbm_guard_reads_device_limit(limit_gib, fits):
    from mixed_radix_fast_fourier_transform_tpu.utils.profiling import (
        HBMBudgetError,
        require_four_step_hbm,
    )

    dev = _FakeDevice({"bytes_limit": int(limit_gib * 2**30),
                       "peak_bytes_in_use": 0})
    if fits:
        est = require_four_step_hbm(65536, 4096, 4, device=dev)
        assert est["limit_gb"] == pytest.approx(limit_gib)
    else:
        with pytest.raises(HBMBudgetError, match="budget 1 GB"):
            require_four_step_hbm(65536, 4096, 4, device=dev)


@pytest.mark.parametrize("stats", [None, {}, {"peak_bytes_in_use": 5}])
def test_hbm_guard_without_device_limit_needs_explicit_budget(stats):
    from mixed_radix_fast_fourier_transform_tpu.utils.profiling import (
        device_memory_limit_gb,
        require_four_step_hbm,
    )

    dev = _FakeDevice(stats)
    assert device_memory_limit_gb(dev) is None
    with pytest.raises(ValueError, match="limit_gb"):
        require_four_step_hbm(65536, 4096, 4, device=dev)
    # an explicit budget is used as given
    assert require_four_step_hbm(65536, 4096, 4, device=dev,
                                 limit_gb=16.0)["limit_gb"] == 16.0


def test_hbm_guard_on_cpu_backend_has_no_limit():
    import jax

    from mixed_radix_fast_fourier_transform_tpu.utils.profiling import (
        require_four_step_hbm,
    )

    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(ValueError, match="limit_gb"):
        require_four_step_hbm(4096, 8, 2)
