"""Profiling / observability: roofline cost models and device timing.

The reference has no tracing or profiling at all (SURVEY.md §5 — an unused
`#include "time.h"` is the entire story).  This module provides the
equivalents:

* :func:`plan_cost` — an analytic flop/byte model per plan (stage-by-stage),
  giving arithmetic intensity for roofline reasoning;
* :func:`marginal_time` — device timing that cancels the fixed
  per-dispatch overhead by differencing a short and a long on-device
  `lax.fori_loop` chain;
* :func:`trace` — a context manager around `jax.profiler.trace` for real
  profile captures;
* :func:`require_four_step_hbm` — a per-device memory guard for the
  distributed four-step, budgeted from the device's own memory limit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Callable, List, Optional, Tuple

import jax


@dataclasses.dataclass(frozen=True)
class PlanCost:
    """Per-transform (single batch element) cost model."""

    n: int
    flops: float          # real flops through the stage matmuls + twiddles
    hbm_bytes: float      # minimal HBM traffic (one read + one write per stage)
    fft_model_flops: float  # canonical 5·N·log2(N) accounting

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops / max(self.hbm_bytes, 1.0)


def _mixed_radix_cost(plan, dtype_bytes: int = 4) -> PlanCost:
    from ..ops.stockham import (  # lazy: avoid cycle
        BUTTERFLY_RADICES,
        KARATSUBA_MIN_STAGE,
    )

    n = plan.n
    flops = 0.0
    bytes_ = 0.0
    for i, f in enumerate(plan.factors):
        if (
            getattr(plan, "butterfly", False)
            and f in BUTTERFLY_RADICES
            and f <= getattr(plan, "butterfly_max", 8)
        ):
            # elementwise butterfly stage, real ops per complex point: radix-2
            # 4 adds/2 points = 2; radix-4 16 adds/4 points = 4; radix-8
            # 32+8 (two √½ twiddles)+16 combine = 56 ops/8 points = 7;
            # radix-16 two radix-8 halves + 7-twiddle combine = 11
            flops += {2: 2.0, 4: 4.0, 8: 7.0, 16: 11.0}[f] * n
            bytes_ += 4.0 * n * dtype_bytes
            continue
        # stage DFT matmul flops: stacked form (one 2f-contraction real
        # matmul) costs 8·n·f; the Karatsuba form used at f >= the
        # crossover costs 6·n·f (three matmuls instead of four)
        flops += (6.0 if f >= KARATSUBA_MIN_STAGE else 8.0) * n * f
        # split twiddle multiply (all but last stage): 6 flops per point
        if i < len(plan.factors) - 1:
            flops += 6.0 * n
        # per stage: read + write both planes once (the fused lower bound)
        bytes_ += 4.0 * n * dtype_bytes
    return PlanCost(
        n=n,
        flops=flops,
        hbm_bytes=bytes_,
        fft_model_flops=5.0 * n * math.log2(n) if n > 1 else 0.0,
    )


def plan_cost(plan, dtype_bytes: int = 4) -> PlanCost:
    """Analytic roofline model for any plan type."""
    from ..plan import (  # lazy: avoid cycle
        BluesteinPlan, MixedRadixPlan, RaderPlan, RealPlan,
    )

    if isinstance(plan, MixedRadixPlan):
        return _mixed_radix_cost(plan, dtype_bytes)
    if isinstance(plan, RaderPlan):
        inner = _mixed_radix_cost(plan.inner, dtype_bytes)
        # two inner (n−1) transforms + kernel multiply + x0 adds, and the
        # two permutation gathers (one read+write pass over both planes each)
        return PlanCost(
            n=plan.n,
            flops=2 * inner.flops + 6.0 * (plan.n - 1) + 4.0 * plan.n,
            hbm_bytes=2 * inner.hbm_bytes
            + 4.0 * (4.0 * plan.n) * dtype_bytes,
            fft_model_flops=5.0 * plan.n * math.log2(plan.n),
        )
    if isinstance(plan, BluesteinPlan):
        inner = _mixed_radix_cost(plan.inner, dtype_bytes)
        # two inner transforms + 3 pointwise passes over m, 1 over n
        return PlanCost(
            n=plan.n,
            flops=2 * inner.flops + 6.0 * (3 * plan.m + plan.n),
            hbm_bytes=2 * inner.hbm_bytes + 4.0 * (3 * plan.m + plan.n) * dtype_bytes,
            fft_model_flops=5.0 * plan.n * math.log2(plan.n),
        )
    if isinstance(plan, RealPlan):
        inner = plan_cost(plan.inner, dtype_bytes)
        return PlanCost(
            n=plan.n,
            flops=inner.flops + 10.0 * plan.n,
            hbm_bytes=inner.hbm_bytes + 3.0 * plan.n * dtype_bytes,
            fft_model_flops=2.5 * plan.n * math.log2(plan.n) if plan.n > 1 else 0.0,
        )
    raise TypeError(f"unknown plan type {type(plan)!r}")


def marginal_time(
    fn: Callable,
    args: Tuple,
    *,
    short: int = 100,
    long: int = 500,
    reps: int = 3,
) -> float:
    """Per-application device time of ``fn(*args) -> same-structure outputs``.

    Chains ``iters`` applications in one dispatched `lax.fori_loop` program
    (outputs feed back as inputs, scaled to stay bounded) and returns
    (T_long − T_short)/(long − short): fixed dispatch+transfer overhead
    cancels, leaving pure device time.  ``fn`` must map a tuple of arrays to
    a tuple of arrays of identical shapes/dtypes.

    Completion is forced by fetching a scalar reduction of the chain's
    output, a device→host value that depends on the whole computation.
    """
    import numpy as _np

    times = {}
    for iters in (short, long):
        def body(_, carry):
            out = fn(*carry)
            return tuple(o * o.dtype.type(1e-3) for o in out)

        def chain(*a):
            out = jax.lax.fori_loop(0, iters, body, tuple(a))
            return sum(jax.numpy.sum(o) for o in out)  # scalar: forces full exec

        g = jax.jit(chain)
        float(_np.asarray(g(*args)))  # compile + settle
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            float(_np.asarray(g(*args)))
            best = min(best, time.perf_counter() - t0)
        times[iters] = best
    return max((times[long] - times[short]) / (long - short), 1e-12)


def ab_compare(
    fn_a: Callable,
    fn_b: Callable,
    args: Tuple,
    *,
    short: int = 100,
    long: int = 500,
    rounds: int = 5,
) -> dict:
    """Interleaved A/B timing: measure marginal_time(A), marginal_time(B)
    back-to-back per round and report the per-round ratios.  The device's
    clock and thermal state drift over minutes, so only interleaved pairs
    are comparable — never two separate runs.  Returns
    {'a': [...], 'b': [...], 'ratio_median': float}, ratio > 1 meaning B is
    faster.
    """
    ta: List[float] = []
    tb: List[float] = []
    for _ in range(rounds):
        ta.append(marginal_time(fn_a, args, short=short, long=long, reps=1))
        tb.append(marginal_time(fn_b, args, short=short, long=long, reps=1))
    # a hiccup can make T_long < T_short, clamping a measurement to ~0 —
    # those pairs carry no information, drop them
    valid = [(a, b) for a, b in zip(ta, tb) if a > 1e-9 and b > 1e-9]
    if not valid:
        raise RuntimeError("all A/B rounds degenerate (timing hiccups)")
    ratios = sorted(a / b for a, b in valid)
    return {
        "a_seconds": ta,
        "b_seconds": tb,
        "ratio_median": ratios[len(ratios) // 2],
    }


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a jax.profiler trace to ``log_dir`` (view with TensorBoard /
    Perfetto).  A profiler that fails to start or stop raises."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def estimate_four_step_hbm(
    n: int, batch: int, parts: int, *, dtype_bytes: int = 4,
    copies: float = 6.0,
) -> dict:
    """Per-device memory footprint estimate for the distributed four-step
    FFT (transform length ``n``, total ``batch``, sharded over ``parts``
    devices on the sequence axis).

    Live per-device working set = batch · (n/parts) · 2 planes ·
    dtype_bytes; ``copies`` bounds the number of simultaneously-live copies
    XLA keeps (input, output, two all-to-all staging buffers, twiddle
    products, gradient shadow — 6 is conservative for the forward+backward
    step).  Plan constants (stage matrices + split twiddles,
    O(n/parts·f)) are counted separately.  Example: N=65536, batch=4096
    over 8 devices → 0.268 GB/copy, ~1.7 GB total."""
    shard = batch * (n // parts) * 2 * dtype_bytes
    # stage constants: sum of f_i^2 DFT matrices + (f_i, n_rem) twiddles,
    # bounded by 2·(n/parts)·max_stage entries per plane pair
    const = 4 * (n // parts) * 256 * dtype_bytes // 64  # ~n/parts·16 floats
    total = copies * shard + const
    return {
        "per_copy_bytes": shard,
        "plan_const_bytes": const,
        "total_bytes": int(total),
        "total_gb": round(total / 2**30, 3),
    }


class HBMBudgetError(ValueError):
    """A requested distributed transform exceeds the per-device memory budget.

    The typed analogue of the reference suite's malloc-failure path
    (test/test_mixedRadixFFT.cpp:243-259 fakes malloc to test
    allocation-failure handling): resource exhaustion is a *checked*,
    recoverable error at the API boundary, never an OOM mid-execution."""


def device_memory_limit_gb(device=None) -> Optional[float]:
    """The memory a JAX process may allocate on ``device`` (default: the
    first device), from ``memory_stats()["bytes_limit"]``; None when the
    device reports no limit (the CPU backend)."""
    device = device if device is not None else jax.devices()[0]
    stats = device.memory_stats() or {}
    limit = stats.get("bytes_limit")
    return None if limit is None else limit / 2**30


def require_four_step_hbm(
    n: int, batch: int, parts: int, *, limit_gb: Optional[float] = None,
    device=None, dtype_bytes: int = 4, copies: float = 6.0,
) -> dict:
    """Estimate the four-step working set and REJECT over-budget configs.

    The budget is ``limit_gb`` per device when given, else what ``device``
    (default: the first device) reports it may allocate.  A device that
    reports no limit (the CPU) needs an explicit ``limit_gb``: no memory
    size is assumed.  Returns the :func:`estimate_four_step_hbm` dict plus
    ``limit_gb`` when the config fits; raises
    :class:`HBMBudgetError` otherwise, naming the config and both numbers
    so callers can reshard instead of OOMing."""
    if limit_gb is None:
        limit_gb = device_memory_limit_gb(device)
        if limit_gb is None:
            raise ValueError(
                "the device reports no memory limit; pass limit_gb explicitly"
            )
    est = estimate_four_step_hbm(
        n, batch, parts, dtype_bytes=dtype_bytes, copies=copies
    )
    if est["total_gb"] > limit_gb:
        raise HBMBudgetError(
            f"distributed four-step n={n} batch={batch} over {parts} devices "
            f"needs ~{est['total_gb']} GB/device > budget {limit_gb:.3g} GB; "
            f"shard the batch further or raise parts"
        )
    return {**est, "limit_gb": limit_gb}


def roofline_summary(
    plan, measured_seconds: float, batch: int, *, dtype_bytes: int = 4
) -> dict:
    """Compare a measured per-application time against the plan's cost model."""
    cost = plan_cost(plan, dtype_bytes)
    return {
        "n": cost.n,
        "batch": batch,
        "seconds": measured_seconds,
        "gflops_fft_model": cost.fft_model_flops * batch / measured_seconds / 1e9,
        "gflops_actual": cost.flops * batch / measured_seconds / 1e9,
        "hbm_gbps_lower_bound": cost.hbm_bytes * batch / measured_seconds / 1e9,
        "arithmetic_intensity": cost.arithmetic_intensity,
    }
