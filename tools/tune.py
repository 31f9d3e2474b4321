"""Tuning harness: interleaved A/B comparisons of engine variants.

Comparisons are interleaved (utils/profiling.ab_compare) because a
device's effective speed drifts over minutes — two sequentially-measured
numbers are NOT comparable.  One process holds the device.  Ratios mean
something only on the GPU; with ``JAX_PLATFORMS=cpu`` the script is a
correctness smoke of the probes.

Usage (on the GPU host):
    python tools/tune.py stages 1024 256     # stage-split variants at N, B
    python tools/tune.py pad 10007 16        # Bluestein padding variants
    python tools/tune.py precision 1024 256  # matmul precision ladder
    python tools/tune.py split 3600 64 120x30 144x25   # explicit stage splits
    python tools/tune.py prec 1024 256 highest,high    # per-stage schemes
    python tools/tune.py nufft 4096 4096     # dense vs grid NUFFT at (n, M)
    python tools/tune.py sht 256 16          # Hermitian vs full SHT paths
    python tools/tune.py rader 1009 64       # Rader vs Bluestein (round 4)
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import os  # noqa: E402

import jax  # noqa: E402

from mixed_radix_fast_fourier_transform_tpu.ops.stockham import exec_complex  # noqa: E402
from mixed_radix_fast_fourier_transform_tpu.plan import build_complex_plan  # noqa: E402
from mixed_radix_fast_fourier_transform_tpu.utils.config import DEFAULT_CONFIG  # noqa: E402
from mixed_radix_fast_fourier_transform_tpu.utils.profiling import ab_compare  # noqa: E402

# SPECTRAL_TUNE_BFLY16=1: run all tune plans with butterfly="16" so split
# candidates with f=16 tails exercise the opt-in radix-16 butterfly form.
if os.environ.get("SPECTRAL_TUNE_BFLY16"):
    DEFAULT_CONFIG = dataclasses.replace(DEFAULT_CONFIG, butterfly="16")


def _planes(n: int, b: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n)) + 1j * rng.standard_normal((b, n))
    return (
        jax.device_put(x.real.astype(np.float32)),
        jax.device_put(x.imag.astype(np.float32)),
    ), x


def _report(name_a, name_b, res):
    ra = [f"{t*1e6:.0f}" for t in res["a_seconds"]]
    rb = [f"{t*1e6:.0f}" for t in res["b_seconds"]]
    print(f"  {name_a} us: {ra}")
    print(f"  {name_b} us: {rb}")
    print(f"  median ratio {name_a}/{name_b}: {res['ratio_median']:.3f} "
          f"(>1 means {name_b} faster)")


def tune_stages(n: int, b: int):
    (xr, xi), _ = _planes(n, b)
    base = build_complex_plan(n, -1, DEFAULT_CONFIG)
    print(f"baseline factors: {base.factors}")
    for max_stage in (32, 64, 128, 256):
        cfg = dataclasses.replace(DEFAULT_CONFIG, max_stage=max_stage)
        try:
            plan = build_complex_plan(n, -1, cfg)
        except ValueError:
            continue
        if plan.factors == base.factors:
            continue
        res = ab_compare(
            lambda a, c: exec_complex(base, a, c),
            lambda a, c, p=plan: exec_complex(p, a, c),
            (xr, xi), rounds=5,
        )
        print(f"vs max_stage={max_stage} {plan.factors}:")
        _report("base", str(plan.factors), res)


def tune_pad(n: int, b: int):
    (xr, xi), _ = _planes(n, b)
    plans = {}
    for mode in ("pow2", "pow23", "fast"):
        cfg = dataclasses.replace(DEFAULT_CONFIG, pad_mode=mode)
        plans[mode] = build_complex_plan(n, -1, cfg)
        print(f"{mode}: m={getattr(plans[mode], 'm', None)}")
    for mode in ("pow23", "fast"):
        res = ab_compare(
            lambda a, c: exec_complex(plans["pow2"], a, c),
            lambda a, c, p=plans[mode]: exec_complex(p, a, c),
            (xr, xi), short=50, long=250, rounds=5,
        )
        print(f"pow2 vs {mode}:")
        _report("pow2", mode, res)


def tune_precision(n: int, b: int):
    (xr, xi), x = _planes(n, b)
    want = np.fft.fft(x, axis=-1)
    plans = {}
    for prec in ("highest", "high", "default"):
        cfg = dataclasses.replace(DEFAULT_CONFIG, precision=prec)
        plans[prec] = build_complex_plan(n, -1, cfg)
        zr, zi = jax.jit(lambda a, c, p=plans[prec]: exec_complex(p, a, c))(xr, xi)
        got = np.asarray(zr) + 1j * np.asarray(zi)
        print(f"{prec}: err {np.max(np.abs(got-want))/np.max(np.abs(want)):.2e}")
    for prec in ("high", "default"):
        res = ab_compare(
            lambda a, c: exec_complex(plans["highest"], a, c),
            lambda a, c, p=plans[prec]: exec_complex(p, a, c),
            (xr, xi), rounds=5,
        )
        print(f"highest vs {prec}:")
        _report("highest", prec, res)





def tune_prec(n: int, b: int, cands):
    """Interleaved A/B of per-stage mixed-precision schemes vs all-HIGHEST.

    ``cands`` are comma-joined per-stage precision lists, e.g.
    "highest,high" (stage 0 HIGHEST, rest HIGH) or "high,highest".
    Prints max rel error vs fp64 numpy for each scheme alongside the speed
    ratio — the decision needs both columns (budget is 1e-5).
    """
    (xr, xi), x = _planes(n, b)
    want = np.fft.fft(x, axis=-1)
    scale = np.max(np.abs(want))
    base = build_complex_plan(n, -1, DEFAULT_CONFIG)
    print(f"N={n} b={b} factors={base.factors}")

    def err_of(plan):
        zr, zi = jax.jit(lambda a, c: exec_complex(plan, a, c))(xr, xi)
        got = np.asarray(zr) + 1j * np.asarray(zi)
        return np.max(np.abs(got - want)) / scale

    print(f"  all-highest: err {err_of(base):.2e}")
    for cand in cands:
        scheme = tuple(s.strip() for s in cand.split(","))
        cfg = dataclasses.replace(DEFAULT_CONFIG, precision=scheme)
        plan = build_complex_plan(n, -1, cfg)
        print(f"scheme {scheme}: err {err_of(plan):.2e}")
        res = ab_compare(
            lambda a, c: exec_complex(base, a, c),
            lambda a, c, p=plan: exec_complex(p, a, c),
            (xr, xi), short=min(500, max(50, 700_000 // n)),
            long=5 * min(500, max(50, 700_000 // n)), rounds=5,
        )
        _report("all-highest", cand, res)


def tune_split(n: int, b: int, cands):
    """Interleaved A/B of explicit stage splits vs the default plan at (n, b).

    ``cands`` are strings like "120x30" or "128x96x2" (product must equal n).
    Forces the split by monkeypatching plan_stages for the one build call.
    """
    import mixed_radix_fast_fourier_transform_tpu.plan as P

    orig = P.plan_stages

    def plan_with(stages):
        P.plan_stages = (
            lambda nn, ms, strategy="balanced": tuple(stages)
            if (stages and nn == n)
            else orig(nn, ms, strategy)
        )
        try:
            P.clear_plan_cache()
            return P.build_complex_plan(n, -1, DEFAULT_CONFIG)
        finally:
            P.plan_stages = orig

    (xr, xi), _ = _planes(n, b)
    base = plan_with(None)
    print(f"N={n} b={b} base factors: {base.factors}")
    for cand in cands:
        stages = tuple(int(s) for s in cand.lower().split("x"))
        assert np.prod(stages) == n, f"{stages} does not multiply to {n}"
        plan = plan_with(stages)
        short, rounds = _ab_knobs(min(500, max(50, 700_000 // n)), 5)
        res = ab_compare(
            lambda a, c: exec_complex(base, a, c),
            lambda a, c, p=plan: exec_complex(p, a, c),
            (xr, xi), short=short, long=5 * short, rounds=rounds,
        )
        print(f"vs {stages}:")
        _report("base", str(stages), res)


def tune_butterfly(n: int, b: int):
    """Small-stage butterfly A/B at a pow2 length whose plan carries a 2/4
    remainder stage (n=65536 → (128,128,4)).  Variants: the default matmul
    plan; the remainder moved to the FRONT factor (executes as the final
    combine — both big stages then run 128-wide minormost matmuls); and each
    ordering with the 2/4 stage as an elementwise butterfly
    (plan.butterfly=True)."""
    import mixed_radix_fast_fourier_transform_tpu.plan as P

    orig = P.plan_stages

    def plan_with(stages, butterfly=False):
        if stages is not None:
            P.plan_stages = (
                lambda nn, ms, strategy="balanced": tuple(stages)
                if nn == n
                else orig(nn, ms, strategy)
            )
        try:
            P.clear_plan_cache()
            plan = P.build_complex_plan(n, -1, DEFAULT_CONFIG)
        finally:
            P.plan_stages = orig
        # explicit both ways — the default config may carry butterfly="auto"
        return dataclasses.replace(plan, butterfly=butterfly)

    (xr, xi), x = _planes(n, b)
    base = plan_with(None)
    want = np.fft.fft(x)
    if 16 in base.factors:
        # radix-16 probe: matmul-16 (auto: 16 > butterfly_max=8) vs the
        # opt-in _bfly16 form at the default split
        p16 = dataclasses.replace(
            plan_with(None, butterfly=True), butterfly_max=16
        )
        cands = [
            ("bfly-to-8", plan_with(None, butterfly=True)),
            ("bfly-to-16", p16),
        ]
    else:
        small = [f for f in base.factors if f in (2, 4, 8)]
        if not small:
            print(f"N={n} default factors {base.factors} have no small stage")
            return
        tail = small[0]
        front = tuple([tail] + [f for f in base.factors if f != tail])
        cands = [
            ("front-matmul", plan_with(front)),
            ("tail-bfly", plan_with(None, butterfly=True)),
            ("front-bfly", plan_with(front, butterfly=True)),
        ]
    short, rounds = _ab_knobs(min(500, max(50, 700_000 // n)), 5)
    print(f"N={n} b={b} base factors: {base.factors}")
    for name, plan in cands:
        gr, gi = jax.jit(lambda a, c, p=plan: exec_complex(p, a, c))(xr, xi)
        err = float(
            np.max(np.abs(np.asarray(gr) + 1j * np.asarray(gi) - want))
            / np.max(np.abs(want))
        )
        print(f"{name}: rel err vs fp64 {err:.2e}")
        res = ab_compare(
            lambda a, c: exec_complex(base, a, c),
            lambda a, c, p=plan: exec_complex(p, a, c),
            (xr, xi), short=short, long=5 * short, rounds=rounds,
        )
        _report("base", name, res)


def tune_nufft(n: int, m: int):
    """Dense vs grid NUFFT A/B at (n modes, m points) + grid-vs-dense err
    (the dispatch-threshold probe, on fp32 planes)."""
    import jax.numpy as jnp

    from mixed_radix_fast_fourier_transform_tpu.ops import nufft as nf

    rng = np.random.default_rng(0)
    x = jax.device_put(rng.uniform(0, 2 * np.pi, m).astype(np.float32))
    cr = jax.device_put(rng.standard_normal(m).astype(np.float32))
    ci = jax.device_put(rng.standard_normal(m).astype(np.float32))

    def t1(method):
        def g(a, c):
            out = nf.nufft1(x, jax.lax.complex(a, c), n, method=method)

            def fit(v):  # match the input shape for the timing chain
                v = v.reshape(-1)
                pad = max(0, m - v.shape[0])
                return jnp.concatenate([v, jnp.zeros(pad, v.dtype)])[:m]

            return fit(jnp.real(out)), fit(jnp.imag(out))
        return g

    zr, zi = jax.jit(t1("grid"))(cr, ci)
    wr, wi = jax.jit(t1("dense"))(cr, ci)
    g = np.asarray(zr) + 1j * np.asarray(zi)
    w = np.asarray(wr) + 1j * np.asarray(wi)
    print(f"grid-vs-dense err: {np.max(np.abs(g - w)) / np.max(np.abs(w)):.2e}")
    res = ab_compare(t1("dense"), t1("grid"), (cr, ci), short=50, long=250,
                     rounds=5)
    _report("dense", "grid", res)


def tune_sortspread(n: int, m: int, ndim: int = 1):
    """Sorted-segment vs block-matmul spreading A/B at (n modes/axis, m
    points) — sets _SORTED_MIN_M / _SORTED_MIN_M_2D."""
    import jax.numpy as jnp

    from mixed_radix_fast_fourier_transform_tpu.ops import nufft as nf

    rng = np.random.default_rng(0)
    x = jax.device_put(rng.uniform(0, 2 * np.pi, m).astype(np.float32))
    y = jax.device_put(rng.uniform(0, 2 * np.pi, m).astype(np.float32))
    cr = jax.device_put(rng.standard_normal(m).astype(np.float32))
    ci = jax.device_put(rng.standard_normal(m).astype(np.float32))
    mr, tau, msp = nf._grid_params(n, 1e-6)
    # force the auto paths onto the block branch; sorted called directly
    nf._SORTED_MIN_M = nf._SORTED_MIN_M_2D = 1 << 62

    def fit(v, mm):
        v = v.reshape(-1)
        pad = max(0, mm - v.shape[0])
        return jnp.concatenate([v, jnp.zeros(pad, v.dtype)])[:mm]

    if ndim == 1:

        def block(a, c):
            g = nf._spread(x, jax.lax.complex(a, c), mr, tau, msp)
            return fit(jnp.real(g), m), fit(jnp.imag(g), m)

        def srt(a, c):
            g = nf._spread_sorted(x, jax.lax.complex(a, c), mr, tau, msp)
            return fit(jnp.real(g), m), fit(jnp.imag(g), m)
    else:
        mrs, taus = (mr, mr), (tau, tau)

        def block(a, c):
            g = nf._spread_2d(x, y, jax.lax.complex(a, c), mrs, taus, msp)
            return fit(jnp.real(g), m), fit(jnp.imag(g), m)

        def srt(a, c):
            g = nf._spread_sorted_2d(
                x, y, jax.lax.complex(a, c), mrs, taus, msp
            )
            return fit(jnp.real(g), m), fit(jnp.imag(g), m)

    zr, _ = jax.jit(block)(cr, ci)
    wr, _ = jax.jit(srt)(cr, ci)
    print(f"mr={mr} msp={msp} block-vs-sorted re-plane err: "
          f"{np.max(np.abs(np.asarray(zr) - np.asarray(wr))):.2e}")
    res = ab_compare(block, srt, (cr, ci), short=20, long=100, rounds=5)
    _report("block", "sorted", res)


def _ab_knobs(short: int, rounds: int):
    """Env overrides for heavyweight probes: SPECTRAL_TUNE_SHORT /
    SPECTRAL_TUNE_ROUNDS.  Heavy composite probes (sht) trace and compile
    expensive programs, so rounds must be cuttable without editing the
    file."""
    s = int(os.environ.get("SPECTRAL_TUNE_SHORT", short))
    r = int(os.environ.get("SPECTRAL_TUNE_ROUNDS", rounds))
    return s, r


def tune_sht(L: int, b: int):
    """Hermitian vs full-path SHT round-trip A/B at band limit L."""
    import jax.numpy as jnp

    import mixed_radix_fast_fourier_transform_tpu as spp

    rng = np.random.default_rng(0)
    f0 = jax.device_put(rng.standard_normal((b, L, 2 * L)).astype(np.float32))

    def rt_fast(g):
        return (spp.isht(spp.sht(g), real_output=True).astype(jnp.float32),)

    def rt_full(g):
        return (jnp.real(
            spp.isht(spp.sht(g.astype(jnp.complex64)))
        ).astype(jnp.float32),)

    sh, rd = _ab_knobs(20, 5)
    res = ab_compare(rt_full, rt_fast, (f0,), short=sh, long=5 * sh, rounds=rd)
    _report("full", "hermitian", res)


def tune_builtin(n: int, b: int):
    """Interleaved A/B vs XLA's builtin jnp.fft.fft at (n, b)."""
    import jax.numpy as jnp

    (xr, xi), x = _planes(n, b)
    plan = build_complex_plan(n, -1, DEFAULT_CONFIG)

    def builtin(a, c):
        z = jnp.fft.fft(jax.lax.complex(a, c))
        return jnp.real(z), jnp.imag(z)

    ours = lambda a, c: exec_complex(plan, a, c)
    res = ab_compare(builtin, ours, (xr, xi), short=500, long=2500, rounds=5)
    print(f"factors={plan.factors}")
    _report("builtin", "ours", res)


def tune_matmul_form(n: int, b: int):
    """Stacked vs Karatsuba stage-matmul forms at (n, b) by flipping the
    crossover threshold (ops/stockham.KARATSUBA_MIN_STAGE)."""
    from mixed_radix_fast_fourier_transform_tpu.ops import stockham as st

    (xr, xi), x = _planes(n, b)
    plan = build_complex_plan(n, -1, DEFAULT_CONFIG)
    print(f"factors={plan.factors}  crossover={st.KARATSUBA_MIN_STAGE}")

    def with_threshold(t):
        def fn(a, c):
            old = st.KARATSUBA_MIN_STAGE
            st.KARATSUBA_MIN_STAGE = t
            try:
                return exec_complex(plan, a, c)
            finally:
                st.KARATSUBA_MIN_STAGE = old
        return fn

    res = ab_compare(with_threshold(10**9), with_threshold(1), (xr, xi),
                     short=500, long=2500, rounds=5)
    _report("stacked", "karatsuba", res)


def tune_rader(n: int, b: int):
    """Rader vs Bluestein at a prime n with smooth n-1 (round-4 A/B)."""
    from mixed_radix_fast_fourier_transform_tpu.utils.config import SpectralConfig

    (xr, xi), _ = _planes(n, b)
    rader = build_complex_plan(n, -1, DEFAULT_CONFIG)
    blue = build_complex_plan(n, -1, SpectralConfig(rader="off"))
    print(f"rader inner={getattr(rader.inner, 'factors', None)}  "
          f"bluestein m={getattr(blue, 'm', None)}")
    res = ab_compare(lambda a, c: exec_complex(blue, a, c),
                     lambda a, c: exec_complex(rader, a, c),
                     (xr, xi), short=200, long=1000, rounds=5)
    _report("bluestein", "rader", res)


if __name__ == "__main__":
    which = sys.argv[1] if len(sys.argv) > 1 else "stages"
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 1024
    b = int(sys.argv[3]) if len(sys.argv) > 3 else 256
    if which == "split":
        tune_split(n, b, sys.argv[4:])
    elif which == "prec":
        tune_prec(n, b, sys.argv[4:])
    elif which == "sortspread":
        tune_sortspread(n, b, int(sys.argv[4]) if len(sys.argv) > 4 else 1)
    else:
        {"stages": tune_stages, "pad": tune_pad, "builtin": tune_builtin,
         "precision": tune_precision,
         "matmul_form": tune_matmul_form, "nufft": tune_nufft,
         "rader": tune_rader, "butterfly": tune_butterfly,
         "sht": tune_sht}[which](n, b)
