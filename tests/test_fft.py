"""Complex FFT correctness vs the fp64 numpy oracle.

Oracle-based strategy (SURVEY.md §4): the reference's own GoogleTest suite
cannot compile and encodes admitted-wrong expectations, so golden values come
from numpy.fft (fp64).  Length coverage deliberately includes every class from
the reference's verified correctness matrix (SURVEY.md §2.9) — the sizes the
reference gets right, the sizes it gets WRONG (9, 12, 16, 36, 49, 60, 128,
360, 504, 1024, 5040, …), and the sizes where it crashes (1, 13, 257).
"""

import jax.numpy as jnp
import numpy as np
import pytest

import mixed_radix_fast_fourier_transform_tpu as sp

# fp32 error budget: target is <=1e-5 max rel err (BASELINE.md).
TOL = 1e-5

# Reference-correct sizes, reference-WRONG sizes, reference-CRASH sizes.
SIZES = [
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 12, 13, 15, 16, 17, 20, 24, 25, 32, 36,
    49, 60, 64, 100, 121, 128, 180, 256, 257, 360, 504, 512, 1009, 1024, 5040,
]
BIG_SIZES = [4096, 10007, 65536]


def _rel_err(got, want):
    got = np.asarray(got, dtype=np.complex128)
    want = np.asarray(want, dtype=np.complex128)
    denom = max(np.max(np.abs(want)), 1e-30)
    return np.max(np.abs(got - want)) / denom


def _rand_complex(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(
        np.complex64
    )


@pytest.mark.parametrize("n", SIZES)
def test_fft_matches_numpy(rng, n):
    x = _rand_complex(rng, (n,))
    got = sp.fft(x)
    want = np.fft.fft(x.astype(np.complex128))
    assert _rel_err(got, want) < TOL, f"N={n}"


@pytest.mark.parametrize("n", BIG_SIZES)
def test_fft_matches_numpy_big(rng, n):
    x = _rand_complex(rng, (n,))
    got = sp.fft(x)
    want = np.fft.fft(x.astype(np.complex128))
    assert _rel_err(got, want) < TOL, f"N={n}"


@pytest.mark.parametrize("n", [8, 15, 60, 360, 1009])
def test_ifft_roundtrip(rng, n):
    x = _rand_complex(rng, (n,))
    back = sp.ifft(sp.fft(x))
    assert _rel_err(back, x.astype(np.complex128)) < TOL


@pytest.mark.parametrize("n", [16, 360, 1009])
@pytest.mark.parametrize("norm", ["backward", "ortho", "forward"])
def test_norm_modes(rng, n, norm):
    x = _rand_complex(rng, (n,))
    got = sp.fft(x, norm=norm)
    want = np.fft.fft(x.astype(np.complex128), norm=norm)
    assert _rel_err(got, want) < TOL
    got_i = sp.ifft(np.asarray(got), norm=norm)
    assert _rel_err(got_i, x.astype(np.complex128)) < TOL


@pytest.mark.parametrize("batch", [(4,), (2, 3)])
def test_batched(rng, batch):
    n = 96
    x = _rand_complex(rng, batch + (n,))
    got = sp.fft(x)
    want = np.fft.fft(x.astype(np.complex128), axis=-1)
    assert _rel_err(got, want) < TOL


def test_axis_argument(rng):
    x = _rand_complex(rng, (12, 30, 5))
    got = sp.fft(x, axis=1)
    want = np.fft.fft(x.astype(np.complex128), axis=1)
    assert _rel_err(got, want) < TOL


def test_n_crop_and_pad(rng):
    x = _rand_complex(rng, (50,))
    for n in (20, 50, 81):
        got = sp.fft(x, n=n)
        want = np.fft.fft(x.astype(np.complex128), n=n)
        assert _rel_err(got, want) < TOL, f"n={n}"


def test_real_input_promoted(rng):
    x = rng.standard_normal(48).astype(np.float32)
    got = sp.fft(x)
    want = np.fft.fft(x.astype(np.float64))
    assert _rel_err(got, want) < TOL


def test_fft2_fftn(rng):
    x = _rand_complex(rng, (12, 20))
    assert _rel_err(sp.fft2(x), np.fft.fft2(x.astype(np.complex128))) < TOL
    x3 = _rand_complex(rng, (4, 6, 10))
    assert _rel_err(sp.fftn(x3), np.fft.fftn(x3.astype(np.complex128))) < TOL
    assert (
        _rel_err(sp.ifftn(np.asarray(sp.fftn(x3))), x3.astype(np.complex128)) < TOL
    )


def test_jit_and_grad(rng):
    """Transforms are jittable and differentiable — capabilities the C
    reference cannot have; autodiff must flow through the plan constants."""
    import jax
    import jax.numpy as jnp

    x = rng.standard_normal(360).astype(np.float32)

    @jax.jit
    def loss(v):
        return jnp.sum(jnp.abs(sp.fft(v)) ** 2)

    g = jax.grad(loss)(x)
    # Parseval: d/dx sum|FFT x|^2 = 2*N*x
    np.testing.assert_allclose(np.asarray(g), 2 * 360 * x, rtol=1e-4, atol=1e-3)


def test_helpers_match_numpy():
    for n in (8, 9):
        np.testing.assert_allclose(np.asarray(sp.fftfreq(n)), np.fft.fftfreq(n), atol=1e-7)
        np.testing.assert_allclose(
            np.asarray(sp.rfftfreq(n)), np.fft.rfftfreq(n), atol=1e-7
        )
        x = np.arange(n)
        np.testing.assert_array_equal(np.asarray(sp.fftshift(x)), np.fft.fftshift(x))
        np.testing.assert_array_equal(np.asarray(sp.ifftshift(x)), np.fft.ifftshift(x))


def test_invalid_args(rng):
    x = _rand_complex(rng, (8,))
    with pytest.raises(ValueError):
        sp.fft(x, n=0)
    with pytest.raises(ValueError):
        sp.fft(x, norm="nope")


@pytest.mark.parametrize("radix", [2, 3, 4, 5, 7, 8, 11, 13, 17, 53])
def test_single_radix_stage(rng, radix):
    """Single-stage dense-DFT 'butterfly' for each radix the reference
    hand-unrolls or handles generically (its parameterized butterfly tests,
    test_mixedRadixFFT.cpp:675-733) — here one plan = one stage matmul.
    Impulse and random inputs vs the fp64 oracle; radix 13 segfaults in the
    reference (twiddle_tables[13] OOB), correct here."""
    from mixed_radix_fast_fourier_transform_tpu.ops.stockham import exec_mixed_radix
    from mixed_radix_fast_fourier_transform_tpu.plan import build_mixed_radix_plan

    plan = build_mixed_radix_plan(radix, -1)
    assert plan.factors == (radix,)
    # impulse: flat unit spectrum
    imp_r = np.zeros((1, radix), np.float32)
    imp_r[0, 0] = 1.0
    zr, zi = exec_mixed_radix(plan, jnp.asarray(imp_r), jnp.zeros_like(jnp.asarray(imp_r)))
    np.testing.assert_allclose(np.asarray(zr), np.ones((1, radix)), atol=1e-6)
    np.testing.assert_allclose(np.asarray(zi), np.zeros((1, radix)), atol=1e-6)
    # random input
    x = rng.standard_normal(radix) + 1j * rng.standard_normal(radix)
    zr, zi = exec_mixed_radix(
        plan,
        jnp.asarray(x.real.astype(np.float32))[None],
        jnp.asarray(x.imag.astype(np.float32))[None],
    )
    got = np.asarray(zr)[0] + 1j * np.asarray(zi)[0]
    want = np.fft.fft(x)
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 2e-6


@pytest.mark.parametrize("n", [2, 6, 9, 10, 12, 14, 16, 36, 49, 60, 128, 180, 360, 504, 509, 1024, 5040])
def test_reference_broken_lengths(rng, n):
    """Every length where the reference is silently wrong (SURVEY.md §2.9's
    verified matrix) must be correct here."""
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    got = np.asarray(sp.fft(x)).astype(np.complex128)
    want = np.fft.fft(x.astype(np.complex128))
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 2e-5


def test_stage_matmul_forms_crossover(rng):
    """One plan mixing both stage-matmul forms: a >=128 stage (Karatsuba
    3-matmul) and a <128 stage (stacked block matmul) must compose correctly
    (ops/stockham.KARATSUBA_MIN_STAGE crossover)."""
    from mixed_radix_fast_fourier_transform_tpu.ops.stockham import (
        KARATSUBA_MIN_STAGE,
        exec_mixed_radix,
    )
    from mixed_radix_fast_fourier_transform_tpu.plan import build_mixed_radix_plan
    from mixed_radix_fast_fourier_transform_tpu.utils.config import DEFAULT_CONFIG

    plan = build_mixed_radix_plan(8192, -1, DEFAULT_CONFIG)  # (128, 64)
    assert any(f >= KARATSUBA_MIN_STAGE for f in plan.factors), plan.factors
    assert any(f < KARATSUBA_MIN_STAGE for f in plan.factors), plan.factors
    x = rng.standard_normal(8192) + 1j * rng.standard_normal(8192)
    zr, zi = exec_mixed_radix(
        plan,
        jnp.asarray(x.real.astype(np.float32))[None],
        jnp.asarray(x.imag.astype(np.float32))[None],
    )
    got = np.asarray(zr)[0] + 1j * np.asarray(zi)[0]
    want = np.fft.fft(x)
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 2e-5


def test_precision_ladder(rng):
    """The matmul precision ladder (SpectralConfig.precision): DEFAULT must be
    measurably worse than HIGH, HIGH worse than HIGHEST, and HIGHEST inside
    the 1e-5 budget — documents the measured accuracy/speed trade."""
    import dataclasses

    from mixed_radix_fast_fourier_transform_tpu.ops.stockham import exec_mixed_radix
    from mixed_radix_fast_fourier_transform_tpu.plan import build_mixed_radix_plan
    from mixed_radix_fast_fourier_transform_tpu.utils.config import DEFAULT_CONFIG

    n = 1024
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    want = np.fft.fft(x)
    errs = {}
    for prec in ("highest", "high", "default"):
        cfg = dataclasses.replace(DEFAULT_CONFIG, precision=prec)
        plan = build_mixed_radix_plan(n, -1, cfg)
        zr, zi = exec_mixed_radix(
            plan,
            jnp.asarray(x.real.astype(np.float32))[None],
            jnp.asarray(x.imag.astype(np.float32))[None],
        )
        got = np.asarray(zr)[0] + 1j * np.asarray(zi)[0]
        errs[prec] = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert errs["highest"] < TOL
    # CPU executes all precisions as true fp32, so the ladder only orders on
    # backends that degrade precision; assert it when the backend does.
    if errs["default"] > 2 * errs["highest"]:
        assert errs["highest"] <= errs["high"] <= errs["default"]


class TestHartley:
    def test_dht_matches_cas_matrix(self, rng):
        for n in (8, 15, 360):
            x = rng.standard_normal(n).astype(np.float32)
            got = np.asarray(sp.dht(x)).astype(np.float64)
            k = np.arange(n)
            arg = 2 * np.pi * np.outer(k, k) / n
            want = (np.cos(arg) + np.sin(arg)) @ x.astype(np.float64)
            assert np.max(np.abs(got - want)) < 1e-4 * max(1.0, np.abs(want).max()), n

    def test_dht_self_inverse(self, rng):
        x = rng.standard_normal((3, 128)).astype(np.float32)
        back = np.asarray(sp.idht(sp.dht(x)))
        np.testing.assert_allclose(back, x, atol=1e-4)

    def test_dht_complex_planes(self, rng):
        z = (rng.standard_normal(64) + 1j * rng.standard_normal(64)).astype(np.complex64)
        got = np.asarray(sp.dht(z))
        want = np.asarray(sp.dht(z.real)) + 1j * np.asarray(sp.dht(z.imag))
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_per_stage_precision_tuple():
    """SpectralConfig.precision accepts per-stage tuples (mixed schemes);
    plans cache per scheme and execute correctly."""
    import dataclasses

    import jax

    from mixed_radix_fast_fourier_transform_tpu.ops.stockham import exec_complex
    from mixed_radix_fast_fourier_transform_tpu.plan import build_complex_plan
    from mixed_radix_fast_fourier_transform_tpu.utils.config import DEFAULT_CONFIG

    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 360)) + 1j * rng.standard_normal((4, 360))
    want = np.fft.fft(x, axis=-1)
    cfg = dataclasses.replace(DEFAULT_CONFIG, precision=("highest", "high"))
    p = build_complex_plan(360, -1, cfg)
    assert p.precision == ("highest", "high")
    zr, zi = jax.jit(lambda a, c: exec_complex(p, a, c))(
        x.real.astype(np.float32), x.imag.astype(np.float32)
    )
    got = np.asarray(zr) + 1j * np.asarray(zi)
    # CPU matmuls are fp32-exact regardless of flag: correctness only
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 1e-4


def test_butterfly_small_stages():
    """Radix-2/4 stages as elementwise butterflies (plan.butterfly=True) match the
    dense-matmul form and numpy fp64, both signs, leaf and combine positions
    (see stockham._butterfly_stage — the N=65536 tail-stage A/B lever)."""
    import dataclasses

    import mixed_radix_fast_fourier_transform_tpu.plan as P
    from mixed_radix_fast_fourier_transform_tpu.ops.stockham import exec_complex

    rng = np.random.default_rng(11)
    orig = P.plan_stages
    try:
        for n, stages in [
            (64, (4, 16)),
            (64, (16, 4)),
            (32, (2, 16)),
            (128, (8, 16)),
            (128, (16, 8)),
        ]:
            P.plan_stages = (
                lambda nn, ms, strategy="balanced", s=stages, n0=n: s
                if nn == n0
                else orig(nn, ms, strategy)
            )
            P.clear_plan_cache()
            x = rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
            xr = x.real.astype(np.float32)
            xi = x.imag.astype(np.float32)
            for sign in (-1, 1):
                plan = dataclasses.replace(
                    P.build_complex_plan(n, sign), butterfly=True
                )
                gr, gi = exec_complex(plan, xr, xi)
                want = np.fft.fft(x) if sign == -1 else np.fft.ifft(x) * n
                err = np.max(
                    np.abs(np.asarray(gr) + 1j * np.asarray(gi) - want)
                ) / np.max(np.abs(want))
                assert err < 2e-6, (n, stages, sign, err)
    finally:
        P.plan_stages = orig
        P.clear_plan_cache()


def test_butterfly_radix16():
    """Opt-in radix-16 butterfly (SpectralConfig.butterfly='16' /
    plan.butterfly_max=16) matches numpy fp64 in leaf and combine
    positions, both signs (see stockham._bfly16)."""
    import dataclasses

    import mixed_radix_fast_fourier_transform_tpu.plan as P
    from mixed_radix_fast_fourier_transform_tpu.ops.stockham import exec_complex

    rng = np.random.default_rng(16)
    orig = P.plan_stages
    try:
        for n, stages in [(64, (4, 16)), (64, (16, 4)), (256, (16, 16))]:
            P.plan_stages = (
                lambda nn, ms, strategy="balanced", s=stages, n0=n: s
                if nn == n0
                else orig(nn, ms, strategy)
            )
            P.clear_plan_cache()
            x = rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
            xr = x.real.astype(np.float32)
            xi = x.imag.astype(np.float32)
            for sign in (-1, 1):
                plan = dataclasses.replace(
                    P.build_complex_plan(n, sign),
                    butterfly=True,
                    butterfly_max=16,
                )
                gr, gi = exec_complex(plan, xr, xi)
                want = np.fft.fft(x) if sign == -1 else np.fft.ifft(x) * n
                err = np.max(
                    np.abs(np.asarray(gr) + 1j * np.asarray(gi) - want)
                ) / np.max(np.abs(want))
                assert err < 2e-6, (n, stages, sign, err)
    finally:
        P.plan_stages = orig
        P.clear_plan_cache()


def test_butterfly16_composite_paths():
    """butterfly='16' stays accurate through Bluestein (n=1009 → inner
    m=2048=(128,16)) and rfft (n=4096 → inner 2048) composites."""
    import mixed_radix_fast_fourier_transform_tpu as sp
    from mixed_radix_fast_fourier_transform_tpu.utils.config import SpectralConfig

    rng = np.random.default_rng(7)
    cfg = SpectralConfig(butterfly="16")
    x = (rng.standard_normal(1009) + 1j * rng.standard_normal(1009)).astype(
        np.complex64
    )
    want = np.fft.fft(x.astype(np.complex128))
    err = np.max(np.abs(np.asarray(sp.fft(x, config=cfg)) - want)) / np.max(
        np.abs(want)
    )
    assert err < 1e-5, err
    xr = rng.standard_normal(4096).astype(np.float32)
    wr = np.fft.rfft(xr.astype(np.float64))
    err = np.max(np.abs(np.asarray(sp.rfft(xr, config=cfg)) - wr)) / np.max(
        np.abs(wr)
    )
    assert err < 1e-5, err


def test_butterfly_config_lever():
    """The '16' config value flows to plan.butterfly_max; invalid rejected."""
    from mixed_radix_fast_fourier_transform_tpu.plan import build_complex_plan
    from mixed_radix_fast_fourier_transform_tpu.utils.config import SpectralConfig

    p16 = build_complex_plan(2048, -1, SpectralConfig(butterfly="16"))
    assert p16.butterfly and p16.butterfly_max == 16
    pauto = build_complex_plan(2048, -1, SpectralConfig(butterfly="auto"))
    assert pauto.butterfly and pauto.butterfly_max == 16  # measured 1.39x
    p8 = build_complex_plan(2048, -1, SpectralConfig(butterfly="8"))
    assert p8.butterfly and p8.butterfly_max == 8
    poff = build_complex_plan(2048, -1, SpectralConfig(butterfly="off"))
    assert not poff.butterfly
    with pytest.raises(ValueError):
        SpectralConfig(butterfly="on")


def test_split6_precision_form():
    """The split6 fused form (bitmask bf16 chunks) is fp32-class accurate."""
    import dataclasses

    import jax

    from mixed_radix_fast_fourier_transform_tpu.ops.stockham import exec_complex
    from mixed_radix_fast_fourier_transform_tpu.plan import build_complex_plan
    from mixed_radix_fast_fourier_transform_tpu.utils.config import DEFAULT_CONFIG

    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 1024)) + 1j * rng.standard_normal((2, 1024))
    want = np.fft.fft(x, axis=-1)
    cfg = dataclasses.replace(DEFAULT_CONFIG, precision="split6")
    p = build_complex_plan(1024, -1, cfg)
    zr, zi = jax.jit(lambda a, c: exec_complex(p, a, c))(
        x.real.astype(np.float32), x.imag.astype(np.float32)
    )
    got = np.asarray(zr) + 1j * np.asarray(zi)
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 5e-6


class TestRader:
    """Prime lengths with smooth n−1 take Rader's algorithm: one length-(n−1)
    cyclic convolution (two smooth inner FFTs) instead of Bluestein's
    m ≈ 2.4n chirp-padded pair.  The reference has no prime fast path at all
    (src/highSpeedFFT.c:236-265 routes every non-smooth n to Bluestein)."""

    def test_dispatch(self):
        from mixed_radix_fast_fourier_transform_tpu.plan import (
            BluesteinPlan, RaderPlan,
        )

        # default is "off" (Bluestein) — opt in with "auto"
        auto = sp.SpectralConfig(rader="auto")
        for n in (257, 509, 1009, 8191):
            assert isinstance(sp.get_plan(n, -1), BluesteinPlan), n
            assert isinstance(
                sp.get_plan(n, -1, "complex", auto), RaderPlan
            ), n
        # 10007 − 1 = 2·5003 (5003 prime > max_stage) — Bluestein even
        # under "auto"; composite non-smooth lengths too
        assert isinstance(sp.get_plan(10007, -1, "complex", auto),
                          BluesteinPlan)
        assert isinstance(sp.get_plan(2 * 1009, -1, "complex", auto),
                          BluesteinPlan)
        with pytest.raises(ValueError):
            sp.SpectralConfig(rader="always")

    @pytest.mark.parametrize("n", [257, 1009, 2003])
    def test_matches_numpy_both_signs(self, rng, n):
        x = _rand_complex(rng, (3, n))
        assert _rel_err(sp.fft(x), np.fft.fft(x.astype(np.complex128))) < TOL
        assert _rel_err(sp.ifft(x), np.fft.ifft(x.astype(np.complex128))) < TOL

    def test_dc_bin_exact_sum(self, rng):
        n = 1009
        x = _rand_complex(rng, n)
        got = np.asarray(sp.fft(x))[0]
        want = np.sum(x.astype(np.complex128))
        assert abs(got - want) / abs(want) < TOL

    def test_rader_vs_bluestein_same_answer(self, rng):
        n = 1009
        x = _rand_complex(rng, n)
        a = np.asarray(sp.fft(x, config=sp.SpectralConfig(rader="auto")))
        b = np.asarray(sp.fft(x))  # default Bluestein
        assert _rel_err(a, b) < 2 * TOL

    def test_build_rader_plan_validation(self):
        with pytest.raises(ValueError):
            sp.build_rader_plan(1008, -1)  # composite
        with pytest.raises(ValueError):
            sp.build_rader_plan(1009, 2)

    def test_primitive_root(self):
        from mixed_radix_fast_fourier_transform_tpu.utils.factorize import (
            primitive_root,
        )

        for p in (3, 5, 7, 257, 1009):
            g = primitive_root(p)
            # g generates the full multiplicative group
            seen = set()
            cur = 1
            for _ in range(p - 1):
                seen.add(cur)
                cur = cur * g % p
            assert len(seen) == p - 1, p
        with pytest.raises(ValueError):
            primitive_root(1008)

    def test_plan_cost_model(self):
        from mixed_radix_fast_fourier_transform_tpu.utils.profiling import (
            plan_cost,
        )

        plan = sp.get_plan(1009, -1, "complex", sp.SpectralConfig(rader="auto"))
        cost = plan_cost(plan)
        inner = plan_cost(plan.inner)
        assert cost.n == 1009
        assert cost.flops > 2 * inner.flops
        # Rader does strictly less transform work than Bluestein here —
        # yet it adds gather permutations and narrow inner stages, and the
        # default stays Bluestein
        blu = plan_cost(sp.get_plan(1009, -1))
        assert cost.flops < blu.flops
