"""Property-based FFT tests: linearity, Parseval, shift theorem, impulse,
conjugate symmetry (SURVEY.md §4's prescription for replacing the reference's
unbuildable mock-heavy GoogleTest suite with oracle/property tests)."""

import numpy as np
import pytest

import mixed_radix_fast_fourier_transform_tpu as sp

SIZES = [8, 15, 36, 360, 1009]  # smooth, odd-smooth, ref-broken, Bluestein


def _c128(x):
    return np.asarray(x, dtype=np.complex128)


def _rand(rng, n):
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)


@pytest.mark.parametrize("n", SIZES)
def test_linearity(rng, n):
    x, y = _rand(rng, n), _rand(rng, n)
    a, b = 2.5, -1.25
    lhs = _c128(sp.fft(a * x + b * y))
    rhs = a * _c128(sp.fft(x)) + b * _c128(sp.fft(y))
    np.testing.assert_allclose(lhs, rhs, atol=1e-4 * np.abs(rhs).max())


@pytest.mark.parametrize("n", SIZES)
def test_parseval(rng, n):
    x = _rand(rng, n)
    X = _c128(sp.fft(x))
    lhs = np.sum(np.abs(x.astype(np.complex128)) ** 2)
    rhs = np.sum(np.abs(X) ** 2) / n
    np.testing.assert_allclose(lhs, rhs, rtol=1e-5)


@pytest.mark.parametrize("n", SIZES)
def test_impulse(rng, n):
    x = np.zeros(n, np.complex64)
    x[0] = 1.0
    X = _c128(sp.fft(x))
    np.testing.assert_allclose(X, np.ones(n), atol=1e-5)


@pytest.mark.parametrize("n", SIZES)
def test_shift_theorem(rng, n):
    """FFT(roll(x, s))[k] = FFT(x)[k] · e^(-2πi·s·k/n)."""
    x = _rand(rng, n)
    s = n // 3 + 1
    lhs = _c128(sp.fft(np.roll(x, s)))
    k = np.arange(n)
    rhs = _c128(sp.fft(x)) * np.exp(-2j * np.pi * s * k / n)
    np.testing.assert_allclose(lhs, rhs, atol=1e-4 * np.abs(rhs).max())


@pytest.mark.parametrize("n", SIZES)
def test_real_input_conjugate_symmetry(rng, n):
    x = rng.standard_normal(n).astype(np.float32)
    X = _c128(sp.fft(x))
    for k in range(1, n // 2 + 1):
        np.testing.assert_allclose(
            X[n - k], np.conj(X[k]), atol=1e-4 * np.abs(X).max()
        )


@pytest.mark.parametrize("n", SIZES)
def test_convolution_theorem(rng, n):
    """ifft(fft(x)·fft(y)) equals circular convolution."""
    x, y = _rand(rng, n), _rand(rng, n)
    lhs = _c128(sp.ifft(np.asarray(sp.fft(x)) * np.asarray(sp.fft(y))))
    xx, yy = x.astype(np.complex128), y.astype(np.complex128)
    rhs = np.fft.ifft(np.fft.fft(xx) * np.fft.fft(yy))
    np.testing.assert_allclose(lhs, rhs, atol=1e-4 * np.abs(rhs).max())


def test_planner_invariants():
    """Stage products, smoothness routing, factorization correctness."""
    import math

    for n in [2, 12, 97, 360, 1024, 5040, 65536]:
        assert math.prod(sp.prime_factors(n)) == n
        if sp.plan_stages.__module__:  # smooth lengths only
            try:
                stages = sp.plan_stages(n, 64)
                assert math.prod(stages) == n
                assert all(s <= 64 for s in stages)
            except ValueError:
                assert max(sp.prime_factors(n)) > 64
    assert sp.next_pow2(513) == 1024
    assert sp.next_pow2(1) == 1
    assert sp.next_fast_len(1009) <= 1024
    assert sp.dividebyN(19 * 8)  # reference's lookup wrongly excludes 19
    assert not sp.dividebyN(59)


def test_next_splittable_len():
    from mixed_radix_fast_fourier_transform_tpu.parallel.distributed import (
        choose_split,
    )
    from mixed_radix_fast_fourier_transform_tpu.utils.factorize import (
        next_splittable_len,
    )

    for n in [7, 100, 4128, 4129, 65535, 65537, 100003]:
        for p in [1, 2, 4, 8]:
            m = next_splittable_len(n, p)
            assert m >= n
            n1, n2 = choose_split(m, p)  # must never raise
            assert n1 * n2 == m and n1 % p == 0 and n2 % p == 0
    # awkward shape from the old retry loop's worst case: kernel+signal sums
    # landing just past a splittable length
    m = next_splittable_len(4000 + 129 - 1, 4)
    assert m >= 4128 and choose_split(m, 4)
    with pytest.raises(ValueError):
        next_splittable_len(100, 257, max_stage=256)


def test_plan_cache_identity():
    p1 = sp.get_plan(360, -1)
    p2 = sp.get_plan(360, -1)
    assert p1 is p2
    sp.clear_plan_cache()
    p3 = sp.get_plan(360, -1)
    assert p3 is not p1


def test_plan_is_immutable_pytree():
    """Plans are frozen pytrees — the reference mutates plans during Bluestein
    exec (src/highSpeedFFT.c:1759-1760), making it non-reentrant; we must not."""
    import dataclasses

    import jax

    # 1009 is a RaderPlan since round 4; 10007 stays Bluestein (padded m)
    for n in (1009, 10007):
        p = sp.get_plan(n, -1)
        with pytest.raises(dataclasses.FrozenInstanceError):
            p.n = 7
        leaves, treedef = jax.tree_util.tree_flatten(p)
        p2 = jax.tree_util.tree_unflatten(treedef, leaves)
        assert p2.n == p.n
        assert getattr(p2, "m", None) == getattr(p, "m", None)
        assert p2.inner.factors == p.inner.factors


@pytest.mark.parametrize("n", [64, 360])
def test_vmap(rng, n):
    """Transforms compose with vmap — a functional-transform capability the
    C reference cannot express."""
    import jax

    x = np.stack([_rand(rng, n) for _ in range(5)])
    got = np.asarray(jax.vmap(sp.fft)(x))
    want = np.fft.fft(x.astype(np.complex128), axis=-1)
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())


def test_error_budget_baseline_configs(rng):
    """BASELINE.md: max rel err <= 1e-5 vs fp64 oracle across the driver's
    benchmark configs (1024; 360/5040 where the reference is wrong; rFFT 4096
    round trip; Bluestein 1009/10007)."""
    for n in (1024, 360, 5040, 1009, 10007):
        x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
        got = _c128(sp.fft(x))
        want = np.fft.fft(x.astype(np.complex128))
        rel = np.max(np.abs(got - want)) / np.max(np.abs(want))
        assert rel <= 1e-5, (n, rel)
    xr = rng.standard_normal(4096).astype(np.float32)
    back = np.asarray(sp.irfft(sp.rfft(xr), n=4096))
    assert np.max(np.abs(back - xr)) / np.max(np.abs(xr)) <= 1e-5


def test_persistent_compile_cache_helper(tmp_path):
    import jax

    from mixed_radix_fast_fourier_transform_tpu.utils.cache import (
        enable_persistent_cache,
    )

    path = enable_persistent_cache(str(tmp_path / "xla"))
    assert jax.config.jax_compilation_cache_dir == path


@pytest.mark.parametrize("env", [None, "", "/data/jax-cache"])
def test_compile_cache_dir_choice(env, monkeypatch):
    import os
    import tempfile

    from mixed_radix_fast_fourier_transform_tpu.utils import cache

    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
    got = cache.compile_cache_dir()
    if env:
        assert got == env
        return
    # unset (or empty): the fixed path inside the checkout, never a
    # temporary or per-process directory
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert got == os.path.join(repo, ".jax_cache") == cache.REPO_CACHE_DIR
    assert not got.startswith(tempfile.gettempdir() + os.sep)
    assert str(os.getpid()) not in got


def test_enable_persistent_cache_uses_env_dir(tmp_path, monkeypatch):
    import jax

    from mixed_radix_fast_fourier_transform_tpu.utils.cache import (
        enable_persistent_cache,
    )

    before = jax.config.jax_compilation_cache_dir
    target = str(tmp_path / "from-env")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", target)
    try:
        assert enable_persistent_cache() == target
        assert jax.config.jax_compilation_cache_dir == target
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_stage_strategy_respected_and_cached_separately():
    import dataclasses

    sp.clear_plan_cache()
    cfg_g = dataclasses.replace(sp.DEFAULT_CONFIG, stage_strategy="greedy", max_stage=64)
    cfg_b = dataclasses.replace(sp.DEFAULT_CONFIG, stage_strategy="balanced", max_stage=64)
    pg = sp.get_plan(1024, -1, config=cfg_g)
    pb = sp.get_plan(1024, -1, config=cfg_b)
    assert pg.factors == (64, 16)   # greedy packs toward max_stage
    assert pb.factors == (32, 32)   # balanced LPT
    assert pg is not pb


@pytest.mark.slow
def test_random_length_sweep(rng):
    """Safety net: 40 random lengths across the mixed-radix/Bluestein split."""
    lengths = sorted(set(int(v) for v in rng.integers(2, 4097, size=40)))
    for n in lengths:
        x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
        got = _c128(sp.fft(x))
        want = np.fft.fft(x.astype(np.complex128))
        rel = np.max(np.abs(got - want)) / np.max(np.abs(want))
        assert rel < 2e-5, (n, rel)


def test_stage_window_rule(rng):
    """Measured two-stage window rule (CLAUDE.md): for non-pow2 n >= 3072 the
    largest divisor in (96..128] leads the plan; below 3072 LPT balancing
    stands (2520 forced (126,20) 0.83x, 1260 forced (126,10) 0.72-0.91x)."""
    cases = {
        3600: (120, 30),
        5040: (126, 40),
        6144: (128, 48),
        3072: (128, 24),
        10000: (125, 80),
        24576: (192, 128),  # window a=128 -> cofactor 192, same multiset as LPT
        2520: (60, 42),     # below threshold: LPT ((126,20) measured 0.83x)
        1260: (42, 30),     # below threshold: LPT
        1024: (64, 16),     # bfly16 rule: (64,16)+bfly16 measured 1.59x over LPT (32,32)
        2048: (128, 16),    # pow2 rule, unchanged
    }
    for n, want in cases.items():
        assert sp.plan_stages(n, 256) == want, n
    # correctness at freshly re-planned sizes
    for n in (3600, 2520, 10000):
        x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
        got = _c128(sp.fft(x))
        want_fft = np.fft.fft(x.astype(np.complex128))
        assert np.max(np.abs(got - want_fft)) / np.max(np.abs(want_fft)) < 2e-5, n


@pytest.mark.parametrize("norm", ["backward", "ortho", "forward"])
def test_rfft_norm_roundtrips(rng, norm):
    x = rng.standard_normal(256).astype(np.float32)
    spec = sp.rfft(x, norm=norm)
    back = np.asarray(sp.irfft(spec, n=256, norm=norm))
    assert np.max(np.abs(back - x)) < 1e-4
    want = np.fft.rfft(x.astype(np.float64), norm=norm)
    assert np.max(np.abs(np.asarray(spec) - want)) / np.max(np.abs(want)) < 2e-5


def test_prev_fast_len():
    # largest {2,3,5,7}-smooth m <= n (scipy.fft.prev_fast_len analogue over
    # this engine's fast-prime set — scipy/pocketfft also counts 11 as fast)
    cases = {1: 1, 7: 7, 11: 10, 13: 12, 100: 100, 1009: 1008,
             5041: 5040, 65537: 65536}
    for n, want in cases.items():
        assert sp.prev_fast_len(n) == want, n
    with pytest.raises(ValueError):
        sp.prev_fast_len(0)
