"""NUFFT types 1/2/3: fp64 NUDFT oracle, dense/grid agreement, uniform-grid
reduction to the FFT, adjoint identity, autodiff, error paths."""

import numpy as np
import pytest

import mixed_radix_fast_fourier_transform_tpu as sp


@pytest.fixture
def rng():
    return np.random.default_rng(5)


def _oracle1(x, c, n, isign=-1):
    k = np.arange(-(n // 2), (n + 1) // 2)
    return np.exp(isign * 1j * np.outer(k, x.astype(np.float64))) @ c.astype(
        np.complex128
    )


def _oracle2(x, f, isign=+1):
    n = f.shape[-1]
    k = np.arange(-(n // 2), (n + 1) // 2)
    return np.exp(isign * 1j * np.outer(x.astype(np.float64), k)) @ f.astype(
        np.complex128
    )


def _pts(rng, m):
    return rng.uniform(0.0, 2 * np.pi, m).astype(np.float32)


def _strengths(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(
        np.complex64
    )


@pytest.mark.parametrize("method", ["dense", "grid"])
@pytest.mark.parametrize("n,isign", [(64, -1), (63, -1), (64, +1)])
def test_nufft1_matches_oracle(rng, method, n, isign):
    x = _pts(rng, 150)
    c = _strengths(rng, 150)
    got = np.asarray(sp.nufft1(x, c, n, isign=isign, method=method))
    want = _oracle1(x, c, n, isign)
    rel = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert rel < 1e-5, (method, n, isign, rel)


@pytest.mark.parametrize("method", ["dense", "grid"])
@pytest.mark.parametrize("n,isign", [(64, +1), (63, +1), (64, -1)])
def test_nufft2_matches_oracle(rng, method, n, isign):
    x = _pts(rng, 150)
    f = _strengths(rng, n)
    got = np.asarray(sp.nufft2(x, f, isign=isign, method=method))
    want = _oracle2(x, f, isign)
    rel = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert rel < 1e-5, (method, n, isign, rel)


def test_nufft1_large_n_phase_accuracy(rng):
    """The int-split phase reduction keeps the dense path accurate at mode
    numbers where naive fp32 k*x phases lose ~1e-2."""
    n, m = 8192, 32
    x = _pts(rng, m)
    c = _strengths(rng, m)
    got = np.asarray(sp.nufft1(x, c, n, method="dense"))
    want = _oracle1(x, c, n)
    rel = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert rel < 2e-5, rel


def test_uniform_points_reduce_to_fft(rng):
    n = 128
    x = (2 * np.pi * np.arange(n) / n).astype(np.float32)
    c = _strengths(rng, n)
    got = np.asarray(sp.nufft1(x, c, n, isign=-1))
    want = np.fft.fftshift(np.fft.fft(c.astype(np.complex128)))
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 1e-5


def test_grid_and_dense_agree_batched(rng):
    x = _pts(rng, 80)
    c = _strengths(rng, 3, 80)
    d = np.asarray(sp.nufft1(x, c, 48, method="dense"))
    g = np.asarray(sp.nufft1(x, c, 48, method="grid"))
    assert d.shape == g.shape == (3, 48)
    assert np.max(np.abs(d - g)) / np.max(np.abs(d)) < 1e-5
    f = _strengths(rng, 3, 48)
    d2 = np.asarray(sp.nufft2(x, f, method="dense"))
    g2 = np.asarray(sp.nufft2(x, f, method="grid"))
    assert d2.shape == g2.shape == (3, 80)
    assert np.max(np.abs(d2 - g2)) / np.max(np.abs(d2)) < 1e-5


def test_type2_is_adjoint_of_type1(rng):
    """<nufft1(c), f> == <c, conj-transpose pairing> with matched isign."""
    x = _pts(rng, 70)
    c = _strengths(rng, 70)
    f = _strengths(rng, 40)
    lhs = np.vdot(np.asarray(sp.nufft1(x, c, 40, isign=-1)), f)
    rhs = np.vdot(c, np.asarray(sp.nufft2(x, f, isign=+1)))
    assert abs(lhs - rhs) / abs(lhs) < 1e-5


def test_nufft3_matches_oracle(rng):
    x = rng.uniform(-3.0, 3.0, 60).astype(np.float32)
    s = rng.uniform(-20.0, 20.0, 45).astype(np.float32)
    c = _strengths(rng, 60)
    got = np.asarray(sp.nufft3(x, c, s))
    k = s.astype(np.float64)
    want = np.exp(-1j * np.outer(k, x.astype(np.float64))) @ c.astype(np.complex128)
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 1e-4


def test_nufft_jit_and_grad(rng):
    import jax
    import jax.numpy as jnp

    x = _pts(rng, 50)
    c = _strengths(rng, 50)

    def loss(cr):
        f = sp.nufft1(x, jax.lax.complex(cr, jnp.zeros_like(cr)), 32)
        return jnp.sum(jnp.abs(f) ** 2)

    g = jax.jit(jax.grad(loss))(c.real)
    assert g.shape == (50,) and bool(np.isfinite(np.asarray(g)).all())
    # numerical check on one coordinate
    e = np.zeros(50, np.float32)
    e[7] = 1e-2
    fd = (loss(c.real + e) - loss(c.real - e)) / 2e-2
    assert abs(float(fd) - float(g[7])) / max(abs(float(fd)), 1e-6) < 1e-2


def test_nufft_errors(rng):
    x = _pts(rng, 10)
    c = _strengths(rng, 10)
    with pytest.raises(ValueError):
        sp.nufft1(x, c, 0)
    with pytest.raises(ValueError):
        sp.nufft1(x, c[:5], 16)
    with pytest.raises(ValueError):
        sp.nufft1(x, c, 16, method="fancy")
    with pytest.raises(ValueError):
        sp.nufft2(x, np.zeros(0, np.complex64))
    with pytest.raises(ValueError):
        sp.nufft3(x, c, np.zeros((2, 2), np.float32))


# --------------------------- 2-D NUFFT ------------------------------------


def _oracle1_2d(x, y, c, n1, n2, isign=-1):
    k1 = np.arange(-(n1 // 2), (n1 + 1) // 2)
    k2 = np.arange(-(n2 // 2), (n2 + 1) // 2)
    ph = k1[:, None, None] * x.astype(np.float64)[None, None, :] + k2[
        None, :, None
    ] * y.astype(np.float64)[None, None, :]
    return np.einsum("abm,m->ab", np.exp(isign * 1j * ph), c.astype(np.complex128))


@pytest.mark.parametrize("method", ["dense", "grid"])
@pytest.mark.parametrize("n1,n2,isign", [(16, 24, -1), (17, 12, +1)])
def test_nufft1_2d_matches_oracle(rng, method, n1, n2, isign):
    m = 90
    x, y = _pts(rng, m), _pts(rng, m)
    c = _strengths(rng, m)
    got = np.asarray(
        sp.nufft1_2d(x, y, c, (n1, n2), isign=isign, method=method)
    )
    want = _oracle1_2d(x, y, c, n1, n2, isign)
    rel = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert got.shape == (n1, n2) and rel < 2e-5, (method, rel)


@pytest.mark.parametrize("method", ["dense", "grid"])
def test_nufft2_2d_matches_oracle(rng, method):
    n1, n2, m = 20, 15, 70
    x, y = _pts(rng, m), _pts(rng, m)
    f = _strengths(rng, n1, n2)
    got = np.asarray(sp.nufft2_2d(x, y, f, method=method))
    k1 = np.arange(-(n1 // 2), (n1 + 1) // 2)
    k2 = np.arange(-(n2 // 2), (n2 + 1) // 2)
    ph = np.exp(
        1j
        * (
            x.astype(np.float64)[:, None, None] * k1[None, :, None]
            + y.astype(np.float64)[:, None, None] * k2[None, None, :]
        )
    )
    want = np.einsum("mab,ab->m", ph, f.astype(np.complex128))
    rel = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert got.shape == (m,) and rel < 2e-5, (method, rel)


def test_nufft_2d_batched_and_adjoint(rng):
    m, n1, n2 = 50, 12, 10
    x, y = _pts(rng, m), _pts(rng, m)
    c = _strengths(rng, 3, m)
    got = np.asarray(sp.nufft1_2d(x, y, c, (n1, n2)))
    assert got.shape == (3, n1, n2)
    row = np.asarray(sp.nufft1_2d(x, y, c[1], (n1, n2)))
    np.testing.assert_allclose(got[1], row, atol=1e-5)
    f = _strengths(rng, n1, n2)
    lhs = np.vdot(np.asarray(sp.nufft1_2d(x, y, c[0], (n1, n2), isign=-1)), f)
    rhs = np.vdot(c[0], np.asarray(sp.nufft2_2d(x, y, f, isign=+1)))
    assert abs(lhs - rhs) / abs(lhs) < 1e-5


def test_nufft_2d_grid_dense_agree_large(rng):
    m = 200
    x, y = _pts(rng, m), _pts(rng, m)
    c = _strengths(rng, m)
    d = np.asarray(sp.nufft1_2d(x, y, c, (64, 48), method="dense"))
    g = np.asarray(sp.nufft1_2d(x, y, c, (64, 48), method="grid"))
    assert np.max(np.abs(d - g)) / np.max(np.abs(d)) < 1e-5


def test_nufft_2d_errors(rng):
    x = _pts(rng, 10)
    c = _strengths(rng, 10)
    with pytest.raises(ValueError):
        sp.nufft1_2d(x, x[:5], c, (8, 8))
    with pytest.raises(ValueError):
        sp.nufft1_2d(x, x, c, (0, 8))
    with pytest.raises(ValueError):
        sp.nufft2_2d(x, x, np.zeros((4,), np.complex64))


def test_auto_dispatch_respects_phase_reduction_bound():
    """auto must route mode counts past the |k| < 2^16 bound to the grid
    path instead of crashing in the dense phase reduction."""
    from mixed_radix_fast_fourier_transform_tpu.ops.nufft import (
        _use_dense,
        _use_dense_2d,
    )

    assert not _use_dense("auto", 16 * 131072, 131072)
    assert _use_dense("auto", 1000, 4096)
    assert _use_dense("dense", 10**12, 10**6)  # explicit dense always honored
    assert not _use_dense_2d("auto", 131072, 2, 8)
    assert _use_dense_2d("dense", 131072, 131072, 10**6)


def test_nufft_lsq_recovers_modes(rng):
    """Exact mode recovery from >= 2x oversampled scattered samples."""
    n, m = 32, 100
    x = _pts(rng, m)
    f_true = _strengths(rng, n)
    b = np.asarray(sp.nufft2(x, f_true, isign=+1))
    got = np.asarray(sp.nufft_lsq(x, b.astype(np.complex64), n, iters=50))
    rel = np.max(np.abs(got - f_true)) / np.max(np.abs(f_true))
    assert rel < 1e-4, rel


def test_nufft_lsq_batched_weighted_damped(rng):
    n, m = 16, 64
    x = _pts(rng, m)
    f_true = _strengths(rng, 3, n)
    b = np.asarray(sp.nufft2(x, f_true, isign=+1)).astype(np.complex64)
    w = np.ones(m, np.float32)
    got = np.asarray(sp.nufft_lsq(x, b, n, weights=w, iters=40))
    assert got.shape == (3, n)
    rel = np.max(np.abs(got - f_true)) / np.max(np.abs(f_true))
    assert rel < 1e-4, rel
    # damping biases toward zero but must stay finite and close-ish
    damped = np.asarray(sp.nufft_lsq(x, b, n, damp=1e-3, iters=40))
    assert np.all(np.isfinite(damped))


def test_nufft_lsq_errors(rng):
    x = _pts(rng, 10)
    b = _strengths(rng, 10)
    with pytest.raises(ValueError):
        sp.nufft_lsq(x, b[:4], 8)
    with pytest.raises(ValueError):
        sp.nufft_lsq(x, b, 0)
    with pytest.raises(ValueError):
        sp.nufft_lsq(x, b, 8, iters=0)
    with pytest.raises(ValueError):
        sp.nufft_lsq(x, b, 8, weights=np.ones(3, np.float32))


def test_nufft_lsq_2d_recovers_modes(rng):
    n1, n2, m = 12, 10, 400
    x, y = _pts(rng, m), _pts(rng, m)
    f_true = _strengths(rng, n1, n2)
    b = np.asarray(sp.nufft2_2d(x, y, f_true, isign=+1)).astype(np.complex64)
    got = np.asarray(sp.nufft_lsq_2d(x, y, b, (n1, n2), iters=60))
    rel = np.max(np.abs(got - f_true)) / np.max(np.abs(f_true))
    assert got.shape == (n1, n2) and rel < 1e-3, rel


def test_nufft_lsq_2d_errors(rng):
    x = _pts(rng, 10)
    b = _strengths(rng, 10)
    with pytest.raises(ValueError):
        sp.nufft_lsq_2d(x, x[:4], b, (4, 4))
    with pytest.raises(ValueError):
        sp.nufft_lsq_2d(x, x, b, (0, 4))
    with pytest.raises(ValueError):
        sp.nufft_lsq_2d(x, x, b, (4, 4), weights=np.ones(2, np.float32))


# --------------------------- 3-D NUFFT ------------------------------------


def _oracle1_3d(x, y, z, c, n1, n2, n3, isign=-1):
    k1 = np.arange(-(n1 // 2), (n1 + 1) // 2)
    k2 = np.arange(-(n2 // 2), (n2 + 1) // 2)
    k3 = np.arange(-(n3 // 2), (n3 + 1) // 2)
    ph = (
        k1[:, None, None, None] * x.astype(np.float64)
        + k2[None, :, None, None] * y.astype(np.float64)
        + k3[None, None, :, None] * z.astype(np.float64)
    )
    return np.einsum(
        "abcm,m->abc", np.exp(isign * 1j * ph), c.astype(np.complex128)
    )


@pytest.mark.parametrize("method", ["dense", "grid"])
def test_nufft1_3d_matches_oracle(rng, method):
    n1, n2, n3, m = 8, 10, 6, 60
    x, y, z = _pts(rng, m), _pts(rng, m), _pts(rng, m)
    c = _strengths(rng, m)
    got = np.asarray(
        sp.nufft1_3d(x, y, z, c, (n1, n2, n3), method=method)
    )
    want = _oracle1_3d(x, y, z, c, n1, n2, n3)
    rel = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert got.shape == (n1, n2, n3) and rel < 2e-5, (method, rel)


@pytest.mark.parametrize("method", ["dense", "grid"])
def test_nufft2_3d_matches_oracle(rng, method):
    n1, n2, n3, m = 6, 8, 5, 40
    x, y, z = _pts(rng, m), _pts(rng, m), _pts(rng, m)
    f = _strengths(rng, n1, n2, n3)
    got = np.asarray(sp.nufft2_3d(x, y, z, f, method=method))
    k1 = np.arange(-(n1 // 2), (n1 + 1) // 2)
    k2 = np.arange(-(n2 // 2), (n2 + 1) // 2)
    k3 = np.arange(-(n3 // 2), (n3 + 1) // 2)
    ph = (
        k1[:, None, None, None] * x.astype(np.float64)
        + k2[None, :, None, None] * y.astype(np.float64)
        + k3[None, None, :, None] * z.astype(np.float64)
    )
    want = np.einsum(
        "abcm,abc->m", np.exp(1j * ph), f.astype(np.complex128)
    )
    rel = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert got.shape == (m,) and rel < 2e-5, (method, rel)


def test_nufft_3d_adjoint_and_errors(rng):
    m, n = 30, (6, 6, 6)
    x, y, z = _pts(rng, m), _pts(rng, m), _pts(rng, m)
    c = _strengths(rng, m)
    f = _strengths(rng, *n)
    lhs = np.vdot(np.asarray(sp.nufft1_3d(x, y, z, c, n, isign=-1)), f)
    rhs = np.vdot(c, np.asarray(sp.nufft2_3d(x, y, z, f, isign=+1)))
    assert abs(lhs - rhs) / abs(lhs) < 1e-5
    with pytest.raises(ValueError):
        sp.nufft1_3d(x, y, z[:5], c, n)
    with pytest.raises(ValueError):
        sp.nufft1_3d(x, y, z, c, (0, 6, 6))


@pytest.mark.parametrize("method", ["dense", "grid"])
def test_points_outside_principal_range(rng, method):
    """x outside [0, 2pi) (negative, many periods) must fold exactly."""
    m, n = 60, 48
    x0 = _pts(rng, m)
    shifts = (2 * np.pi * rng.integers(-5, 6, m)).astype(np.float32)
    c = _strengths(rng, m)
    b = np.asarray(sp.nufft1(x0 + shifts, c, n, method=method))
    # fp32 addition of the shift perturbs x by ~|x|*eps; compare to the
    # oracle at the PERTURBED points, not to the unshifted result
    want = _oracle1((x0 + shifts), c, n)
    rel = np.max(np.abs(b - want)) / np.max(np.abs(want))
    assert rel < 2e-5, (method, rel)


def test_nufft3_fast_matches_dense(rng):
    m, kf = 200, 150
    x = rng.uniform(-25.0, 35.0, m).astype(np.float32)   # off-centre ranges
    s = rng.uniform(-18.0, 10.0, kf).astype(np.float32)
    c = _strengths(rng, m)
    for isign in (-1, +1):
        fast = np.asarray(sp.nufft3(x, c, s, isign=isign, method="fast"))
        k = s.astype(np.float64)
        want = np.exp(isign * 1j * np.outer(k, x.astype(np.float64))) @ c.astype(
            np.complex128
        )
        rel = np.max(np.abs(fast - want)) / np.max(np.abs(want))
        assert rel < 5e-4, (isign, rel)


def test_nufft3_fast_explicit_extents_jittable(rng):
    import jax
    import jax.numpy as jnp

    m, kf = 80, 60
    x = rng.uniform(-5.0, 5.0, m).astype(np.float32)
    s = rng.uniform(-8.0, 8.0, kf).astype(np.float32)
    c = _strengths(rng, m)

    @jax.jit
    def run(xa, ca, sa):
        return sp.nufft3(xa, ca, sa, method="fast", x_extent=5.0, s_extent=8.0)

    got = np.asarray(run(jnp.asarray(x), jnp.asarray(c), jnp.asarray(s)))
    want = np.exp(-1j * np.outer(s.astype(np.float64), x.astype(np.float64))) @ c.astype(np.complex128)
    rel = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert rel < 5e-4, rel
    with pytest.raises(ValueError):
        jax.jit(lambda xa, ca, sa: sp.nufft3(xa, ca, sa, method="fast"))(
            jnp.asarray(x), jnp.asarray(c), jnp.asarray(s)
        )
    with pytest.raises(ValueError):
        sp.nufft3(x, c, s, method="??")


def test_nufft3_auto_dispatch(rng):
    """method='auto' picks by the space-bandwidth cost model: dense when
    S·X makes the inner grid enormous, fast when M·K dwarfs the grid work
    (at M=K=4096, S·X=1024π the fast path's inner grid is ~16384²)."""
    from mixed_radix_fast_fourier_transform_tpu.ops.nufft import (
        _type3_fast_wins,
    )

    # M=K=4096, S·X = 1024π per axis (the bench shape): dense must win
    assert not _type3_fast_wins(1e-6, 2, 4096, 4096,
                                (1024 * np.pi, 1024 * np.pi))
    # M=K=65536, S·X = 128π per axis: the dense matrix is 4.3e9 entries;
    # fast must win
    assert _type3_fast_wins(1e-6, 2, 65536, 65536,
                            (128 * np.pi, 128 * np.pi))
    # 1-D analogues: a single-axis grid is cheap, so fast wins at much
    # smaller M·K than in 2-D — dense only keeps small point sets
    assert not _type3_fast_wins(1e-6, 1, 256, 256, (4096 * np.pi,))
    assert _type3_fast_wins(1e-6, 1, 1 << 20, 1 << 20, (64 * np.pi,))

    # auto matches the oracle regardless of which branch it takes
    m, kf = 160, 120
    x = rng.uniform(-5.0, 5.0, m).astype(np.float32)
    s = rng.uniform(-8.0, 8.0, kf).astype(np.float32)
    c = _strengths(rng, m)
    got = np.asarray(sp.nufft3(x, c, s, method="auto"))
    want = np.exp(-1j * np.outer(s.astype(np.float64),
                                 x.astype(np.float64))) @ c.astype(np.complex128)
    rel = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert rel < 5e-4, rel

    # under jit WITHOUT extents auto cannot size the grid: it must fall
    # back to dense (not raise, unlike method='fast')
    import jax
    import jax.numpy as jnp

    got_j = np.asarray(jax.jit(
        lambda xa, ca, sa: sp.nufft3(xa, ca, sa, method="auto")
    )(jnp.asarray(x), jnp.asarray(c), jnp.asarray(s)))
    dense = np.asarray(sp.nufft3(x, c, s, method="dense"))
    # same dense algorithm; jit-vs-eager fusion differences are fp-level
    # (the FAST branch would differ by ~1e-4-class kernel truncation)
    assert np.max(np.abs(got_j - dense)) / np.max(np.abs(dense)) < 1e-6


def test_nufft3_2d_auto_matches_oracle(rng):
    m, kf = 90, 70
    x = rng.uniform(-2.0, 2.0, m).astype(np.float32)
    y = rng.uniform(-3.0, 3.0, m).astype(np.float32)
    s = rng.uniform(-4.0, 4.0, kf).astype(np.float32)
    t = rng.uniform(-2.5, 2.5, kf).astype(np.float32)
    c = _strengths(rng, m)
    got = np.asarray(sp.nufft3_2d(x, y, c, s, t, method="auto"))
    ph = np.outer(s.astype(np.float64), x.astype(np.float64)) + np.outer(
        t.astype(np.float64), y.astype(np.float64))
    want = np.exp(-1j * ph) @ c.astype(np.complex128)
    rel = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert rel < 5e-4, rel


def test_nufft3_fast_explicit_centers(rng):
    """Off-centre data with explicit extents must work when centers are
    passed (and the isign guard rejects |isign| != 1)."""
    m, kf = 100, 80
    x = rng.uniform(0.0, 10.0, m).astype(np.float32)
    s = rng.uniform(0.0, 16.0, kf).astype(np.float32)
    c = _strengths(rng, m)
    got = np.asarray(
        sp.nufft3(x, c, s, method="fast", x_extent=5.0, s_extent=8.0,
                  x_center=5.0, s_center=8.0)
    )
    want = np.exp(-1j * np.outer(s.astype(np.float64), x.astype(np.float64))) @ c.astype(np.complex128)
    rel = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert rel < 5e-4, rel
    with pytest.raises(ValueError):
        sp.nufft3(x, c, s, isign=2)


def test_nufft_lsq_jittable(rng):
    import jax
    import jax.numpy as jnp

    n, m = 16, 48
    x = _pts(rng, m)
    f_true = _strengths(rng, n)
    b = np.asarray(sp.nufft2(x, f_true, isign=+1)).astype(np.complex64)
    got = np.asarray(
        jax.jit(lambda bb: sp.nufft_lsq(jnp.asarray(x), bb, n, iters=40))(b)
    )
    assert np.max(np.abs(got - f_true)) / np.max(np.abs(f_true)) < 1e-3


def test_spread_point_chunking_matches_unchunked(rng):
    """M > _POINT_CHUNK routes through the scanned engine; results must
    match the unchunked path exactly (same arithmetic, different tiling)."""
    import jax.numpy as jnp

    from mixed_radix_fast_fourier_transform_tpu.ops import nufft as nf

    m = nf._POINT_CHUNK + 173  # force the scan path with a ragged tail
    x = rng.uniform(0, 2 * np.pi, m).astype(np.float32)
    c = (rng.standard_normal(m) + 1j * rng.standard_normal(m)).astype(
        np.complex64
    )
    mr, tau, msp = nf._grid_params(512, 1e-6)
    big = np.asarray(nf._spread(jnp.asarray(x), jnp.asarray(c), mr, tau, msp))
    # unchunked reference: same math on the first/last chunk-sized splits
    parts = [
        np.asarray(nf._spread(jnp.asarray(x[i]), jnp.asarray(c[i]), mr, tau, msp))
        for i in (slice(0, 3000), slice(3000, m))
    ]
    np.testing.assert_allclose(big, parts[0] + parts[1], rtol=0, atol=1e-3)
    # adjoint consistency through the chunked interp
    u = (rng.standard_normal(mr) + 1j * rng.standard_normal(mr)).astype(
        np.complex64
    )
    got = np.asarray(nf._interp(jnp.asarray(u), jnp.asarray(x), mr, tau, msp))
    ref = np.concatenate([
        np.asarray(nf._interp(jnp.asarray(u), jnp.asarray(x[i]), mr, tau, msp))
        for i in (slice(0, 3000), slice(3000, m))
    ])
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_block_size_caps_block_count():
    from mixed_radix_fast_fourier_transform_tpu.ops.nufft import (
        _MAX_BLOCKS, _block_size,
    )

    for mr in (64, 8192, 1 << 20):
        for d in (1, 2, 3):
            s = _block_size(mr, 32 if d < 3 else 8, d)
            assert mr % s == 0
            assert mr // s <= _MAX_BLOCKS[d]


def test_nufft_lsq_3d_recovers_modes(rng):
    """3-D least-squares inverse recovers band-limited volumetric modes."""
    nm = (6, 5, 4)
    n_total = nm[0] * nm[1] * nm[2]
    m = 4 * n_total
    x = rng.uniform(0, 2 * np.pi, m).astype(np.float32)
    y = rng.uniform(0, 2 * np.pi, m).astype(np.float32)
    z = rng.uniform(0, 2 * np.pi, m).astype(np.float32)
    f_true = (rng.standard_normal(nm) + 1j * rng.standard_normal(nm)).astype(
        np.complex64
    )
    from mixed_radix_fast_fourier_transform_tpu.ops.nufft import nudft2_3d

    b = np.asarray(nudft2_3d(x, y, z, f_true))
    got = np.asarray(sp.nufft_lsq_3d(x, y, z, b, nm, iters=40))
    scale = np.abs(f_true).max()
    assert np.max(np.abs(got - f_true)) / scale < 1e-3


# ---------------------------------------------------------------------------
# Sorted-segment spreading engine (opt-in; auto-dispatch disabled, see the
# section comment in ops/nufft.py).  Kept correct as the bounded-memory fallback and as an
# independent reference implementation for the block path.
# ---------------------------------------------------------------------------


@pytest.mark.slow  # sorted-spread engine: opt-in oracle path
# (auto-dispatch disabled) — slow-lane coverage
def test_spread_sorted_1d_matches_block(rng):
    from mixed_radix_fast_fourier_transform_tpu.ops import nufft as nf

    m, n = 20000, 256
    mr, tau, msp = nf._grid_params(n, 1e-6)
    x = _pts(rng, m)
    c = _strengths(rng, m)
    s = nf._block_size(mr, nf._SPREAD_BLOCK, 1)
    b, a = nf._block_local(x, mr, tau, msp, s)
    g_block = np.asarray(
        nf._halo_to_grid(nf._spread_blocks([a], c, b, mr // s), s, msp, mr)
    )
    g_sorted = np.asarray(nf._spread_sorted(x, c, mr, tau, msp))
    scale = np.abs(g_block).max()
    assert np.max(np.abs(g_block - g_sorted)) / scale < 5e-6


@pytest.mark.slow  # sorted-spread engine: opt-in oracle path
# (auto-dispatch disabled) — slow-lane coverage
def test_spread_sorted_batched_strengths(rng):
    from mixed_radix_fast_fourier_transform_tpu.ops import nufft as nf

    m, n = 4000, 64
    mr, tau, msp = nf._grid_params(n, 1e-6)
    x = _pts(rng, m)
    c = _strengths(rng, 3, m)
    g = np.asarray(nf._spread_sorted(x, c, mr, tau, msp))
    g0 = np.asarray(nf._spread_sorted(x, c[1], mr, tau, msp))
    assert g.shape == (3, mr)
    np.testing.assert_allclose(g[1], g0, rtol=0, atol=1e-5 * np.abs(g0).max())


@pytest.mark.slow  # sorted-spread engine: opt-in oracle path
# (auto-dispatch disabled) — slow-lane coverage
def test_nufft1_sorted_dispatch_matches_oracle(rng, monkeypatch):
    from mixed_radix_fast_fourier_transform_tpu.ops import nufft as nf

    m, n = 6000, 96
    x = _pts(rng, m)
    c = _strengths(rng, m)
    ref = _oracle1(x, c, n)
    monkeypatch.setattr(nf, "_SORTED_MIN_M", 1)
    got = np.asarray(sp.nufft1(x, c, n, eps=1e-6, method="grid"))
    scale = np.abs(ref).max()
    assert np.max(np.abs(got - ref)) / scale < 1e-5


@pytest.mark.slow  # sorted-spread engine: opt-in oracle path
# (auto-dispatch disabled) — slow-lane coverage
def test_nufft1_2d_sorted_dispatch_matches_dense(rng, monkeypatch):
    from mixed_radix_fast_fourier_transform_tpu.ops import nufft as nf

    m, nm = 8000, (24, 36)
    x, y = _pts(rng, m), _pts(rng, m)
    c = _strengths(rng, m)
    ref = np.asarray(sp.nufft1_2d(x, y, c, nm, method="dense"))
    monkeypatch.setattr(nf, "_SORTED_MIN_M_2D", 1)
    got = np.asarray(sp.nufft1_2d(x, y, c, nm, eps=1e-6, method="grid"))
    scale = np.abs(ref).max()
    assert np.max(np.abs(got - ref)) / scale < 1e-5


@pytest.mark.slow  # sorted-spread engine: opt-in oracle path
# (auto-dispatch disabled) — slow-lane coverage
def test_seg_sum_sorted_compensated_accuracy(rng):
    """The double-word prefix carry keeps segment sums near fp64 accuracy
    even when prefix magnitudes are ~M x the per-segment results."""
    import jax.numpy as jnp

    from mixed_radix_fast_fourier_transform_tpu.ops.nufft import (
        _seg_sum_sorted,
    )

    m, nseg = 1 << 15, 64
    v = rng.standard_normal(m).astype(np.float32) + 1.0  # biased: big prefixes
    bnd = np.linspace(0, m, nseg + 1).astype(np.int32)
    si, ei = bnd[:-1], bnd[1:]
    got = np.asarray(_seg_sum_sorted(jnp.asarray(v), jnp.asarray(si), jnp.asarray(ei)))
    ref = np.add.reduceat(v.astype(np.float64), si)
    err = np.max(np.abs(got - ref) / np.maximum(np.abs(ref), 1.0))
    assert err < 1e-6
    # a naive fp32 cumsum-difference is measurably worse on the same data
    cs = np.concatenate([[0.0], np.cumsum(v, dtype=np.float32)])
    naive = cs[ei] - cs[si]
    naive_err = np.max(np.abs(naive - ref) / np.maximum(np.abs(ref), 1.0))
    assert err < naive_err


class TestNufft3_2D:
    @staticmethod
    def _oracle(x, y, c, s, t, isign=-1):
        th = isign * (
            s[:, None] * x[None, :].astype(np.float64)
            + t[:, None] * y[None, :].astype(np.float64)
        )
        return np.exp(1j * th) @ c.astype(np.complex128)

    @staticmethod
    def _data(rng, M=300, K=250):
        x = rng.uniform(-1.5, 1.5, M).astype(np.float32)
        y = rng.uniform(-2.0, 2.0, M).astype(np.float32)
        c = (rng.standard_normal(M) + 1j * rng.standard_normal(M)).astype(
            np.complex64
        )
        s = rng.uniform(-20, 20, K).astype(np.float32)
        t = rng.uniform(-15, 15, K).astype(np.float32)
        return x, y, c, s, t

    def test_dense_matches_oracle(self, rng):
        x, y, c, s, t = self._data(rng)
        for isign in (-1, 1):
            got = np.asarray(sp.nufft3_2d(x, y, c, s, t, isign=isign))
            want = self._oracle(x, y, c, s, t, isign)
            assert np.abs(got - want).max() / np.abs(want).max() < 1e-5

    def test_fast_matches_oracle(self, rng):
        x, y, c, s, t = self._data(rng)
        for isign in (-1, 1):
            got = np.asarray(
                sp.nufft3_2d(x, y, c, s, t, isign=isign, method="fast")
            )
            want = self._oracle(x, y, c, s, t, isign)
            assert np.abs(got - want).max() / np.abs(want).max() < 1e-4

    def test_fast_offset_coordinates(self, rng):
        x, y, c, s, t = self._data(rng, M=200, K=150)
        x = x + 10.0
        s = s + 50.0
        got = np.asarray(sp.nufft3_2d(x, y, c, s, t, method="fast"))
        want = self._oracle(x, y, c, s, t)
        assert np.abs(got - want).max() / np.abs(want).max() < 1e-3

    def test_fast_jit_static_extents(self, rng):
        import jax

        x, y, c, s, t = self._data(rng, M=120, K=90)
        f = jax.jit(
            lambda xa, ya, ca, sa, ta: sp.nufft3_2d(
                xa, ya, ca, sa, ta, method="fast",
                x_extent=1.5, y_extent=2.0, s_extent=20.0, t_extent=15.0,
            )
        )
        got = np.asarray(f(x, y, c, s, t))
        want = self._oracle(x, y, c, s, t)
        assert np.abs(got - want).max() / np.abs(want).max() < 1e-4
        with pytest.raises(ValueError):
            jax.jit(
                lambda xa, ya, ca, sa, ta: sp.nufft3_2d(
                    xa, ya, ca, sa, ta, method="fast"
                )
            )(x, y, c, s, t)

    def test_errors(self, rng):
        x, y, c, s, t = self._data(rng, M=20, K=10)
        with pytest.raises(ValueError):
            sp.nufft3_2d(x, y, c, s, t, method="??")
        with pytest.raises(ValueError):
            sp.nufft3_2d(x, y[:-1], c, s, t)
        with pytest.raises(ValueError):
            sp.nufft3_2d(x, y, c, s, t[:-1])
        with pytest.raises(ValueError):
            sp.nufft3_2d(x, y, c, s, t, isign=0)


class TestNufft3_3D:
    @staticmethod
    def _data(rng, M=250, K=180):
        x, y, z = (
            rng.uniform(-a, a, M).astype(np.float32) for a in (1.5, 2.0, 1.0)
        )
        c = (rng.standard_normal(M) + 1j * rng.standard_normal(M)).astype(
            np.complex64
        )
        s, t, u = (
            rng.uniform(-b, b, K).astype(np.float32) for b in (12, 10, 15)
        )
        th = -(
            s[:, None] * x[None, :].astype(np.float64)
            + t[:, None] * y[None, :].astype(np.float64)
            + u[:, None] * z[None, :].astype(np.float64)
        )
        want = np.exp(1j * th) @ c.astype(np.complex128)
        return x, y, z, c, s, t, u, want

    def test_dense_and_fast_match_oracle(self, rng):
        x, y, z, c, s, t, u, want = self._data(rng)
        dense = np.asarray(sp.nufft3_3d(x, y, z, c, s, t, u))
        assert np.abs(dense - want).max() / np.abs(want).max() < 1e-5
        fast = np.asarray(sp.nufft3_3d(x, y, z, c, s, t, u, method="fast"))
        assert np.abs(fast - want).max() / np.abs(want).max() < 1e-4

    def test_fast_jit_static_extents(self, rng):
        import jax

        x, y, z, c, s, t, u, want = self._data(rng, M=120, K=80)
        f = jax.jit(
            lambda *a: sp.nufft3_3d(
                *a, method="fast",
                extents=(1.5, 2.0, 1.0, 12.0, 10.0, 15.0),
            )
        )
        got = np.asarray(f(x, y, z, c, s, t, u))
        assert np.abs(got - want).max() / np.abs(want).max() < 1e-4
        with pytest.raises(ValueError):
            jax.jit(lambda *a: sp.nufft3_3d(*a, method="fast"))(
                x, y, z, c, s, t, u
            )

    def test_errors(self, rng):
        x, y, z, c, s, t, u, _ = self._data(rng, M=20, K=10)
        with pytest.raises(ValueError):
            sp.nufft3_3d(x, y, z, c, s, t, u, method="??")
        with pytest.raises(ValueError):
            sp.nufft3_3d(x, y, z, c, s, t, u[:-1])
        with pytest.raises(ValueError):
            sp.nufft3_3d(x, y, z, c, s, t, u, method="fast",
                         extents=(1.0, 2.0))


def test_nufft3_fast_batched_strengths(rng):
    """Fast type-3 paths must honor leading batch axes of c (round-3
    review: the flattened tap gather silently read batch 0 only)."""
    M, K = 120, 80
    x = rng.uniform(-1.5, 1.5, M).astype(np.float32)
    y = rng.uniform(-2.0, 2.0, M).astype(np.float32)
    z = rng.uniform(-1.0, 1.0, M).astype(np.float32)
    c = (rng.standard_normal((3, M)) + 1j * rng.standard_normal((3, M))).astype(
        np.complex64
    )
    s = rng.uniform(-20, 20, K).astype(np.float32)
    t = rng.uniform(-15, 15, K).astype(np.float32)
    u = rng.uniform(-10, 10, K).astype(np.float32)
    f2 = np.asarray(sp.nufft3_2d(x, y, c, s, t, method="fast"))
    d2 = np.asarray(sp.nufft3_2d(x, y, c, s, t))
    assert f2.shape == (3, K)
    assert np.abs(f2 - d2).max() / np.abs(d2).max() < 1e-4
    f3 = np.asarray(sp.nufft3_3d(x, y, z, c, s, t, u, method="fast"))
    d3 = np.asarray(sp.nufft3_3d(x, y, z, c, s, t, u))
    assert f3.shape == (3, K)
    assert np.abs(f3 - d3).max() / np.abs(d3).max() < 1e-4


def test_nufft_3d_grid_batched_strengths(rng):
    """3-D grid paths with batch axes: fftn/ifftn must transform only the
    trailing mode axes (round-3 review: default axes swallowed the batch
    axis)."""
    M = 100
    x = rng.uniform(0, 2 * np.pi, M).astype(np.float32)
    y = rng.uniform(0, 2 * np.pi, M).astype(np.float32)
    z = rng.uniform(0, 2 * np.pi, M).astype(np.float32)
    c = (rng.standard_normal((2, M)) + 1j * rng.standard_normal((2, M))).astype(
        np.complex64
    )
    got = np.asarray(sp.nufft1_3d(x, y, z, c, (12, 12, 12), method="grid"))
    want = np.asarray(sp.nudft1_3d(x, y, z, c, (12, 12, 12)))
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-4
    f = (rng.standard_normal((2, 12, 12, 12))
         + 1j * rng.standard_normal((2, 12, 12, 12))).astype(np.complex64)
    got = np.asarray(sp.nufft2_3d(x, y, z, f, method="grid"))
    want = np.asarray(sp.nudft2_3d(x, y, z, f))
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-4
