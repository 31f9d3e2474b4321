"""Spherical harmonic transform — Legendre matmuls + engine FFT.

Capability extension beyond the reference C library (1-D line transforms
only): the analysis/synthesis pair between values on a Gauss-Legendre x
equiangular sphere grid and spherical-harmonic coefficients — the spectral
basis of global weather/climate dynamical cores and geodesy.

Device shape: the longitude direction is the engine's batched FFT; the
latitude direction contracts against precomputed normalized associated
Legendre tables P̄_{lm}(mu_i) (stable three-term recurrence, Condon-Shortley
phase, matching scipy.special.sph_harm_y) applied as einsums.  The
tables are stored **triangularly chunked over m for the m >= 0 half only**
(P̄_{l,-m} = (-1)^m P̄_{lm} folds the negative-m bins into sign flips on the
coefficients, and rows with l < m are identically zero) — ~L³/2 fp32 values
total instead of the dense (2L-1, L, L) fp64 tensor a naive layout needs
(8x: e.g. 268 MB vs 2.1 GB at L = 512), with O(L²) host memory during
generation.  With
nlat = L Gauss-Legendre nodes and nlon = 2L longitudes the transform pair
is EXACT for band-limited fields (Gauss quadrature integrates the degree
<= 2L-2 Legendre products exactly; round-trip error ~6e-15 in the fp64
prototype, engine fp32 floor otherwise; projection error ~1.6e-7 with
the chunked tables).

Three execution paths: the chunked tables (default, fastest, ~L³/2 fp32
storage — practical to ~L=1024); the REAL-field Hermitian fast paths
(``sht`` of real input / ``isht(real_output=True)``: rfft/irfft longitude
+ half the Legendre work via a_{l,-m} = (-1)^m conj(a_{lm})); and the
on-device recurrence pair :func:`sht_recurrence` / :func:`isht_recurrence`
(O(L²) memory, exponent-rescaled lax.scan — arbitrary band limit).

Conventions: orthonormal complex spherical harmonics Y_lm with
Condon-Shortley phase; a = sht(f) has a[m_idx, l] = ∫ f Y*_lm dΩ with the
m axis packed [0, 1, …, L-1, -(L-1), …, -1] (FFT-bin order restricted to
the band limit) and zeros for l < |m|.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.config import DEFAULT_CONFIG, SpectralConfig
from .fft import fft, ifft

Array = jax.Array


# m-axis tile of the triangular Legendre chunks: each chunk holds
# _M_TILE m-rows sharing one l >= m0 slice, so stored volume ~= L**3/2.
_M_TILE = 128
# Band limit above which sht/isht auto-dispatch to the O(L^2)-memory
# recurrence path: the chunked tables reach ~2.1 GB fp32 at L = 1024;
# beyond that the (slower but memory-flat) scan is the only option.
_TABLES_MAX_L = 1024


@functools.lru_cache(maxsize=16)
def _gauss_grid(L: int):
    """Gauss-Legendre nodes, weights and colatitudes (host fp64)."""
    mu, w = np.polynomial.legendre.leggauss(L)
    return mu, w, np.arccos(mu)


@functools.lru_cache(maxsize=16)
def _eq_grid(L: int):
    """Equiangular (Driscoll-Healy-class) latitude grid for band limit
    lmax = L-1: nlat = 2L midpoint colatitudes theta_j = pi(2j+1)/(4L) with
    Fejér-type quadrature weights derived by DST orthogonality — exact for
    every Legendre moment of degree < 2L (verified to machine precision),
    so the analysis is exact for band-limited fields like the Gauss grid,
    at twice the latitude count."""
    n = 2 * L
    j = np.arange(n)
    theta = np.pi * (2.0 * j + 1.0) / (2.0 * n)
    m = np.arange(1, n + 1)
    beta = np.where(m % 2 == 1, 2.0 / m, 0.0)
    c = (2.0 / n) * (np.sin(np.outer(theta, m)) @ beta)
    return np.cos(theta), c * np.sin(theta), theta


_GRIDS = ("gauss", "equiangular")


def _grid_arrays(L: int, grid: str):
    if grid == "gauss":
        return _gauss_grid(L)
    if grid == "equiangular":
        return _eq_grid(L)
    raise ValueError(f"grid must be one of {_GRIDS}, got {grid!r}")


def _host_recurrence_tables(L: int, grid: str = "gauss"):
    """Host fp64 (L, L) recurrence coefficients A[l, m], B[l, m] (zero
    where invalid) and sectoral seeds pmm[m, i] — shared by the vectorized
    table builders (one numpy plane op per l instead of an O(L²) Python
    loop)."""
    mu, _, _ = _grid_arrays(L, grid)
    lf = np.arange(L, dtype=np.float64)[:, None]
    mf = np.arange(L, dtype=np.float64)[None, :]
    with np.errstate(divide="ignore", invalid="ignore"):
        A = np.sqrt((4.0 * lf * lf - 1.0) / (lf * lf - mf * mf))
        B = np.sqrt(
            ((2.0 * lf + 1.0) * ((lf - 1.0) ** 2 - mf * mf))
            / ((2.0 * lf - 3.0) * (lf * lf - mf * mf))
        )
    A = np.where(lf > mf, A, 0.0)
    B = np.where(lf > mf + 1, B, 0.0)
    st = np.sqrt(np.clip(1.0 - mu * mu, 0.0, None))
    pmm = np.empty((L, len(mu)))
    pmm[0] = 1.0 / math.sqrt(4.0 * math.pi)
    for m in range(1, L):
        pmm[m] = -math.sqrt((2.0 * m + 1.0) / (2.0 * m)) * st * pmm[m - 1]
    return A, B, pmm, mu


def _legendre_l_iter(L: int, grid: str = "gauss"):
    """Yield (l, P_l, P_{l-1}) with P_l the fp64 (m, i) Legendre plane —
    the l-major vectorized march (rows m > l are zero)."""
    A, B, pmm, mu = _host_recurrence_tables(L, grid)
    p1 = np.zeros((L, len(mu)))
    p2 = np.zeros((L, len(mu)))
    for l in range(L):
        p = A[l][:, None] * mu[None, :] * p1 - B[l][:, None] * p2
        p[l] = pmm[l]  # sectoral seed at m == l
        yield l, p, p1
        p2, p1 = p1, p


def _chunk_shells(L: int, nlat: int):
    """Empty triangular fp32 chunk set [(m0, (t, L-m0, nlat))…]."""
    out = []
    for m0 in range(0, L, _M_TILE):
        t = min(_M_TILE, L - m0)
        out.append((m0, np.zeros((t, L - m0, nlat), np.float32)))
    return out


def _fill_chunks(L: int, plane_iter, nlat: int):
    """Fill triangular chunks from an l-major (l, plane) iterator."""
    chunks = _chunk_shells(L, nlat)
    for l, plane in plane_iter:
        for m0, arr in chunks:
            if l >= m0:
                arr[:, l - m0, :] = plane[m0 : m0 + arr.shape[0]]
    return tuple(chunks)


@functools.lru_cache(maxsize=8)
def _legendre_chunks(L: int, grid: str = "gauss"):
    """Triangular m >= 0 Legendre chunks for band limit lmax = L-1 (fp32;
    negative orders fold in via P̄_{l,-m} = (-1)^m P̄_{lm} at the
    coefficient level — see :func:`_analyze` / :func:`_synthesize`)."""
    nlat = L if grid == "gauss" else 2 * L
    return _fill_chunks(
        L, ((l, p) for l, p, _ in _legendre_l_iter(L, grid)), nlat
    )


def _neg_signs(L: int) -> np.ndarray:
    """(-1)^m for m = 0..L-1 (the conj-relation parity of the folded
    negative orders)."""
    return (-1.0) ** np.arange(L, dtype=np.float64)


def sht_grid(lmax: int, dtype=np.float64, grid: str = "gauss"):
    """(theta, phi, weights) of the analysis grid for band limit ``lmax``
    (L = lmax+1): ``grid="gauss"`` is (L, 2L) Gauss-Legendre colatitudes x
    equiangular longitudes; ``grid="equiangular"`` is (2L, 2L) midpoint
    equiangular colatitudes with Fejér-type weights (Driscoll-Healy-class
    — for data that arrives on lat-lon grids).  Quadrature:
    sum(f * weights[:, None]) * (2*pi/nlon) integrates over the sphere."""
    if lmax < 0:
        raise ValueError(f"lmax must be >= 0, got {lmax}")
    L = lmax + 1
    _, w, theta = _grid_arrays(L, grid)
    phi = 2.0 * np.pi * np.arange(2 * L) / (2 * L)
    return theta.astype(dtype), phi.astype(dtype), w.astype(dtype)


def _select_packed_m(F: Array, L: int) -> Array:
    """Restrict full FFT longitude bins to the band limit in packed m order
    [0..L-1, -(L-1)..-1] (the Nyquist bin L of the 2L-point FFT is dropped —
    the single convention shared by every analysis op)."""
    return jnp.concatenate([F[..., :L], F[..., L + 1 :]], axis=-1)


def _fold_neg_last(Fsel: Array, L: int) -> Array:
    """Map the packed negative-m bins (last axis) onto ascending positive
    order m' = 0..L-1 with the (-1)^m' parity applied; row m'=0 is zero
    (there is no negative DC)."""
    half = jnp.flip(Fsel[..., L:], axis=-1)  # m' = 1..L-1 ascending
    z = jnp.zeros(Fsel.shape[:-1] + (1,), Fsel.dtype)
    sign = jnp.asarray(_neg_signs(L), Fsel.real.dtype)
    return jnp.concatenate([z, half], axis=-1) * sign


def _analyze(
    chunks, Fsel: Array, weights: np.ndarray, L: int, config,
    hermitian: bool = False,
) -> Array:
    """Latitude contraction of analysis: a[…, q, l] = Σ_i P̄[m, l, i] ·
    weights[i] · F[…, i, q] over the packed q axis, blocked over the
    triangular m chunks (negative orders via the coefficient-side parity
    fold).

    ``hermitian=True`` is the REAL-field fast path: ``Fsel`` carries only
    the m >= 0 bins (…, i, L) from an rfft, and the negative orders come
    from the symmetry a_{l,-m} = (-1)^m conj(a_{lm}) instead of a second
    set of einsums — half the FFT and half the Legendre work."""
    Fw = Fsel * jnp.asarray(weights, Fsel.real.dtype)[:, None]
    fpos = Fw[..., :L]
    srcs = [fpos] if hermitian else [fpos, _fold_neg_last(Fw, L)]
    parts = [[] for _ in srcs]
    for m0, P in chunks:
        t = P.shape[0]
        Pj = jnp.asarray(P, dtype=Fsel.real.dtype)
        pad = [(0, 0)] * (Fsel.ndim - 1) + [(m0, 0)]
        for src, out in zip(srcs, parts):
            part = jnp.einsum(
                "mli,...im->...ml", Pj, src[..., m0 : m0 + t],
                precision=config.op_precision,
            )
            out.append(jnp.pad(part, pad))
    apos = jnp.concatenate(parts[0], axis=-2)  # (…, L, L) m-major
    if hermitian:
        sign = jnp.asarray(_neg_signs(L), apos.real.dtype)
        aneg = jnp.conj(apos) * sign[:, None]
    else:
        aneg = jnp.concatenate(parts[1], axis=-2)
    # packed bins: [m=0..L-1, m=-(L-1)..-1] — negative rows reversed back
    return jnp.concatenate([apos, jnp.flip(aneg[..., 1:, :], axis=-2)], axis=-2)


def sht(f, *, grid: str = "gauss", config: SpectralConfig = DEFAULT_CONFIG) -> Array:
    """Spherical harmonic analysis -> (…, 2L-1, L) coefficients a[m_idx, l]
    (packed m axis, zeros below the |m| diagonal).  Input grid per
    ``grid``: "gauss" expects (…, L, 2L); "equiangular" expects the square
    (…, 2L, 2L) Driscoll-Healy-class grid of :func:`sht_grid` — both exact
    for band-limited fields."""
    f = jnp.asarray(f)
    if grid == "equiangular":
        if (
            f.ndim < 2 or f.shape[-1] < 2 or f.shape[-2] != f.shape[-1]
            or f.shape[-1] % 2
        ):
            raise ValueError(
                "equiangular f must be even-square (…, 2L, 2L) — got "
                f"{f.shape[-2:] if f.ndim >= 2 else f.shape}"
            )
        L = f.shape[-1] // 2
    else:
        if f.ndim < 2 or f.shape[-2] < 1 or f.shape[-1] != 2 * f.shape[-2]:
            raise ValueError(
                "f must be (…, L, 2L) on the sht_grid — got "
                f"{f.shape[-2:] if f.ndim >= 2 else f.shape}"
            )
        L = f.shape[-2]
    if L > _TABLES_MAX_L:
        if grid != "gauss":
            raise ValueError(
                f"equiangular sht is table-based and capped at L={_TABLES_MAX_L} "
                f"(got L={L}); the O(L^2)-memory recurrence path is Gauss-grid "
                "only — resample to the Gauss grid for larger band limits"
            )
        return sht_recurrence(f, config=config)
    _, w, _ = _grid_arrays(L, grid)
    dphi = 2.0 * math.pi / (2 * L)
    if not jnp.issubdtype(f.dtype, jnp.complexfloating):
        # real-field fast path: rfft bins 0..L cover all orders by the
        # Hermitian symmetry a_{l,-m} = (-1)^m conj(a_{lm})
        from .rfft import rfft as _rfft

        Fpos = _rfft(f, config=config)[..., :L]  # (…, i, L)
        return _analyze(
            _legendre_chunks(L, grid), Fpos, w * dphi, L, config,
            hermitian=True,
        )
    F = fft(f, config=config)  # over longitude: (…, i, m_bins)
    Fsel = _select_packed_m(F, L)  # (…, i, 2L-1)
    return _analyze(_legendre_chunks(L, grid), Fsel, w * dphi, L, config)


def isht(
    alm, *, real_output: bool = False, grid: str = "gauss",
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Spherical harmonic synthesis: (…, 2L-1, L) coefficients -> grid
    values (complex; take .real for real fields) — (…, L, 2L) for
    ``grid="gauss"``, (…, 2L, 2L) for ``grid="equiangular"``.

    ``real_output=True`` is the fast path for coefficients with the
    real-field symmetry a_{l,-m} = (-1)^m conj(a_{lm}) (e.g. anything
    produced by ``sht`` of a real field, scaled by real per-degree
    factors): only the m >= 0 bins are synthesized and longitude runs
    through irfft — half the Legendre work, real result.  The negative-m
    coefficients are IGNORED under this flag; passing asymmetric
    coefficients silently drops their asymmetric part."""
    alm = jnp.asarray(alm)
    if alm.ndim < 2 or alm.shape[-1] < 1 or alm.shape[-2] != 2 * alm.shape[-1] - 1:
        raise ValueError(
            "alm must be (…, 2L-1, L) packed coefficients — got "
            f"{alm.shape[-2:] if alm.ndim >= 2 else alm.shape}"
        )
    L = alm.shape[-1]
    if L > _TABLES_MAX_L:
        if grid != "gauss":
            raise ValueError(
                f"equiangular isht is table-based and capped at L={_TABLES_MAX_L} "
                f"(got L={L}); the O(L^2)-memory recurrence path is Gauss-grid "
                "only — synthesize on the Gauss grid for larger band limits"
            )
        return isht_recurrence(alm, real_output=real_output, config=config)
    return _synthesize(
        _legendre_chunks(L, grid), alm, config, hermitian=real_output
    )


def sphere_laplacian(f, *, grid: str = "gauss", config: SpectralConfig = DEFAULT_CONFIG) -> Array:
    """Laplace-Beltrami operator on the unit sphere via the spectral
    eigenrelation Δ Y_lm = -l(l+1) Y_lm: sht -> scale -> isht.  The spectral
    building block of spherical PDE solvers (shallow-water cores etc.)."""
    f = jnp.asarray(f)
    a = sht(f, grid=grid, config=config)
    L = a.shape[-1]
    l = np.arange(L, dtype=np.float64)
    scale = jnp.asarray(-(l * (l + 1.0)), dtype=a.real.dtype)
    if not jnp.issubdtype(f.dtype, jnp.complexfloating):
        # real field: symmetric coefficients -> half-work irfft synthesis
        return isht(a * scale, real_output=True, grid=grid, config=config)
    return isht(a * scale, grid=grid, config=config)


def poisson_solve_sphere(
    f, *, grid: str = "gauss", config: SpectralConfig = DEFAULT_CONFIG
) -> Array:
    """Solve Δu = f on the unit sphere (zero-mean gauge): divide each
    spherical-harmonic coefficient by -l(l+1); the l = 0 mode (sphere mean)
    is projected out — solvability requires ∫ f dΩ = 0, and the returned u
    has zero mean.  Grid in, grid out (the spherical counterpart of
    :func:`..signal.poisson_solve`)."""
    f = jnp.asarray(f)
    a = sht(f, grid=grid, config=config)
    L = a.shape[-1]
    l = np.arange(L, dtype=np.float64)
    inv = np.zeros(L)
    inv[1:] = -1.0 / (l[1:] * (l[1:] + 1.0))
    ai = a * jnp.asarray(inv, dtype=a.real.dtype)
    if not jnp.issubdtype(f.dtype, jnp.complexfloating):
        return isht(ai, real_output=True, grid=grid, config=config)
    return isht(ai, grid=grid, config=config)


def sphere_convolve(f, bl, *, grid: str = "gauss", config: SpectralConfig = DEFAULT_CONFIG) -> Array:
    """Convolve a sphere field with an isotropic (zonal) kernel: by the
    Funk-Hecke theorem this is diagonal in the harmonic basis — multiply
    a_lm by the kernel's Legendre coefficients ``bl`` (length L, one per
    degree).  Smoothing, spherical heat flow (bl = exp(-l(l+1)t)), Gaussian
    beams etc. in two transforms."""
    f = jnp.asarray(f)
    a = sht(f, grid=grid, config=config)
    L = a.shape[-1]
    b = jnp.asarray(bl)
    if b.shape != (L,):
        raise ValueError(
            f"bl must have one coefficient per degree: shape ({L},), got {b.shape}"
        )
    real_case = not jnp.issubdtype(
        f.dtype, jnp.complexfloating
    ) and not jnp.issubdtype(b.dtype, jnp.complexfloating)
    if real_case:  # real field x real kernel keeps the Hermitian symmetry
        return isht(
            a * b.astype(a.dtype), real_output=True, grid=grid, config=config
        )
    return isht(a * b.astype(a.dtype), grid=grid, config=config)


@functools.lru_cache(maxsize=8)
def _legendre_deriv_chunks(L: int, grid: str = "gauss"):
    """Triangular m-chunked d/dtheta tables from the verified identity
    sin(theta)·dP̄_lm/dtheta = l·mu·P̄_lm − e_lm·P̄_{l-1,m},
    e_lm = sqrt((l²−m²)(2l+1)/(2l−1)) (numerically checked vs central
    differences to 1e-8).  Same storage scheme and parity fold as
    :func:`_legendre_chunks` (dtheta differentiation preserves the m parity)."""
    mu, _, theta = _grid_arrays(L, grid)
    s = np.sin(theta)
    lf = np.arange(L, dtype=np.float64)[:, None]
    mf = np.arange(L, dtype=np.float64)[None, :]
    with np.errstate(invalid="ignore"):
        e = np.sqrt(
            (lf * lf - mf * mf) * (2.0 * lf + 1.0) / (2.0 * lf - 1.0)
        )
    e = np.where((lf >= np.maximum(mf, 1.0)), e, 0.0)

    def planes():
        for l, p, p_prev in _legendre_l_iter(L, grid):
            yield l, (l * mu[None, :] * p - e[l][:, None] * p_prev) / s

    return _fill_chunks(L, planes(), len(mu))


def _synthesize(
    chunks, alm: Array, config: SpectralConfig, hermitian: bool = False
) -> Array:
    """Shared synthesis core: contract triangular m-chunked tables against
    (…, 2L-1, L) coefficients, place the m bins, inverse-FFT longitude.

    ``hermitian=True`` is the REAL-output fast path: the coefficients are
    assumed to satisfy a_{l,-m} = (-1)^m conj(a_{lm}) (any alm produced
    from a real field and scaled by real per-degree factors), so only the
    m >= 0 bins are synthesized and the longitude inverse is an irfft —
    half the Legendre work; returns a real grid."""
    L = alm.shape[-1]
    apos = alm[..., :L, :]
    if hermitian:
        srcs = [apos]
    else:
        half = jnp.flip(alm[..., L:, :], axis=-2)  # m' = 1..L-1 ascending
        z = jnp.zeros(alm.shape[:-2] + (1, L), alm.dtype)
        sign = jnp.asarray(_neg_signs(L), alm.real.dtype)
        srcs = [apos, jnp.concatenate([z, half], axis=-2) * sign[:, None]]
    parts = [[] for _ in srcs]
    for m0, P in chunks:
        t = P.shape[0]
        Pj = jnp.asarray(P, dtype=alm.real.dtype)
        for src, out in zip(srcs, parts):
            out.append(
                jnp.einsum(
                    "mli,...ml->...im", Pj, src[..., m0 : m0 + t, m0:],
                    precision=config.op_precision,
                )
            )
    gpos = jnp.concatenate(parts[0], axis=-1)  # (…, i, L)
    nlon = 2 * L
    zeros = jnp.zeros(gpos.shape[:-1] + (1,), gpos.dtype)  # Nyquist bin
    if hermitian:
        from .rfft import irfft as _irfft

        bins = jnp.concatenate([gpos, zeros], axis=-1)  # (…, i, L+1)
        return _irfft(bins, n=nlon, config=config) * nlon
    gneg = jnp.concatenate(parts[1], axis=-1)
    bins = jnp.concatenate(
        [gpos, zeros, jnp.flip(gneg[..., 1:], axis=-1)], axis=-1
    )
    return ifft(bins, config=config) * nlon


def sphere_grad(f, *, grid: str = "gauss", config: SpectralConfig = DEFAULT_CONFIG):
    """Surface gradient on the unit sphere: (u_theta, u_phi) =
    (∂f/∂theta, (1/sin theta)·∂f/∂phi), both grid fields of the same shape
    as ``f`` ((…, L, 2L) for ``grid="gauss"``, (…, 2L, 2L) equiangular).

    Spectral: the theta component synthesizes against d/dtheta Legendre
    tables (:func:`_legendre_deriv_chunks`); the phi component multiplies
    a_lm by i·m and divides by sin(theta) (Gauss-Legendre nodes exclude the
    poles, so the division is well-conditioned).  The building block for
    advection/shallow-water operators on the sphere."""
    f = jnp.asarray(f)
    a = sht(f, grid=grid, config=config)
    L = a.shape[-1]
    u_theta, u_phi = _grad_synth(a, L, config, grid)
    if not jnp.issubdtype(f.dtype, jnp.complexfloating):
        u_theta, u_phi = jnp.real(u_theta), jnp.real(u_phi)
    return u_theta, u_phi


def _check_tangent_shape(u_theta, u_phi, grid: str):
    ok = (
        u_theta.shape == u_phi.shape and u_theta.ndim >= 2
        and (
            u_theta.shape[-2] == u_theta.shape[-1] >= 2
            and u_theta.shape[-1] % 2 == 0
            if grid == "equiangular"
            else u_theta.shape[-1] == 2 * u_theta.shape[-2]
        )
    )
    if not ok:
        want = "(…, 2L, 2L)" if grid == "equiangular" else "(…, L, 2L)"
        raise ValueError(f"u_theta and u_phi must share a {want} grid shape")


def _vector_analysis(
    u_theta: Array, u_phi: Array, config: SpectralConfig,
    grid: str = "gauss",
):
    """Packed-m FFT pickup shared by the vector analysis ops."""
    L = u_theta.shape[-2] if grid == "gauss" else u_theta.shape[-1] // 2
    Ft = fft(u_theta, config=config)
    Fp = fft(u_phi, config=config)
    return L, _select_packed_m(Ft, L), _select_packed_m(Fp, L)


def sphere_div(u_theta, u_phi, *, grid: str = "gauss", config: SpectralConfig = DEFAULT_CONFIG) -> Array:
    """Surface divergence of a tangent vector field:
    div u = (1/sin)·[∂_theta(sin·u_theta) + ∂_phi u_phi], grid in / grid out.

    Computed weakly as the negative adjoint of :func:`sphere_grad`
    (div_lm = -∫ u·∇Y*_lm dΩ — integration by parts has no boundary on the
    sphere), reusing the d/dtheta Legendre tables and Gauss quadrature;
    verified via div(grad f) == sphere_laplacian(f)."""
    u_theta = jnp.asarray(u_theta)
    u_phi = jnp.asarray(u_phi)
    _check_tangent_shape(u_theta, u_phi, grid)
    real_in = not (
        jnp.issubdtype(u_theta.dtype, jnp.complexfloating)
        or jnp.issubdtype(u_phi.dtype, jnp.complexfloating)
    )
    d = _div_coef(u_theta, u_phi, config, grid)
    if real_in:
        return isht(d, real_output=True, grid=grid, config=config)
    return isht(d, grid=grid, config=config)


def _div_coef(
    u_theta: Array, u_phi: Array, config: SpectralConfig,
    grid: str = "gauss",
) -> Array:
    """Divergence in coefficient space (the weak-form adjoint quadrature)."""
    L, Ut, Up = _vector_analysis(u_theta, u_phi, config, grid)
    _, w, theta = _grid_arrays(L, grid)
    dphi = 2.0 * math.pi / (2 * L)
    s = np.sin(theta)
    msigned = np.concatenate([np.arange(L), -np.arange(L - 1, 0, -1)])
    t1 = _analyze(_legendre_deriv_chunks(L, grid), Ut, w * dphi, L, config)
    t2 = _analyze(
        _legendre_chunks(L, grid), Up, (w / s) * dphi, L, config
    ) * jnp.asarray(-1j * msigned, t1.dtype if jnp.issubdtype(
        t1.dtype, jnp.complexfloating) else jnp.complex64)[:, None]
    return -(t1 + t2)


def sphere_vort(u_theta, u_phi, *, grid: str = "gauss", config: SpectralConfig = DEFAULT_CONFIG) -> Array:
    """Radial vorticity of a tangent vector field:
    zeta = (1/sin)·[∂_theta(sin·u_phi) - ∂_phi u_theta] — the divergence of
    the quarter-turned field (u_phi, -u_theta)."""
    return sphere_div(u_phi, -jnp.asarray(u_theta), grid=grid, config=config)


def sphere_helmholtz(
    u_theta, u_phi, *, grid: str = "gauss",
    config: SpectralConfig = DEFAULT_CONFIG,
):
    """Helmholtz decomposition of a tangent field on the sphere:
    u = grad(phi) + k x grad(psi) with velocity potential phi and
    streamfunction psi (both zero-mean grids) — phi = Δ⁻¹ div u,
    psi = Δ⁻¹ vort u, the prognostic variables of spherical dynamical
    cores.  Reconstruct with gp = sphere_grad(phi), gs = sphere_grad(psi):
    (u_theta, u_phi) = (gp[0] - gs[1], gp[1] + gs[0]).

    Works in coefficient space throughout (one analysis pair, two
    syntheses — no cancelling isht/sht round trips)."""
    u_theta = jnp.asarray(u_theta)
    u_phi = jnp.asarray(u_phi)
    real_in = not (
        jnp.issubdtype(u_theta.dtype, jnp.complexfloating)
        or jnp.issubdtype(u_phi.dtype, jnp.complexfloating)
    )
    d = _div_coef(u_theta, u_phi, config, grid)
    z = _div_coef(u_phi, -u_theta, config, grid)  # vorticity: quarter turn
    L = d.shape[-1]
    l = np.arange(L, dtype=np.float64)
    inv = np.zeros(L)
    inv[1:] = -1.0 / (l[1:] * (l[1:] + 1.0))
    inv_j = jnp.asarray(inv, d.real.dtype)
    phi = isht(d * inv_j, real_output=real_in, grid=grid, config=config)
    psi = isht(z * inv_j, real_output=real_in, grid=grid, config=config)
    return phi, psi


def _grad_synth(alm, L: int, config: SpectralConfig, grid: str = "gauss"):
    """Grid components of Σ_lm alm·∇Y_lm (the shared synthesis core of
    :func:`sphere_grad` / :func:`ivsht`): (∂θ part, (1/sinθ)∂φ part).

    Real-dtype coefficients are promoted to complex first — the i·m
    longitude-derivative factor would otherwise be silently truncated to
    zero by the dtype cast (same guard as _div_coef)."""
    if not jnp.issubdtype(alm.dtype, jnp.complexfloating):
        alm = alm.astype(jnp.complex64)
    _, _, theta = _grid_arrays(L, grid)
    msigned = np.concatenate([np.arange(L), -np.arange(L - 1, 0, -1)])
    g_theta = _synthesize(_legendre_deriv_chunks(L, grid), alm, config)
    g_phi = _synthesize(
        _legendre_chunks(L, grid),
        alm * jnp.asarray(1j * msigned, alm.dtype)[:, None],
        config,
    ) / jnp.asarray(np.sin(theta), jnp.float32)[:, None]
    return g_theta, g_phi


def vsht(u_theta, u_phi, *, grid: str = "gauss", config: SpectralConfig = DEFAULT_CONFIG):
    """Vector spherical harmonic analysis: tangent field (…, L, 2L) pair ->
    (spheroidal, toroidal) coefficient arrays, each packed (…, 2L-1, L).

    Expansion u = Σ_lm [ S_lm·∇Y_lm + T_lm·(r̂×∇Y_lm) ] / sqrt(l(l+1))
    (orthonormal vector harmonics; the l = 0 row is identically zero —
    tangent fields have no monopole).  Computed from the weak-form adjoint
    quadratures already underlying :func:`sphere_div` / :func:`sphere_vort`:
    S_lm = -div_lm/λ, T_lm = -vort_lm/λ with λ = sqrt(l(l+1)) — the
    spectral front end of spherical dynamical cores (torch-harmonics'
    RealVectorSHT equivalent)."""
    u_theta = jnp.asarray(u_theta)
    u_phi = jnp.asarray(u_phi)
    _check_tangent_shape(u_theta, u_phi, grid)
    d = _div_coef(u_theta, u_phi, config, grid)
    z = _div_coef(u_phi, -u_theta, config, grid)
    L = d.shape[-1]
    l = np.arange(L, dtype=np.float64)
    inv = np.zeros(L)
    inv[1:] = -1.0 / np.sqrt(l[1:] * (l[1:] + 1.0))
    inv_j = jnp.asarray(inv, d.real.dtype)
    return d * inv_j, z * inv_j


def ivsht(s_lm, t_lm, *, grid: str = "gauss", config: SpectralConfig = DEFAULT_CONFIG):
    """Vector spherical harmonic synthesis (inverse of :func:`vsht`):
    (…, 2L-1, L) spheroidal/toroidal coefficients -> tangent field pair
    (u_theta, u_phi) on the grid selected by ``grid`` ((L, 2L) gauss,
    (2L, 2L) equiangular; complex — take .real for real fields)."""
    s_lm = jnp.asarray(s_lm)
    t_lm = jnp.asarray(t_lm)
    if s_lm.shape != t_lm.shape or s_lm.ndim < 2 or (
        s_lm.shape[-2] != 2 * s_lm.shape[-1] - 1
    ):
        raise ValueError("coefficients must share a (…, 2L-1, L) packed shape")
    L = s_lm.shape[-1]
    l = np.arange(L, dtype=np.float64)
    inv = np.zeros(L)
    inv[1:] = 1.0 / np.sqrt(l[1:] * (l[1:] + 1.0))
    inv_j = jnp.asarray(inv, s_lm.real.dtype)
    gt_s, gp_s = _grad_synth(s_lm * inv_j, L, config, grid)
    gt_t, gp_t = _grad_synth(t_lm * inv_j, L, config, grid)
    # r̂×∇Y = (-(1/sin)∂φY, ∂θY) in (θ, φ) components
    return gt_s - gp_t, gp_s + gt_t


# ---------------------------------------------------------------------------
# On-device Legendre recurrence path (opt-in): O(L²) memory instead of the
# ~L³/2 chunked tables — the arbitrary-band-limit regime (L >= ~2048, where
# even triangular fp32 tables reach GBs).  The l-recurrence runs as a
# lax.scan carrying the (m, i) Legendre plane; values are EXPONENT-RESCALED
# in exact powers of two because the sectoral seeds P̄_mm ~ sin(theta)^m
# underflow fp32 (and even fp64) long before the recurrence grows them back
# to O(1) past the turning point l·sin(theta) ~ m — without rescaling every
# high-m harmonic near the poles would silently vanish.
# ---------------------------------------------------------------------------

_RESCALE = 2.0 ** 60  # exact power-of-two renormalization step


@functools.lru_cache(maxsize=4)
def _sectoral_seeds(L: int):
    """Rescaled sectoral seeds P̄_mm = scaled·2^(-60·k) as fp64 (scaled, k)
    arrays of shape (m, i) — computed in log space so no seed ever
    underflows.  Single source for both the plain fp32 recurrence constants
    (:func:`_recurrence_coeffs`) and their compensated low words
    (:func:`_recurrence_coeffs_dw`).

    log2 P̄_mm = log2(1/sqrt(4pi)) + sum_{j<=m} 0.5·log2((2j+1)/(2j))
                + m·log2(sin(theta))."""
    _, _, theta = _gauss_grid(L)
    st = np.sin(theta)
    j = np.arange(1, L, dtype=np.float64)
    csum = np.concatenate(
        [[0.0], np.cumsum(0.5 * np.log2((2.0 * j + 1.0) / (2.0 * j)))]
    )
    log2_pmm = (
        -0.5 * np.log2(4.0 * np.pi)
        + csum[:, None]
        + np.arange(L, dtype=np.float64)[:, None]
        * np.log2(np.maximum(st, 1e-300))[None, :]
    )  # (m, i)
    k = np.maximum(0, np.ceil(-log2_pmm / 60.0)).astype(np.int32)
    # restore the Condon-Shortley sign (-1)^m lost in log space
    scaled = np.exp2(log2_pmm + 60.0 * k) * ((-1.0) ** np.arange(L))[:, None]
    return scaled, k


@functools.lru_cache(maxsize=4)
def _recurrence_coeffs(L: int):
    """Host O(L²) constants for the on-device recurrence: three-term
    coefficients A[l, m], B[l, m] (zero where invalid), and the sectoral
    seeds as exact (mantissa, k) pairs with P̄_mm = mant·2^(-60·k)."""
    mu, _, _ = _gauss_grid(L)
    A, B, _, _ = _host_recurrence_tables(L)  # single source of the A/B forms
    scaled, k = _sectoral_seeds(L)
    return (
        A.astype(np.float32), B.astype(np.float32),
        scaled.astype(np.float32), k, mu.astype(np.float32),
    )


# -- double-word (compensated) fp32 arithmetic for the exact-carry scan ----
# Error-free transforms from utils/numerics (the canonical shared set).
# Used when ``compensated=True``: the recurrence carry is a (hi, lo) pair,
# so per-step rounding accumulates at eps² instead of eps and the L-step
# scan stays fp32-exact at any band limit (plain-path error grows ~L·eps:
# 3.2e-5 at L=256, 1.6e-4 at L=512 vs the fp64-generated tables).

from ..utils.numerics import dw_add as _dw_add, dw_mul as _dw_mul


@functools.lru_cache(maxsize=4)
def _recurrence_coeffs_dw(L: int):
    """fp32 low words of the recurrence constants (value64 - hi32), so the
    compensated path sees the fp64 coefficients to ~2^-48: (A_lo, B_lo,
    mant_lo, mu_lo).  Without these the singly-rounded fp32 coefficients
    would re-introduce an eps-per-step forward error and cap the win."""
    A, B, _, _ = _host_recurrence_tables(L)
    Ah, Bh, mant, _, mu = _recurrence_coeffs(L)
    mu64, _, _ = _gauss_grid(L)
    # exact seed: mant·2^(-60k) == P̄_mm in fp64 ⇒ lo = (P̄·2^(60k) - mant)
    scaled, _ = _sectoral_seeds(L)
    return (
        (A - Ah.astype(np.float64)).astype(np.float32),
        (B - Bh.astype(np.float64)).astype(np.float32),
        (scaled - mant.astype(np.float64)).astype(np.float32),
        (mu64 - mu.astype(np.float64)).astype(np.float32),
    )


def _legendre_scan(
    L: int, accumulate, acc0, xs_extra, lat=None, compensated=False
):
    """Scan l = 0..L-1 carrying the rescaled (m, i) Legendre plane; at each
    step call ``accumulate(xs_l, p0, acc)`` with p0 the TRUE-scale plane
    (entries whose exponent offset k > 0 are < 2^-60 and passed as 0).
    ``xs_extra`` is a pytree of arrays scanned over their leading L axis.
    ``lat`` optionally overrides the (mu, seed mantissa, seed exponent)
    latitude arrays with per-band slices — the latitude-sharded path (each
    chip scans only its own band; the recurrence is independent per
    latitude); with ``compensated`` the tuple extends to
    (mu, mant, k0, mu_lo, mant_lo).  ``compensated`` carries the Legendre
    plane as a double-word (hi, lo) fp32 pair with double-word constants —
    fp32-exact at any L, ~5-10x the elementwise work of the plain scan."""
    A, B, mant, k0, mu = _recurrence_coeffs(L)
    if compensated:
        A_lo, B_lo, mant_lo, mu_lo = _recurrence_coeffs_dw(L)
    if lat is not None:
        mu, mant, k0 = lat[:3]
        if compensated:
            mu_lo, mant_lo = lat[3], lat[4]
    muj = jnp.asarray(mu)[None, :]
    seed_mask = jnp.asarray(np.eye(L, dtype=bool))  # row l: one-hot at m == l

    def renorm(k, planes):
        # exact power-of-two renorms: up for headroom while tiny, down as
        # the true value re-enters representable range (hi word governs;
        # scaling every word of a double-word pair is exact)
        p, p1 = planes[0], planes[len(planes) // 2]
        mag = jnp.maximum(jnp.abs(p), jnp.abs(p1))
        up = (mag > 0.0) & (mag < 1.0 / _RESCALE)
        planes = tuple(jnp.where(up, q * _RESCALE, q) for q in planes)
        k = jnp.where(up, k + 1, k)
        down = (jnp.abs(planes[0]) > 1.0) & (k > 0)
        planes = tuple(jnp.where(down, q / _RESCALE, q) for q in planes)
        return jnp.where(down, k - 1, k), planes

    def step(carry, xs):
        p1, p2, k, acc = carry
        al, bl, sm, mrow, krow, extra = xs
        p = al[:, None] * muj * p1 - bl[:, None] * p2
        # sectoral seed injection at m == l (carries its own exponent)
        p = jnp.where(sm[:, None], mrow[None, :], p)
        k = jnp.where(sm[:, None], krow[None, :], k)
        k, (p, p1) = renorm(k, (p, p1))
        p0 = jnp.where(k == 0, p, 0.0)
        acc = accumulate(extra, p0, acc)
        return (p, p1, k, acc), None

    mujl = jnp.asarray(mu_lo)[None, :] if compensated else None

    def step_dw(carry, xs):
        p1, p1l, p2, p2l, k, acc = carry
        al, all_, bl, bll, sm, mrow, mrowl, krow, extra = xs
        ch, cl = _dw_mul(al[:, None], all_[:, None], muj, mujl)
        t1h, t1l = _dw_mul(ch, cl, p1, p1l)
        t2h, t2l = _dw_mul(bl[:, None], bll[:, None], p2, p2l)
        p, plo = _dw_add(t1h, t1l, -t2h, -t2l)
        p = jnp.where(sm[:, None], mrow[None, :], p)
        plo = jnp.where(sm[:, None], mrowl[None, :], plo)
        k = jnp.where(sm[:, None], krow[None, :], k)
        k, (p, plo, p1, p1l) = renorm(k, (p, plo, p1, p1l))
        p0 = jnp.where(k == 0, p, 0.0)
        acc = accumulate(extra, p0, acc)
        return (p, plo, p1, p1l, k, acc), None

    ni = muj.shape[-1]
    # tie the zero-initialized carriers to the latitude operand's sharding
    # variance (under shard_map a replicated zeros() init would mismatch
    # the band-varying carry outputs)
    tie = (muj * 0.0).sum()
    z = jnp.zeros((L, ni), jnp.float32) + tie
    acc0 = acc0 + tie.astype(acc0.real.dtype)
    if compensated:
        xs = (
            jnp.asarray(A), jnp.asarray(A_lo), jnp.asarray(B),
            jnp.asarray(B_lo), seed_mask, jnp.asarray(mant),
            jnp.asarray(mant_lo), jnp.asarray(k0), xs_extra,
        )
        (_, _, _, _, _, acc), _ = jax.lax.scan(
            step_dw, (z, z, z, z, z.astype(jnp.int32), acc0), xs
        )
        return acc
    xs = (
        jnp.asarray(A), jnp.asarray(B), seed_mask,
        jnp.asarray(mant), jnp.asarray(k0), xs_extra,
    )
    (_, _, _, acc), _ = jax.lax.scan(
        step, (z, z, z.astype(jnp.int32), acc0), xs
    )
    return acc


def sht_recurrence(
    f, *, compensated: bool = False,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Spherical harmonic analysis via the on-device Legendre recurrence —
    O(L²) memory, arbitrary band limit (same convention and output as
    :func:`sht`; use for L where the chunked tables no longer fit).
    ``compensated=True`` runs the scan with a double-word carry: fp32-exact
    coefficients at any L (the plain fp32 scan drifts ~L·eps: 3.2e-5 at
    L=256, 1.6e-4 at L=512) for ~5-10x the elementwise work."""
    f = jnp.asarray(f)
    if f.ndim < 2 or f.shape[-2] < 1 or f.shape[-1] != 2 * f.shape[-2]:
        raise ValueError("f must be (…, L, 2L) on the sht_grid")
    L = f.shape[-2]
    _, w, _ = _gauss_grid(L)
    dphi = 2.0 * math.pi / (2 * L)
    wj = jnp.asarray((w * dphi).astype(np.float32))
    hermitian = not jnp.issubdtype(f.dtype, jnp.complexfloating)
    if hermitian:
        from .rfft import rfft as _rfft

        Fw = _rfft(f, config=config)[..., :L] * wj[:, None]  # (…, i, m)
        srcs = Fw[None]
    else:
        Fsel = _select_packed_m(fft(f, config=config), L)
        Fw = Fsel * wj[:, None]
        srcs = jnp.stack([Fw[..., :L], _fold_neg_last(Fw, L)])  # (2, …, i, m)

    acc = _rec_analyze_core(srcs, L, config, compensated=compensated)
    return _rec_pack(acc, L, hermitian)


def _rec_analyze_core(srcs, L: int, config, lat=None, compensated=False):
    """Recurrence analysis core: weighted spectra srcs (s, …, i, m) ->
    (s, …, l, m) coefficient planes (band-partial when ``lat`` slices the
    latitude axis — sum partials with a psum before packing)."""

    def accumulate(l_idx, p0, acc):
        # y_l[s, …, m] = Σ_i p0[m, i]·srcs[s, …, i, m]; write row l
        y = jnp.einsum(
            "mi,s...im->s...m", p0, srcs, precision=config.op_precision
        )
        return jax.lax.dynamic_update_index_in_dim(acc, y, l_idx, -2)

    acc0 = jnp.zeros(srcs.shape[:-2] + (L, L), srcs.dtype)  # (s, …, l, m)
    return _legendre_scan(
        L, accumulate, acc0, jnp.arange(L), lat=lat, compensated=compensated
    )


def _rec_pack(acc, L: int, hermitian: bool):
    """(s, …, l, m) scan accumulator -> packed (…, 2L-1, L) coefficients."""
    a = jnp.swapaxes(acc, -1, -2)  # (s, …, m, l)
    apos = a[0]
    if hermitian:
        sign = jnp.asarray(_neg_signs(L), apos.real.dtype)
        aneg = jnp.conj(apos) * sign[:, None]
    else:
        aneg = a[1]
    return jnp.concatenate([apos, jnp.flip(aneg[..., 1:, :], axis=-2)], axis=-2)


def _rec_synth_core(srcs, L: int, config, lat=None, compensated=False):
    """Recurrence synthesis core: (s, …, m, l) coefficient sources ->
    (s, …, i, m) longitude-bin planes (band-local when ``lat`` is given)."""
    a_scan = jnp.moveaxis(srcs, -1, 0)  # (l, s, …, m)

    def accumulate(a_l, p0, acc):
        return acc + jnp.einsum(
            "mi,s...m->s...im", p0, a_l, precision=config.op_precision
        )

    ni = L if lat is None else lat[0].shape[-1]
    acc0 = jnp.zeros(srcs.shape[:-2] + (ni, L), srcs.dtype)  # (s, …, i, m)
    return _legendre_scan(
        L, accumulate, acc0, a_scan, lat=lat, compensated=compensated
    )


def isht_recurrence(
    alm, *, real_output: bool = False, compensated: bool = False,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Spherical harmonic synthesis via the on-device Legendre recurrence —
    O(L²) memory (same convention as :func:`isht`; see
    :func:`sht_recurrence` for ``compensated``)."""
    alm = jnp.asarray(alm)
    if alm.ndim < 2 or alm.shape[-1] < 1 or alm.shape[-2] != 2 * alm.shape[-1] - 1:
        raise ValueError("alm must be (…, 2L-1, L) packed coefficients")
    L = alm.shape[-1]
    apos = alm[..., :L, :]
    if real_output:
        srcs = apos[None]
    else:
        half = jnp.flip(alm[..., L:, :], axis=-2)
        z = jnp.zeros(alm.shape[:-2] + (1, L), alm.dtype)
        sign = jnp.asarray(_neg_signs(L), alm.real.dtype)
        srcs = jnp.stack([apos, jnp.concatenate([z, half], axis=-2) * sign[:, None]])
    g = _rec_synth_core(srcs, L, config, compensated=compensated)
    gpos = g[0]
    nlon = 2 * L
    zeros = jnp.zeros(gpos.shape[:-1] + (1,), gpos.dtype)
    if real_output:
        from .rfft import irfft as _irfft

        bins = jnp.concatenate([gpos, zeros], axis=-1)
        return _irfft(bins, n=nlon, config=config) * nlon
    bins = jnp.concatenate(
        [gpos, zeros, jnp.flip(g[1][..., 1:], axis=-1)], axis=-1
    )
    return ifft(bins, config=config) * nlon


# ---------------------------------------------------------------------------
# Rotation of spherical-harmonic coefficients: Wigner-D block-diagonal per
# degree.  Host builds the REAL Wigner-d(beta) stack (the alpha/gamma Euler
# phases are separable e^{-i m phi} diagonals applied on device), device
# applies one dense (L, 2L-1, 2L-1) einsum — ragged (2l+1)-blocks zero-padded
# into one contraction, the same layout trade as the Legendre tables.
# ---------------------------------------------------------------------------


def _packed_m_values(L: int) -> np.ndarray:
    """m per packed row: [0..L-1, -(L-1)..-1] (fft bin order)."""
    return np.concatenate([np.arange(L), np.arange(-(L - 1), 0)])


@functools.lru_cache(maxsize=8)
def _wigner_d_stack(L: int, beta: float) -> np.ndarray:
    """(L, 2L-1, 2L-1) real Wigner-d matrices in PACKED m order:
    D[l, n_idx, m_idx] = d^l_{m(n_idx), m(m_idx)}(beta), zero outside
    |m|, |m'| <= l.

    Numerically: d^l(beta) = exp(-i·beta·J_y) with J_y tridiagonal in the
    |l m> basis; diagonalizing the Hermitian J_y (host fp64 eigh) gives an
    exactly-orthogonal exponential — stable at any l, unlike the factorial
    sum (alternating ~l! terms).  O(Σ(2l+1)³) ≈ O(L⁴)/4 host flops: ~1 s at
    L=128, ~15 s at L=256 (cached per (L, beta))."""
    mv = _packed_m_values(L)
    out = np.zeros((L, 2 * L - 1, 2 * L - 1))
    for l in range(L):
        m = np.arange(-l, l + 1, dtype=np.float64)
        # J_y: <m+1|J_y|m> = c_+(m)/(2i), <m-1|J_y|m> = -c_-(m)/(2i)
        cp = np.sqrt(l * (l + 1.0) - m[:-1] * (m[:-1] + 1.0))  # m -> m+1
        Jy = np.zeros((2 * l + 1, 2 * l + 1), np.complex128)
        idx = np.arange(2 * l)
        Jy[idx + 1, idx] = cp / 2j
        Jy[idx, idx + 1] = -cp / 2j
        w, U = np.linalg.eigh(Jy)
        d = (U * np.exp(-1j * beta * w)) @ U.conj().T
        dr = np.real(d)  # d^l is real in the |l m> basis
        # scatter the (2l+1)² block into packed order
        rows = np.where(np.abs(mv) <= l)[0]
        ms = mv[rows] + l  # position within the -l..l block
        out[l][np.ix_(rows, rows)] = dr[np.ix_(ms, ms)]
    return out


def rotate_sht(
    alm,
    alpha: float = 0.0,
    beta: float = 0.0,
    gamma: float = 0.0,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Rotate spherical-harmonic coefficients by ZYZ Euler angles
    (alpha, beta, gamma): the coefficients of f' = R·f where R first
    rotates by gamma about z, then beta about y, then alpha about z:

        a'_{lm} = e^{-i·m·alpha} Σ_{m'} d^l_{m m'}(beta) e^{-i·m'·gamma} a_{lm'}

    Input/output are packed (…, 2L-1, L) coefficients (as from
    :func:`sht`).  The inverse rotation is (-gamma, -beta, -alpha).
    Angles are static (host-built Wigner-d kernel, cached per (L, beta));
    per-degree power Σ_m |a_lm|² is preserved to fp32."""
    alm = jnp.asarray(alm)
    if alm.ndim < 2 or alm.shape[-1] < 1 or alm.shape[-2] != 2 * alm.shape[-1] - 1:
        raise ValueError(
            "alm must be (…, 2L-1, L) packed coefficients — got "
            f"{alm.shape[-2:] if alm.ndim >= 2 else alm.shape}"
        )
    L = alm.shape[-1]
    if not jnp.issubdtype(alm.dtype, jnp.complexfloating):
        alm = alm.astype(jnp.result_type(alm.dtype, jnp.complex64))
    rdtype = jnp.real(alm).dtype
    mv = _packed_m_values(L).astype(np.float64)
    prec = config.op_precision

    def _mphase(a, ang: float):
        if ang == 0.0:
            return a
        ph = (-(mv * ang)) % (2.0 * np.pi)  # exact host reduction
        pr = jnp.asarray(np.cos(ph), rdtype)[:, None]
        pi = jnp.asarray(np.sin(ph), rdtype)[:, None]
        ar, ai = jnp.real(a), jnp.imag(a)
        return jax.lax.complex(ar * pr - ai * pi, ar * pi + ai * pr)

    a = _mphase(alm, float(gamma))
    d = jnp.asarray(_wigner_d_stack(L, float(beta)), rdtype)  # (L, n, m)
    ar, ai = jnp.real(a), jnp.imag(a)
    br = jnp.einsum("lnm,...ml->...nl", d, ar, precision=prec)
    bi = jnp.einsum("lnm,...ml->...nl", d, ai, precision=prec)
    return _mphase(jax.lax.complex(br, bi), float(alpha))
