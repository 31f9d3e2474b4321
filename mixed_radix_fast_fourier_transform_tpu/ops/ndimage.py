"""Fourier-domain image filters (scipy.ndimage parity).

``fourier_gaussian`` / ``fourier_uniform`` / ``fourier_ellipsoid`` multiply
an ALREADY-TRANSFORMED array by the closed-form transfer function of the
corresponding real-space kernel — the scipy.ndimage convention: every axis
of the input is a frequency axis, ``n < 0`` means a full complex FFT
layout, ``n >= 0`` means axis ``axis`` holds a real-transform (rfft) of
original length ``n``.  Composing with this library's fft/rfft families
gives convolution-by-kernel without ever materializing the kernel in real
space.

Device shape: the separable filters (gaussian, uniform) apply as ndim
broadcasted 1-D host-constant multiplies — XLA fuses them into a single
elementwise pass over the spectrum; the ellipsoid's radial transfer
function is a host fp64 grid evaluated once per (shape, size) and baked
as one constant multiply.  J1 for the 2-D disk uses the Abramowitz-Stegun
rational approximations (<1e-7 abs error) so no SciPy runtime dependency
is needed.

Capability extension: the reference C library has no image filtering.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.config import DEFAULT_CONFIG, SpectralConfig

Array = jax.Array


def _axis_freqs(shape, n: int, axis: int):
    """Per-axis frequency vectors matching scipy.ndimage's layout."""
    nd = len(shape)
    axis = axis % nd
    freqs = []
    for i, s in enumerate(shape):
        if i == axis and n >= 0:
            expect = n // 2 + 1
            if s != expect:
                raise ValueError(
                    f"axis {i} has {s} bins; a real transform of length "
                    f"n={n} has {expect}"
                )
            freqs.append(np.fft.rfftfreq(n))
        else:
            freqs.append(np.fft.fftfreq(s))
    return freqs


def _per_axis(param, ndim: int, name: str) -> np.ndarray:
    p = np.atleast_1d(np.asarray(param, np.float64))
    if p.ndim != 1 or (p.size not in (1, ndim)):
        raise ValueError(f"{name} must be a scalar or one value per axis")
    return np.broadcast_to(p, (ndim,))


def _apply_separable(x: Array, factors) -> Array:
    out = x
    nd = out.ndim
    rdtype = jnp.real(out).dtype
    for i, f in enumerate(factors):
        shape = [1] * nd
        shape[i] = len(f)
        out = out * jnp.asarray(f.astype(np.float64), rdtype).reshape(shape)
    return out


def fourier_gaussian(x, sigma, n: int = -1, axis: int = -1,
                     *, config: SpectralConfig = DEFAULT_CONFIG) -> Array:
    """Multiply a Fourier-domain array by a Gaussian transfer function
    exp(−2π²σ²f²) per axis (scipy.ndimage.fourier_gaussian parity).

    ``sigma`` is the real-space standard deviation in samples, scalar or
    per-axis.  ``n``/``axis`` flag one axis as an rfft of original length
    ``n`` (``n < 0``: all axes are full complex-FFT axes)."""
    x = jnp.asarray(x)
    sig = _per_axis(sigma, x.ndim, "sigma")
    freqs = _axis_freqs(x.shape, n, axis)
    facs = [np.exp(-2.0 * (np.pi * s * f) ** 2) for s, f in zip(sig, freqs)]
    return _apply_separable(x, facs)


def fourier_uniform(x, size, n: int = -1, axis: int = -1,
                    *, config: SpectralConfig = DEFAULT_CONFIG) -> Array:
    """Multiply a Fourier-domain array by a box-filter transfer function
    sinc(size·f) per axis (scipy.ndimage.fourier_uniform parity);
    ``size`` is the real-space box width in samples."""
    x = jnp.asarray(x)
    sz = _per_axis(size, x.ndim, "size")
    freqs = _axis_freqs(x.shape, n, axis)
    facs = [np.sinc(s * f) for s, f in zip(sz, freqs)]
    return _apply_separable(x, facs)


def _j1(u: np.ndarray) -> np.ndarray:
    """Bessel J1, Abramowitz-Stegun 9.4.4/9.4.6 rational fits (fp64 host,
    abs err < 4e-8 over the real line)."""
    u = np.asarray(u, np.float64)
    au = np.abs(u)
    small = au < 3.0
    # |u| < 3: J1(u)/u polynomial in (u/3)^2
    y = (u / 3.0) ** 2
    p_small = u * (
        0.5
        + y * (-0.56249985
        + y * (0.21093573
        + y * (-0.03954289
        + y * (0.00443319
        + y * (-0.00031761
        + y * 0.00001109))))))
    # |u| >= 3: modulus/phase form
    ys = np.where(small, 3.0, au)
    z = 3.0 / ys
    f1 = (0.79788456
          + z * (0.00000156
          + z * (0.01659667
          + z * (0.00017105
          + z * (-0.00249511
          + z * (0.00113653
          + z * (-0.00020033)))))))
    t1 = (ys - 2.35619449
          + z * (0.12499612
          + z * (0.00005650
          + z * (-0.00637879
          + z * (0.00074348
          + z * (0.00079824
          + z * (-0.00029166)))))))
    p_big = np.sign(u) * f1 * np.cos(t1) / np.sqrt(ys)
    return np.where(small, p_small, p_big)


def fourier_ellipsoid(x, size, n: int = -1, axis: int = -1,
                      *, config: SpectralConfig = DEFAULT_CONFIG) -> Array:
    """Multiply a Fourier-domain array by the transfer function of a
    uniform ellipsoid of diameters ``size`` (scipy.ndimage parity,
    1 <= ndim <= 3): sinc in 1-D, the disk jinc 2·J1(u)/u in 2-D,
    3·(sin u − u·cos u)/u³ in 3-D, with u = π·|size∘f|."""
    x = jnp.asarray(x)
    nd = x.ndim
    if not 1 <= nd <= 3:
        raise ValueError("fourier_ellipsoid supports 1-D, 2-D and 3-D only")
    sz = _per_axis(size, nd, "size")
    freqs = _axis_freqs(x.shape, n, axis)
    grids = np.meshgrid(*[s * f for s, f in zip(sz, freqs)], indexing="ij")
    u = np.pi * np.sqrt(sum(g * g for g in grids))
    if nd == 1:
        with np.errstate(invalid="ignore", divide="ignore"):
            ker = np.where(u == 0.0, 1.0, np.sin(u) / u)
    elif nd == 2:
        with np.errstate(invalid="ignore", divide="ignore"):
            ker = np.where(u == 0.0, 1.0, 2.0 * _j1(u) / u)
    else:
        with np.errstate(invalid="ignore", divide="ignore"):
            ker = np.where(
                u == 0.0, 1.0, 3.0 * (np.sin(u) - u * np.cos(u)) / u**3
            )
    rdtype = jnp.real(x).dtype
    return x * jnp.asarray(ker, rdtype)


def _box_sum_valid(x: Array, size: int, axis: int) -> Array:
    """Valid-mode sliding-window sum via one cumsum (length n−size+1)."""
    xm = jnp.moveaxis(x, axis, -1)
    pad = [(0, 0)] * (xm.ndim - 1) + [(1, 0)]
    cs = jnp.cumsum(jnp.pad(xm, pad), axis=-1)
    out = cs[..., size:] - cs[..., :-size]
    return jnp.moveaxis(out, -1, axis)


def wiener(x, mysize=3, noise=None,
           *, config: SpectralConfig = DEFAULT_CONFIG) -> Array:
    """Adaptive local Wiener filter (scipy.signal.wiener semantics, n-D):
    out = μ + max(σ²−ν, 0)/max(σ², ν)·(x−μ) with μ/σ² the local window
    statistics and ν the noise power (mean local variance when None).

    Device shape: the box statistics are one cumsum-difference per axis —
    no gather windows, no sorting."""
    x = jnp.asarray(x)
    if x.ndim < 1:
        raise ValueError("x must have at least one dimension")
    if np.ndim(mysize) == 0:
        sizes = (int(mysize),) * x.ndim
    else:
        sizes = tuple(int(s) for s in mysize)
    if len(sizes) != x.ndim or any(s < 1 or s % 2 == 0 for s in sizes):
        raise ValueError("mysize must be odd and match the input rank")
    rdt = jnp.result_type(x.dtype, jnp.float32)
    xw = x.astype(rdt)
    cnt = float(np.prod(sizes))
    # center on the global mean before the box sums: E[x²]−μ² cancels
    # catastrophically in fp32 for offset data, and zero-mean values keep
    # the long cumsums' partial sums (hence their rounding) O(√n).
    # scipy's zero edge padding is applied to the RAW signal first, so
    # the pads become exactly −mean in centered space.
    gmean = jnp.mean(xw)
    halo = [(s // 2, s // 2) for s in sizes]
    xc = jnp.pad(xw, halo) - gmean
    s1 = xc
    s2 = xc * xc
    for ax, sz in enumerate(sizes):
        s1 = _box_sum_valid(s1, sz, ax)
        s2 = _box_sum_valid(s2, sz, ax)
    mu_c = s1 / cnt
    var = s2 / cnt - mu_c * mu_c
    mu = mu_c + gmean
    nu = jnp.mean(var) if noise is None else jnp.asarray(noise, rdt)
    out = mu + jnp.maximum(var - nu, 0.0) / jnp.maximum(var, nu) * (xw - mu)
    return out.astype(x.dtype) if jnp.issubdtype(x.dtype, jnp.floating) \
        else out
