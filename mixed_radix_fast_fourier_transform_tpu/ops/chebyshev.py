"""Chebyshev spectral toolbox — non-periodic spectral methods via the DCT.

Capability extension beyond the reference C library (complex/real FFTs on
periodic data only): the Chebyshev machinery that turns the FFT engine into
a spectral method for NON-periodic problems — values on the
Chebyshev-Gauss-Lobatto grid x_j = cos(pi j/(N-1)) transform to polynomial
coefficients through a DCT-I (one length-2N-2 engine FFT), differentiation
is an exact coefficient recurrence, and evaluation anywhere is Clenshaw's
algorithm under ``lax.scan`` (static trip count — compiler-friendly
control flow).

Conventions match ``numpy.polynomial.chebyshev`` (the test oracle):
coefficients c with f(x) = sum_k c[k] T_k(x).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.config import DEFAULT_CONFIG, SpectralConfig
from .dct import dct

Array = jax.Array


def cheb_points(n: int, dtype=np.float32) -> np.ndarray:
    """Chebyshev-Gauss-Lobatto nodes cos(pi j/(n-1)), j = 0..n-1 (host array,
    descending from +1 to -1 — the grid :func:`cheb_transform` expects)."""
    if n < 2:
        raise ValueError(f"need n >= 2 points, got {n}")
    return np.cos(np.pi * np.arange(n) / (n - 1)).astype(dtype)


def cheb_transform(
    v, *, config: SpectralConfig = DEFAULT_CONFIG
) -> Array:
    """Values on the n-point Gauss-Lobatto grid -> Chebyshev coefficients.

    c = DCT-I(v)/(n-1) with the first/last coefficients halved; one engine
    FFT of length 2n-2.  Exact (to fp32 round-off) for polynomials of degree
    < n; spectrally accurate for smooth f."""
    v = jnp.asarray(v)
    n = v.shape[-1]
    if n < 2:
        raise ValueError("cheb_transform needs >= 2 grid values")
    c = dct(v, type=1, config=config) / (n - 1)
    ends = np.ones(n)
    ends[0] = ends[-1] = 0.5
    return c * jnp.asarray(ends, c.dtype)


def icheb_transform(
    c, *, config: SpectralConfig = DEFAULT_CONFIG
) -> Array:
    """Chebyshev coefficients -> values on the Gauss-Lobatto grid (inverse of
    :func:`cheb_transform`): v = DCT-I(c with interior halved)."""
    c = jnp.asarray(c)
    n = c.shape[-1]
    if n < 2:
        raise ValueError("icheb_transform needs >= 2 coefficients")
    mid = np.full(n, 0.5)
    mid[0] = mid[-1] = 1.0
    return dct(c * jnp.asarray(mid, c.dtype), type=1, config=config)


def cheb_diff_coef(c) -> Array:
    """Differentiate in coefficient space: coefficients of f' given those of f.

    Closed form of the standard recurrence b_q = b_{q+2} + 2(q+1)·c_{q+1}:
    b_q = 2 · sum over p > q with p−q odd of p·c_p, b_0 halved — i.e. the
    opposite-parity tail sum of w_p = 2p·c_p.  Two flips + a cumsum per
    parity class instead of a sequential loop (compiler-friendly, batched).
    The q = n-1 entry is naturally zero (no opposite-parity p ≥ n-1)."""
    c = jnp.asarray(c)
    n = c.shape[-1]
    if n < 1:
        raise ValueError("need at least one coefficient")
    if n == 1:
        return jnp.zeros_like(c)
    w = c * jnp.asarray(2.0 * np.arange(n), c.dtype)

    def tail_sum(a):  # t_q = sum_{p >= q} a_p
        return jnp.flip(jnp.cumsum(jnp.flip(a, -1), axis=-1), -1)

    even = np.arange(n) % 2 == 0
    te = tail_sum(w * jnp.asarray(even, c.dtype))  # even-p tails
    to = tail_sum(w * jnp.asarray(~even, c.dtype))  # odd-p tails
    # opposite parity means the p = q term is masked out of its own tail,
    # so "p >= q" tails already implement "p > q"
    b = jnp.where(jnp.asarray(even), to, te)
    half = np.ones(n)
    half[0] = 0.5
    return b * jnp.asarray(half, c.dtype)


def cheb_diff(v, m: int = 1, *, config: SpectralConfig = DEFAULT_CONFIG) -> Array:
    """m-th spectral derivative of grid values on [-1, 1]: transform,
    differentiate m times in coefficient space, transform back."""
    if m < 0:
        raise ValueError(f"derivative order must be >= 0, got {m}")
    c = cheb_transform(v, config=config)
    for _ in range(m):
        c = cheb_diff_coef(c)
    return icheb_transform(c, config=config)


def cheb_eval(c, x) -> Array:
    """Evaluate sum_k c[k] T_k(x) at arbitrary ``x`` by Clenshaw's recurrence
    under ``lax.scan`` (numerically stable; static trip count; batched over
    leading axes of ``c`` and any shape of ``x``)."""
    c = jnp.asarray(c)
    x = jnp.asarray(x)
    n = c.shape[-1]
    if n < 1:
        raise ValueError("need at least one coefficient")
    xpand = (...,) if x.ndim == 0 else (..., *([None] * x.ndim))
    if n == 1:
        return jnp.broadcast_to(c[..., 0][xpand], c.shape[:-1] + x.shape)
    xb = x.reshape((1,) * (c.ndim - 1) + x.shape)
    two_x = 2.0 * xb

    def step(carry, ck):
        b1, b2 = carry
        b = ck[xpand] + two_x * b1 - b2  # ck broadcast over x's axes
        return (b, b1), None

    cs = jnp.moveaxis(c[..., 1:], -1, 0)[::-1]  # scan highest -> lowest
    zero = jnp.zeros(c.shape[:-1] + x.shape, c.dtype)
    (b1, b2), _ = jax.lax.scan(step, (zero, zero), cs)
    return c[..., 0][xpand] + xb * b1 - b2
