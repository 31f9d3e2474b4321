"""Public complex FFT API: fft / ifft / fft2 / fftn + helpers.

numpy.fft-compatible surface over the plan-based engine.  The reference's
user-facing pair is `fft_init` + `fft_exec` with an *unnormalized* inverse
(src/highSpeedFFT.c:1920-1942; its demo divides by N manually,
src/real.c:331-335) — that exact contract lives in
:mod:`..compat`; this module exposes the numpy-style normalized API most
users expect.  Every length N >= 1 is supported: smooth lengths run the
mixed-radix matmul engine, the rest run Bluestein (the reference crashes or is
silently wrong on many lengths — SURVEY.md §2.9).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from ..plan import get_plan
from ..utils.config import DEFAULT_CONFIG, SpectralConfig
from ..utils.numerics import from_planes, to_planes
from .stockham import exec_complex, exec_len

Array = jax.Array

_NORMS = ("backward", "ortho", "forward")


def _norm_scale(n: int, sign: int, norm: Optional[str]) -> float:
    """Scale factor applied after an unnormalized transform.

    forward transform (sign=-1): backward→1, ortho→1/√n, forward→1/n
    inverse transform (sign=+1): backward→1/n, ortho→1/√n, forward→1
    """
    norm = norm or "backward"
    if norm not in _NORMS:
        raise ValueError(f"norm must be one of {_NORMS}, got {norm!r}")
    if norm == "ortho":
        return 1.0 / math.sqrt(n)
    if (norm == "backward" and sign == 1) or (norm == "forward" and sign == -1):
        return 1.0 / n
    return 1.0


def _resize_last(x: Array, n: int) -> Array:
    """Crop or zero-pad the last axis to length n (numpy fft `n=` semantics)."""
    cur = x.shape[-1]
    if cur == n:
        return x
    if cur > n:
        return x[..., :n]
    pad = [(0, 0)] * (x.ndim - 1) + [(0, n - cur)]
    return jnp.pad(x, pad)


def _fft_1d(
    x,
    n: Optional[int],
    axis: int,
    sign: int,
    norm: Optional[str],
    config: SpectralConfig,
) -> Array:
    x = jnp.asarray(x)
    if x.ndim == 0:
        raise ValueError("fft requires at least a 1-D input")
    axis = axis % x.ndim
    x = jnp.moveaxis(x, axis, -1)
    n = int(n) if n is not None else x.shape[-1]
    if n < 1:
        raise ValueError(f"transform length must be >= 1, got {n}")
    x = _resize_last(x, n)
    xr, xi = to_planes(x, config.dtype)
    zr, zi = exec_len(config, n, sign, xr, xi)
    scale = _norm_scale(n, sign, norm)
    if scale != 1.0:
        s = jnp.asarray(scale, dtype=zr.dtype)
        zr, zi = zr * s, zi * s
    return jnp.moveaxis(from_planes(zr, zi), -1, axis)


def fft(
    x,
    n: Optional[int] = None,
    axis: int = -1,
    norm: Optional[str] = "backward",
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Forward 1-D complex FFT along ``axis`` (any length, any batch shape)."""
    return _fft_1d(x, n, axis, -1, norm, config)


def ifft(
    x,
    n: Optional[int] = None,
    axis: int = -1,
    norm: Optional[str] = "backward",
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Inverse 1-D complex FFT along ``axis``."""
    return _fft_1d(x, n, axis, 1, norm, config)


def _axes_shape(
    x: Array, s: Optional[Sequence[int]], axes: Optional[Sequence[int]]
) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    if axes is None:
        axes = tuple(range(x.ndim)) if s is None else tuple(
            range(x.ndim - len(s), x.ndim)
        )
    axes = tuple(a % x.ndim for a in axes)
    if s is None:
        s = tuple(x.shape[a] for a in axes)
    if len(s) != len(axes):
        raise ValueError("s and axes must have the same length")
    return tuple(int(v) for v in s), axes


def fftn(
    x,
    s: Optional[Sequence[int]] = None,
    axes: Optional[Sequence[int]] = None,
    norm: Optional[str] = "backward",
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """N-D FFT as separable 1-D transforms (the reference is 1-D only; this is
    a capability extension, built for the device: each axis pass is a batched
    matmul pipeline)."""
    x = jnp.asarray(x)
    s, axes = _axes_shape(x, s, axes)
    for n_i, a in zip(s, axes):
        x = fft(x, n=n_i, axis=a, norm=norm, config=config)
    return x


def ifftn(
    x,
    s: Optional[Sequence[int]] = None,
    axes: Optional[Sequence[int]] = None,
    norm: Optional[str] = "backward",
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Inverse N-D FFT (numpy.fft.ifftn semantics)."""
    x = jnp.asarray(x)
    s, axes = _axes_shape(x, s, axes)
    for n_i, a in zip(s, axes):
        x = ifft(x, n=n_i, axis=a, norm=norm, config=config)
    return x


def fft2(x, s=None, axes=(-2, -1), norm="backward", *, config=DEFAULT_CONFIG):
    """2-D FFT over ``axes`` (numpy.fft.fft2 semantics)."""
    return fftn(x, s=s, axes=axes, norm=norm, config=config)


def ifft2(x, s=None, axes=(-2, -1), norm="backward", *, config=DEFAULT_CONFIG):
    """Inverse 2-D FFT over ``axes`` (numpy.fft.ifft2 semantics)."""
    return ifftn(x, s=s, axes=axes, norm=norm, config=config)


# ---------------------------------------------------------------------------
# Frequency-axis helpers (numpy parity; trivial but part of "everything a
# spectral-library user needs").
# ---------------------------------------------------------------------------

def fftfreq(n: int, d: float = 1.0, *, dtype=jnp.float32) -> Array:
    """DFT sample frequencies for length ``n``, spacing ``d`` (numpy.fft.fftfreq)."""
    k = jnp.arange(n)
    k = jnp.where(k < (n + 1) // 2, k, k - n)
    return (k / (n * d)).astype(dtype)


def rfftfreq(n: int, d: float = 1.0, *, dtype=jnp.float32) -> Array:
    """Non-negative DFT frequencies for a length-``n`` real transform (numpy.fft.rfftfreq)."""
    return (jnp.arange(n // 2 + 1) / (n * d)).astype(dtype)


def fftshift(x, axes=None) -> Array:
    """Roll the zero-frequency bin to the center (numpy.fft.fftshift)."""
    x = jnp.asarray(x)
    if axes is None:
        axes = tuple(range(x.ndim))
    elif isinstance(axes, int):
        axes = (axes,)
    shifts = [x.shape[a] // 2 for a in axes]
    return jnp.roll(x, shifts, axes)


def ifftshift(x, axes=None) -> Array:
    """Undo :func:`fftshift` (numpy.fft.ifftshift)."""
    x = jnp.asarray(x)
    if axes is None:
        axes = tuple(range(x.ndim))
    elif isinstance(axes, int):
        axes = (axes,)
    shifts = [-(x.shape[a] // 2) for a in axes]
    return jnp.roll(x, shifts, axes)


def dht(x, n: Optional[int] = None, axis: int = -1, *, config=DEFAULT_CONFIG) -> Array:
    """Discrete Hartley transform H[k] = sum_n x[n]·cas(2*pi*n*k/N),
    cas = cos + sin — the real-to-real self-inverse cousin of the DFT
    (FFTW's DHT; capability extension, the reference has no real-to-real
    transforms).  Computed as Re(F) - Im(F) of the engine's forward FFT;
    ``dht(dht(x)) == N*x`` (see :func:`idht`).  Complex input transforms
    each plane independently (cas kernel applied to re and im)."""
    x = jnp.asarray(x)
    if jnp.issubdtype(x.dtype, jnp.complexfloating):
        # cas = cos + sin: with F the forward DFT and F~[k] = F[(-k) mod N],
        # sum z·cos = (F + F~)/2 and sum z·sin = i(F - F~)/2 — one FFT plus
        # an O(N) bin reversal instead of two plane transforms
        F = fft(x, n=n, axis=axis, config=config)
        Fm = jnp.moveaxis(F, axis, -1)
        Ft = jnp.concatenate([Fm[..., :1], jnp.flip(Fm[..., 1:], -1)], axis=-1)
        Ft = jnp.moveaxis(Ft, -1, axis)
        return (F + Ft) / 2 + 1j * (F - Ft) / 2
    from .rfft import rfft as _rfft

    # real input: half-spectrum suffices (H[k] = Re-Im, H[N-k] = Re+Im)
    spec = jnp.moveaxis(_rfft(x, n=n, axis=axis, config=config), axis, -1)
    nn = n if n is not None else x.shape[axis]
    head = jnp.real(spec) - jnp.imag(spec)          # bins 0..nn//2
    mid = spec[..., 1 : (nn - 1) // 2 + 1]
    tail = jnp.flip(jnp.real(mid) + jnp.imag(mid), -1)  # bins nn//2+1..nn-1
    return jnp.moveaxis(jnp.concatenate([head, tail], axis=-1), -1, axis)


def idht(x, n: Optional[int] = None, axis: int = -1, *, config=DEFAULT_CONFIG) -> Array:
    """Inverse DHT: the DHT is self-inverse up to 1/N (idht = dht(x)/N)."""
    x = jnp.asarray(x)
    y = dht(x, n=n, axis=axis, config=config)
    # normalize by the transform length explicitly (dht always outputs the
    # transform length today, so this equals y.shape[axis]; stated in terms
    # of n to keep the normalization contract independent of output shape)
    nn = int(n) if n is not None else x.shape[axis]
    return y / nn
