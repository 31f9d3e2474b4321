"""Discrete cosine/sine transforms (types I–IV) via the FFT engine.

Capability extension beyond the reference (which offers only complex/real
FFTs): the scipy.fft dct/idct surface, computed for the device — batched FFTs of
reordered/extended sequences plus fused twiddle passes:

    DCT-I:   even extension of length 2(N−1), real part of its FFT
    DCT-II:  Makhoul's N-point method (reorder + post-twiddle, no padding)
    DCT-III: the inverse pairing of II
    DCT-IV:  N-point complex FFT with pre-twiddle e^(−iπq/N) on the
             sign-adjusted Makhoul reorder and post-twiddle e^(−iπ(2k+1)/(4N))
    DST-*:   exact flip/sign identities on the matching DCT types

norm=None matches scipy's unnormalized convention; norm='ortho' makes each
transform orthonormal (and dct/idct exact inverses).
"""

from __future__ import annotations

import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..plan import get_plan
from ..utils.config import DEFAULT_CONFIG, SpectralConfig
from .stockham import exec_complex

Array = jax.Array


def _makhoul_reorder(x: Array) -> Array:
    """v[m] = x[2m], v[N-1-m] = x[2m+1]: even samples forward, odds reversed."""
    return jnp.concatenate([x[..., 0::2], jnp.flip(x[..., 1::2], -1)], axis=-1)


def _dct2_core(x: Array, n: int, config: SpectralConfig):
    """Unnormalized DCT-II via an n-point complex FFT of the reordered input."""
    v = _makhoul_reorder(x)
    plan = get_plan(n, -1, "complex", config)
    vr, vi = exec_complex(plan, v, jnp.zeros_like(v))
    # y[k] = 2·Re( e^{-iπk/(2n)} · V[k] )
    k = np.arange(n)
    ang = -np.pi * k / (2.0 * n)
    cr = jnp.asarray(np.cos(ang), dtype=v.dtype)
    ci = jnp.asarray(np.sin(ang), dtype=v.dtype)
    return 2.0 * (vr * cr - vi * ci)


def _dct1_core(x: Array, n: int, norm, config: SpectralConfig):
    """DCT-I: y[k] = x[0] + (−1)^k x[n−1] + 2 Σ_{1<=m<=n−2} x[m] cos(πkm/(n−1)),
    computed as the real part of the FFT of the even extension (length 2n−2)."""
    if n < 2:
        raise ValueError("DCT-I needs n >= 2")
    if norm == "ortho":
        end = jnp.asarray(math.sqrt(2.0), x.dtype)
        x = jnp.concatenate(
            [x[..., :1] * end, x[..., 1:-1], x[..., -1:] * end], axis=-1
        )
    v = jnp.concatenate([x, jnp.flip(x[..., 1:-1], -1)], axis=-1)
    plan = get_plan(2 * n - 2, -1, "complex", config)
    vr, _ = exec_complex(plan, v, jnp.zeros_like(v))
    y = vr[..., :n]
    if norm == "ortho":
        s = np.full(n, math.sqrt(1.0 / (2.0 * (n - 1))))
        s[0] /= math.sqrt(2.0)
        s[-1] /= math.sqrt(2.0)
        y = y * jnp.asarray(s, dtype=y.dtype)
    return y


def _dct4_core(x: Array, n: int, norm, config: SpectralConfig):
    """DCT-IV: y[k] = 2 Σ_m x[m] cos(π(2k+1)(2m+1)/(4n)) via one n-point
    complex FFT: reorder with negated odds, pre-twiddle e^(−iπq/n),
    post-twiddle e^(−iπ(2k+1)/(4n)), 2·Re."""
    v = jnp.concatenate([x[..., 0::2], -jnp.flip(x[..., 1::2], -1)], axis=-1)
    q = np.arange(n)
    pre = -np.pi * q / n
    pr = jnp.asarray(np.cos(pre), x.dtype)
    pi_ = jnp.asarray(np.sin(pre), x.dtype)
    plan = get_plan(n, -1, "complex", config)
    vr, vi = exec_complex(plan, v * pr, v * pi_)
    post = -np.pi * (2 * q + 1) / (4.0 * n)
    cr = jnp.asarray(np.cos(post), x.dtype)
    ci = jnp.asarray(np.sin(post), x.dtype)
    y = 2.0 * (vr * cr - vi * ci)
    if norm == "ortho":
        y = y * jnp.asarray(math.sqrt(1.0 / (2.0 * n)), y.dtype)
    return y


def dct(
    x,
    type: int = 2,
    n: Optional[int] = None,
    axis: int = -1,
    norm: Optional[str] = None,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """DCT of type 1, 2, 3, or 4 along ``axis`` (scipy.fft.dct-compatible)."""
    if type not in (1, 2, 3, 4):
        raise ValueError(f"DCT type must be 1, 2, 3 or 4, got {type}")
    if norm not in (None, "ortho"):
        raise ValueError(f"norm must be None or 'ortho', got {norm!r}")
    x = jnp.asarray(x)
    axis = axis % x.ndim
    x = jnp.moveaxis(x, axis, -1).astype(config.dtype)
    if n is not None:
        n = int(n)
        cur = x.shape[-1]
        if cur >= n:
            x = x[..., :n]
        else:
            x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, n - cur)])
    n = x.shape[-1]
    if n < 1:
        raise ValueError("dct needs n >= 1")

    if type == 1:
        y = _dct1_core(x, n, norm, config)
    elif type == 4:
        y = _dct4_core(x, n, norm, config)
    elif type == 2:
        y = _dct2_core(x, n, config)
        if norm == "ortho":
            s = np.full(n, math.sqrt(1.0 / (2.0 * n)))
            s[0] /= math.sqrt(2.0)
            y = y * jnp.asarray(s, dtype=y.dtype)
    else:  # type 3: y[m] = x[0] + 2 Σ_{k>=1} x[k] cos(πk(2m+1)/(2N))
        if norm == "ortho":
            # orthonormal III = exact inverse of orthonormal II: pre-scale so
            # the unnormalized-III core below produces it
            s = np.full(n, 1.0 / math.sqrt(2.0 * n))
            s[0] = 1.0 / math.sqrt(n)
            x = x * jnp.asarray(s, dtype=x.dtype)
        # Invert Makhoul (scaled): V[k] = e^{+iπk/(2n)}·(x[k] - i·x[n-k])
        # (x[n]≡0), v = unnormalized IFFT_n(V), y[2m] = v[m],
        # y[2m+1] = v[n-1-m] — the n and 1/2 factors cancel against the
        # unnormalized type-III definition.
        k = np.arange(n)
        ang = np.pi * k / (2.0 * n)
        cr = jnp.asarray(np.cos(ang), dtype=x.dtype)
        ci = jnp.asarray(np.sin(ang), dtype=x.dtype)
        tail = jnp.concatenate(
            [jnp.zeros_like(x[..., :1]), jnp.flip(x[..., 1:], -1)], axis=-1
        )
        ar, ai = x, -tail
        vr = ar * cr - ai * ci
        vi = ar * ci + ai * cr
        plan = get_plan(n, 1, "complex", config)  # unnormalized inverse FFT
        wr, _ = exec_complex(plan, vr, vi)
        even = wr[..., : (n + 1) // 2]
        odd = jnp.flip(wr[..., (n + 1) // 2 :], -1)
        y = jnp.zeros_like(wr)
        y = y.at[..., 0::2].set(even)
        y = y.at[..., 1::2].set(odd)
    return jnp.moveaxis(y, -1, axis)


_DCT_INVERSE_PAIR = {1: 1, 2: 3, 3: 2, 4: 4}


def idct(
    x,
    type: int = 2,
    n: Optional[int] = None,
    axis: int = -1,
    norm: Optional[str] = None,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Inverse DCT (scipy pairing: type 2 ↔ 3; types 1 and 4 are involutions
    up to the unnormalized scale 2(n−1) / 2n respectively)."""
    if type not in (1, 2, 3, 4):
        raise ValueError(f"DCT type must be 1, 2, 3 or 4, got {type}")
    y = dct(x, type=_DCT_INVERSE_PAIR[type], n=n, axis=axis, norm=norm,
            config=config)
    if norm is None:
        nn = y.shape[axis]
        y = y / (2.0 * (nn - 1) if type == 1 else 2.0 * nn)
    return y


def _separable_nd(fn, x, type, axes, norm, config) -> Array:
    """Apply a 1-D transform over every axis in ``axes`` (default: all)."""
    x = jnp.asarray(x)
    if axes is None:
        axes = tuple(range(x.ndim))
    for a in axes:
        x = fn(x, type=type, axis=a, norm=norm, config=config)
    return x


def dctn(x, type: int = 2, axes=None, norm: Optional[str] = None, *,
         config: SpectralConfig = DEFAULT_CONFIG) -> Array:
    """N-D DCT: separable 1-D DCTs over ``axes`` (scipy.fft.dctn)."""
    return _separable_nd(dct, x, type, axes, norm, config)


def idctn(x, type: int = 2, axes=None, norm: Optional[str] = None, *,
          config: SpectralConfig = DEFAULT_CONFIG) -> Array:
    """Inverse N-D DCT (scipy.fft.idctn)."""
    return _separable_nd(idct, x, type, axes, norm, config)


def _alt_sign(n: int, dtype) -> Array:
    return jnp.asarray((-1.0) ** np.arange(n), dtype=dtype)


def _dst1_core(x: Array, n: int, norm, config: SpectralConfig):
    """DST-I: y[k] = 2 Σ_m x[m] sin(π(k+1)(m+1)/(n+1)), computed as
    −Im(FFT_{2n+2}(odd extension))[1:n+1]."""
    z1 = jnp.zeros_like(x[..., :1])
    v = jnp.concatenate([z1, x, z1, -jnp.flip(x, -1)], axis=-1)
    plan = get_plan(2 * n + 2, -1, "complex", config)
    _, vi = exec_complex(plan, v, jnp.zeros_like(v))
    y = -vi[..., 1 : n + 1]
    if norm == "ortho":
        y = y * jnp.asarray(math.sqrt(1.0 / (2.0 * (n + 1))), y.dtype)
    return y


def dst(
    x,
    type: int = 2,
    n: Optional[int] = None,
    axis: int = -1,
    norm: Optional[str] = None,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """DST of type 1, 2, 3, or 4 (scipy.fft.dst-compatible).  Types 2/3/4 ride
    the exact flip/sign identities DST-II(x) = flip(DCT-II((−1)^m x)),
    DST-III(x) = (−1)^m · DCT-III(flip(x)), and
    DST-IV(x) = flip_k(DCT-IV((−1)^m x)) — all carry the ortho scaling
    through unchanged; type 1 has its own odd-extension core."""
    if type not in (1, 2, 3, 4):
        raise ValueError(f"DST type must be 1, 2, 3 or 4, got {type}")
    x = jnp.asarray(x)
    axis = axis % x.ndim
    xm = jnp.moveaxis(x, axis, -1).astype(config.dtype)
    if n is not None:
        cur = xm.shape[-1]
        n = int(n)
        xm = xm[..., :n] if cur >= n else jnp.pad(
            xm, [(0, 0)] * (xm.ndim - 1) + [(0, n - cur)]
        )
    nn = xm.shape[-1]
    if nn < 1:
        raise ValueError("dst needs n >= 1")
    sgn = _alt_sign(nn, xm.dtype)
    if type == 1:
        y = _dst1_core(xm, nn, norm, config)
    elif type == 2:
        y = jnp.flip(dct(xm * sgn, 2, axis=-1, norm=norm, config=config), -1)
    elif type == 4:
        y = jnp.flip(dct(xm * sgn, 4, axis=-1, norm=norm, config=config), -1)
    else:
        y = sgn * dct(jnp.flip(xm, -1), 3, axis=-1, norm=norm, config=config)
    return jnp.moveaxis(y, -1, axis)


_DST_INVERSE_PAIR = {1: 1, 2: 3, 3: 2, 4: 4}


def idst(
    x,
    type: int = 2,
    n: Optional[int] = None,
    axis: int = -1,
    norm: Optional[str] = None,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Inverse DST (pairing mirrors idct; type 1 is an involution up to
    2(n+1), type 4 up to 2n)."""
    if type not in (1, 2, 3, 4):
        raise ValueError(f"DST type must be 1, 2, 3 or 4, got {type}")
    y = dst(x, type=_DST_INVERSE_PAIR[type], n=n, axis=axis, norm=norm,
            config=config)
    if norm is None:
        nn = y.shape[axis]
        y = y / (2.0 * (nn + 1) if type == 1 else 2.0 * nn)
    return y


def dstn(x, type: int = 2, axes=None, norm: Optional[str] = None, *,
         config: SpectralConfig = DEFAULT_CONFIG) -> Array:
    """N-D DST: separable 1-D DSTs over ``axes`` (scipy.fft.dstn)."""
    return _separable_nd(dst, x, type, axes, norm, config)


def idstn(x, type: int = 2, axes=None, norm: Optional[str] = None, *,
          config: SpectralConfig = DEFAULT_CONFIG) -> Array:
    """Inverse N-D DST (scipy.fft.idstn)."""
    return _separable_nd(idst, x, type, axes, norm, config)
