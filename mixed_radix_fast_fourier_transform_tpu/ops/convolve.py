"""FFT-based convolution (L4 of the reference).

Replacement for `fft_convolve` (reference: src/convolve.c:74-214):
rfft → pointwise product → irfft, jit-composed so XLA fuses the pointwise pass
into the surrounding transforms.  Output-mode slicing matches the reference
exactly for linear convolution:

    full : start 0,                length n1+n2-1        (convolve.c:166-170)
    same : start (L-max)/2,        length max(n1,n2)     (convolve.c:171-176)
    valid: start min-1,            length max-min+1      (convolve.c:177-182)

Differences (deliberate):
* circular convolution is *true* circular convolution at period max(n1, n2)
  (the engine supports every FFT length, so no pow2 padding is needed); the
  reference instead returns the zero-padded linear result of the padded
  length (convolve.c:189-195), which is not a circular convolution at all —
  that behavior is preserved only in :mod:`..compat`.
* complex inputs are supported via the complex engine.
* batched: leading dimensions broadcast.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.config import DEFAULT_CONFIG, SpectralConfig
from ..utils.factorize import next_fast_len, next_pow2
from .fft import fft, ifft
from .rfft import irfft, rfft

Array = jax.Array

_MODES = ("full", "same", "valid")


def _padded_len(n: int, config: SpectralConfig) -> int:
    if config.pad_mode == "fast":
        return next_fast_len(n)
    if config.pad_mode == "pow23":
        return min(next_pow2(n), 3 * next_pow2(-(-n // 3)))
    return next_pow2(n)


def fft_convolve(
    in1,
    in2,
    mode: str = "full",
    *,
    circular: bool = False,
    axis: int = -1,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Convolve two signals along ``axis`` via the FFT.

    mode: "full" | "same" | "valid" (linear); ignored for circular, which
    returns the period-max(n1,n2) circular convolution.
    """
    in1 = jnp.asarray(in1)
    in2 = jnp.asarray(in2)
    axis = axis % max(in1.ndim, 1)
    n1 = in1.shape[axis]
    n2 = in2.shape[axis]
    if n1 < 1 or n2 < 1:
        raise ValueError("inputs must be non-empty along the convolution axis")
    complex_input = jnp.issubdtype(in1.dtype, jnp.complexfloating) or jnp.issubdtype(
        in2.dtype, jnp.complexfloating
    )

    if circular:
        m = max(n1, n2)  # true circular period — no pow2 inflation
    else:
        m = _padded_len(n1 + n2 - 1, config)

    if complex_input:
        f1 = fft(in1, n=m, axis=axis, config=config)
        f2 = fft(in2, n=m, axis=axis, config=config)
        out = ifft(f1 * f2, axis=axis, config=config)
    else:
        f1 = rfft(in1, n=m, axis=axis, config=config)
        f2 = rfft(in2, n=m, axis=axis, config=config)
        out = irfft(f1 * f2, n=m, axis=axis, config=config)

    if circular:
        return out

    conv_length = n1 + n2 - 1
    out = jnp.moveaxis(out, axis, -1)
    if mode == "full":
        start, length = 0, conv_length
    elif mode == "same":
        larger = max(n1, n2)
        start, length = (conv_length - larger) // 2, larger
    elif mode == "valid":
        smaller = min(n1, n2)
        start, length = smaller - 1, max(n1, n2) - smaller + 1
    else:
        raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
    out = out[..., start : start + length]
    return jnp.moveaxis(out, -1, axis)


def fft_oaconvolve(
    in1,
    in2,
    mode: str = "full",
    *,
    axis: int = -1,
    block: Optional[int] = None,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Overlap-add FFT convolution for long signals against a short kernel.

    Splits ``in1`` into frames, convolves each with one batched rFFT pipeline
    (frames become the batch axis — ideal device shape), and overlap-adds.  Use
    when len(in1) >> len(in2): work drops from O(N log N) at the padded full
    length to O(N log n2).  Capability extension (scipy.signal.oaconvolve
    class); the reference pads the whole signal to a power of two
    (src/convolve.c:39-55), which is this function's degenerate single-block
    case.
    """
    in1 = jnp.asarray(in1)
    in2 = jnp.asarray(in2)
    axis = axis % max(in1.ndim, 1)
    in1 = jnp.moveaxis(in1, axis, -1)
    if in2.ndim != 1:
        in2 = jnp.ravel(in2)
    n1, n2 = in1.shape[-1], in2.shape[0]
    if n1 < 1 or n2 < 1:
        raise ValueError("inputs must be non-empty")
    if n2 > n1:
        # overlap-add needs the short side as the kernel; fall back
        out = fft_convolve(in1, in2.reshape((1,) * (in1.ndim - 1) + (-1,)),
                           mode=mode, config=config)
        return jnp.moveaxis(out, -1, axis)
    if block is None:
        block = max(8 * next_pow2(n2), 256)  # standard 8x-kernel block size
    m = _padded_len(block + n2 - 1, config)
    step = block
    n_blocks = -(-n1 // step)
    pad_sig = n_blocks * step - n1
    x = jnp.pad(in1, [(0, 0)] * (in1.ndim - 1) + [(0, pad_sig)])
    frames = x.reshape(*x.shape[:-1], n_blocks, step)

    kf = rfft(in2, n=m, config=config)
    ff = rfft(frames, n=m, config=config)
    conv = irfft(ff * kf, n=m, axis=-1, config=config)  # (..., n_blocks, m)

    # overlap-add: block b contributes to [b*step, b*step + m)
    total = (n_blocks - 1) * step + m
    idx = (np.arange(n_blocks)[:, None] * step + np.arange(m)[None, :]).reshape(-1)
    flat = conv.reshape(*conv.shape[:-2], n_blocks * m)
    out = jnp.zeros((*conv.shape[:-2], total), dtype=conv.dtype)
    out = out.at[..., idx].add(flat)

    conv_length = n1 + n2 - 1
    out = out[..., :conv_length]
    if mode == "full":
        pass
    elif mode == "same":
        larger = max(n1, n2)
        start = (conv_length - larger) // 2
        out = out[..., start : start + larger]
    elif mode == "valid":
        smaller = min(n1, n2)
        start = smaller - 1
        out = out[..., start : start + max(n1, n2) - smaller + 1]
    else:
        raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
    return jnp.moveaxis(out, -1, axis)


def fft_convolve2(
    in1,
    in2,
    mode: str = "full",
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """2-D FFT convolution over the last two axes (images/kernels), modes
    full/same/valid per axis — scipy.signal.fftconvolve's 2-D behavior,
    batched over leading axes.  Capability extension (the reference is 1-D
    only); built as separable padded transforms: rfft over the last axis,
    complex fft over the second-to-last, pointwise, inverse.
    """
    in1 = jnp.asarray(in1)
    in2 = jnp.asarray(in2)
    if in1.ndim < 2 or in2.ndim < 2:
        raise ValueError("fft_convolve2 needs >= 2-D inputs")
    s1 = in1.shape[-2:]
    s2 = in2.shape[-2:]
    if min(*s1, *s2) < 1:
        raise ValueError("inputs must be non-empty")
    full = (s1[0] + s2[0] - 1, s1[1] + s2[1] - 1)
    m = tuple(_padded_len(f, config) for f in full)
    complex_input = jnp.issubdtype(in1.dtype, jnp.complexfloating) or jnp.issubdtype(
        in2.dtype, jnp.complexfloating
    )
    if complex_input:
        f1 = fft(fft(in1, n=m[1], axis=-1, config=config), n=m[0], axis=-2, config=config)
        f2 = fft(fft(in2, n=m[1], axis=-1, config=config), n=m[0], axis=-2, config=config)
        prod = f1 * f2
        out = ifft(ifft(prod, axis=-1, config=config), axis=-2, config=config)
    else:
        f1 = fft(rfft(in1, n=m[1], axis=-1, config=config), n=m[0], axis=-2, config=config)
        f2 = fft(rfft(in2, n=m[1], axis=-1, config=config), n=m[0], axis=-2, config=config)
        prod = f1 * f2
        out = irfft(ifft(prod, axis=-2, config=config), n=m[1], axis=-1, config=config)

    def _slice(o, axis, n1, n2):
        conv_length = n1 + n2 - 1
        if mode == "full":
            start, length = 0, conv_length
        elif mode == "same":
            larger = max(n1, n2)
            start, length = (conv_length - larger) // 2, larger
        elif mode == "valid":
            smaller = min(n1, n2)
            start, length = smaller - 1, max(n1, n2) - smaller + 1
        else:
            raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
        idx = [slice(None)] * o.ndim
        idx[axis] = slice(start, start + length)
        return o[tuple(idx)]

    out = _slice(out, -2, s1[0], s2[0])
    out = _slice(out, -1, s1[1], s2[1])
    return out


def fft_convolven(
    in1,
    in2,
    mode: str = "full",
    *,
    axes=None,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """N-D FFT convolution over ``axes`` (scipy.signal.fftconvolve semantics).

    Unlike :func:`fft_convolve` (whose mode slicing pins the reference's 1-D
    behavior, convolve.c:162-201), this follows scipy exactly: ``same``
    returns the shape of ``in1`` per transform axis; ``valid`` requires one
    input to be at least as large as the other on every transform axis.
    Non-transform axes broadcast.  Real inputs use one rfft axis plus complex
    transforms on the rest; capability extension (the reference is 1-D only).
    """
    in1 = jnp.asarray(in1)
    in2 = jnp.asarray(in2)
    ndim = max(in1.ndim, in2.ndim)
    if in1.ndim < ndim:
        in1 = in1.reshape((1,) * (ndim - in1.ndim) + in1.shape)
    if in2.ndim < ndim:
        in2 = in2.reshape((1,) * (ndim - in2.ndim) + in2.shape)
    if axes is None:
        axes = tuple(range(ndim))
    else:
        axes = tuple(sorted({a % ndim for a in (
            axes if isinstance(axes, (tuple, list)) else (axes,))}))
    if not axes:
        raise ValueError("axes must be non-empty")
    for a in axes:
        if in1.shape[a] < 1 or in2.shape[a] < 1:
            raise ValueError("inputs must be non-empty along every transform axis")
    if mode == "valid":
        ge1 = all(in1.shape[a] >= in2.shape[a] for a in axes)
        ge2 = all(in2.shape[a] >= in1.shape[a] for a in axes)
        if not (ge1 or ge2):
            raise ValueError(
                "valid mode needs one input at least as large as the other "
                "on every transform axis"
            )
    elif mode not in ("full", "same"):
        raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")

    complex_input = jnp.issubdtype(in1.dtype, jnp.complexfloating) or jnp.issubdtype(
        in2.dtype, jnp.complexfloating
    )
    ms = {a: _padded_len(in1.shape[a] + in2.shape[a] - 1, config) for a in axes}
    last = axes[-1]

    def fwd(x):
        if complex_input:
            for a in axes:
                x = fft(x, n=ms[a], axis=a, config=config)
        else:
            x = rfft(x, n=ms[last], axis=last, config=config)
            for a in axes[:-1]:
                x = fft(x, n=ms[a], axis=a, config=config)
        return x

    s1 = in1.shape
    s2 = in2.shape
    prod = fwd(in1) * fwd(in2)
    if complex_input:
        for a in axes:
            prod = ifft(prod, axis=a, config=config)
        out = prod
    else:
        for a in axes[:-1]:
            prod = ifft(prod, axis=a, config=config)
        out = irfft(prod, n=ms[last], axis=last, config=config)

    idx = [slice(None)] * ndim
    for a in axes:
        full = s1[a] + s2[a] - 1
        if mode == "full":
            start, length = 0, full
        elif mode == "same":
            start, length = (full - s1[a]) // 2, s1[a]  # scipy: shape of in1
        else:  # valid
            smaller = min(s1[a], s2[a])
            start, length = smaller - 1, abs(s1[a] - s2[a]) + 1
        idx[a] = slice(start, start + length)
    return out[tuple(idx)]


def fft_correlate(
    in1,
    in2,
    mode: str = "full",
    *,
    axis: int = -1,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Cross-correlation via FFT (convolution with the reversed, conjugated
    second input) — a standard spectral-library capability the reference lacks."""
    in2 = jnp.asarray(in2)
    rev = jnp.flip(in2, axis=axis)
    if jnp.issubdtype(in2.dtype, jnp.complexfloating):
        rev = jnp.conj(rev)
    return fft_convolve(in1, rev, mode=mode, axis=axis, config=config)


def _direct_convolve_nd(in1: Array, in2: Array, axes) -> Array:
    """Full-mode direct convolution over ``axes`` via XLA's convolution op.

    ``lax.conv_general_dilated`` computes cross-correlation, so the kernel is
    flipped; complex inputs expand into real-part convolutions (matmul units have no
    complex path).  Supports 1-3 transform axes (XLA's spatial-dim limit)."""
    ax = tuple(a % in1.ndim for a in axes)
    nd = len(ax)
    if nd > 3:
        raise ValueError("direct method supports at most 3 transform axes")
    # move transform axes last, collapse the rest into a batch dim
    rest = [d for d in range(in1.ndim) if d not in ax]
    x = jnp.transpose(in1, rest + list(ax))
    k = jnp.transpose(in2, [d for d in range(in2.ndim) if d not in ax]
                      + [d for d in ax])
    if any(s != 1 for s in k.shape[:-nd]) and k.shape[:-nd] != x.shape[:-nd]:
        raise ValueError("direct method needs matching or size-1 batch dims")
    bshape = x.shape[:-nd]
    x = x.reshape((-1, 1) + x.shape[-nd:])          # (B, C=1, *spatial)
    kern = k.reshape((-1,) + k.shape[-nd:])

    def conv_real(xr, kr):
        pads = [(kr.shape[1 + d], kr.shape[1 + d]) for d in range(nd)]
        pads = [(p[0] - 1, p[1] - 1) for p in pads]
        kr = jnp.flip(kr.reshape((1, 1) + kr.shape[1:]),
                      axis=tuple(range(2, 2 + nd)))
        dn = jax.lax.conv_dimension_numbers(xr.shape, kr.shape,
                                            ("NC" + "HWD"[:nd],
                                             "OI" + "HWD"[:nd],
                                             "NC" + "HWD"[:nd]))
        return jax.lax.conv_general_dilated(
            xr, kr, window_strides=(1,) * nd, padding=pads,
            dimension_numbers=dn,
            precision=jax.lax.Precision.HIGHEST)

    c1 = jnp.issubdtype(x.dtype, jnp.complexfloating)
    c2 = jnp.issubdtype(kern.dtype, jnp.complexfloating)
    if kern.shape[0] == 1:
        kq = kern[0]
        if not c1 and not c2:
            out = conv_real(x.real.astype(jnp.float32),
                            kq.real.astype(jnp.float32)[None])[:, 0]
        else:
            xr, xi = jnp.real(x), jnp.imag(x)
            kr, ki = jnp.real(kq)[None], jnp.imag(kq)[None]
            rr = conv_real(xr, kr) - conv_real(xi, ki)
            ii = conv_real(xr, ki) + conv_real(xi, kr)
            out = jax.lax.complex(rr, ii)[:, 0]
    else:
        if kern.shape[0] != x.shape[0]:
            raise ValueError("direct method needs matching or size-1 batch dims")
        # per-batch kernels: vmap the all-axes case over the batch axis
        f = lambda xr, kr: _direct_convolve_nd(xr, kr, tuple(range(nd)))
        out = jax.vmap(f)(x[:, 0], kern)
    out = out.reshape(bshape + out.shape[1:])
    # restore original axis order
    inv = np.argsort(rest + list(ax))
    return jnp.transpose(out, inv)


def convolve(
    in1,
    in2,
    mode: str = "full",
    method: str = "auto",
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """N-D convolution with scipy.signal.convolve semantics (``same`` returns
    the shape of ``in1``; ``valid`` needs one input at least as large on every
    axis).  ``method``: "auto" | "fft" | "direct" — direct runs XLA's
    convolution op (≤3-D), fft runs the engine's padded transforms.  Output is
    fp32/complex64 (scipy preserves int dtypes; this library is float-native).
    Capability extension of the reference's 1-D ``fft_convolve``
    (src/convolve.c:74-214)."""
    in1 = jnp.asarray(in1)
    in2 = jnp.asarray(in2)
    if method not in ("auto", "fft", "direct"):
        raise ValueError(f"method must be auto/fft/direct, got {method!r}")
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
    if in1.ndim != in2.ndim:
        raise ValueError("in1 and in2 must have the same dimensionality")
    if method == "auto":
        method = "fft" if in1.ndim > 3 else choose_conv_method(in1, in2, mode)
    if method == "direct" and in1.ndim > 3:
        raise ValueError("method='direct' supports at most 3 dimensions "
                         "(XLA conv spatial limit); use method='fft'")
    if method == "fft":
        return fft_convolven(in1, in2, mode=mode, config=config)
    if mode == "valid":
        ge1 = all(a >= b for a, b in zip(in1.shape, in2.shape))
        ge2 = all(b >= a for a, b in zip(in1.shape, in2.shape))
        if not (ge1 or ge2):
            raise ValueError("valid mode needs one input at least as large as "
                             "the other on every axis")
    out = _direct_convolve_nd(in1, in2, tuple(range(in1.ndim)))
    idx = []
    for a in range(in1.ndim):
        full = in1.shape[a] + in2.shape[a] - 1
        if mode == "full":
            start, length = 0, full
        elif mode == "same":
            start, length = (full - in1.shape[a]) // 2, in1.shape[a]
        elif mode == "valid":
            smaller = min(in1.shape[a], in2.shape[a])
            start, length = smaller - 1, abs(in1.shape[a] - in2.shape[a]) + 1
        else:
            raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
        idx.append(slice(start, start + length))
    return out[tuple(idx)]


def correlate(
    in1,
    in2,
    mode: str = "full",
    method: str = "auto",
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """N-D cross-correlation, scipy.signal.correlate semantics: convolution of
    ``in1`` with the fully reversed, conjugated ``in2``."""
    in2 = jnp.asarray(in2)
    rev = jnp.flip(jnp.conj(in2), axis=tuple(range(in2.ndim)))
    return convolve(in1, rev, mode=mode, method=method, config=config)


def fftconvolve(in1, in2, mode: str = "full", axes=None, *,
                config: SpectralConfig = DEFAULT_CONFIG) -> Array:
    """scipy.signal.fftconvolve — alias of :func:`fft_convolven`."""
    return fft_convolven(in1, in2, mode=mode, axes=axes, config=config)


def oaconvolve(in1, in2, mode: str = "full", axes=None, *,
               config: SpectralConfig = DEFAULT_CONFIG) -> Array:
    """scipy.signal.oaconvolve.  The 1-D case runs the batched overlap-add
    pipeline (:func:`fft_oaconvolve`); multi-axis cases return the identical
    result via the padded full-length transforms (the overlap-add block
    decomposition only pays along one long axis)."""
    in1a = jnp.asarray(in1)
    in2a = jnp.asarray(in2)
    one_axis = (axes is not None and np.ndim(axes) == 0) or (
        axes is None and in1a.ndim == 1 and in2a.ndim == 1)
    if one_axis:
        axis = -1 if axes is None else int(axes)
        if in2a.ndim == 1 or all(s == 1 for i, s in enumerate(in2a.shape)
                                 if i != axis % in2a.ndim):
            return fft_oaconvolve(in1a, in2a, mode=mode, axis=axis,
                                  config=config)
    return fft_convolven(in1, in2, mode=mode, axes=axes, config=config)


def _pad_2d(x: Array, p0: int, p1: int, boundary: str, fillvalue) -> Array:
    pads = [(0, 0)] * (x.ndim - 2) + [(p0, p0), (p1, p1)]
    if boundary == "fill":
        return jnp.pad(x, pads, constant_values=fillvalue)
    if boundary == "wrap":
        return jnp.pad(x, pads, mode="wrap")
    if boundary == "symm":
        return jnp.pad(x, pads, mode="symmetric")
    raise ValueError(f"boundary must be fill/wrap/symm, got {boundary!r}")


def convolve2d(
    in1,
    in2,
    mode: str = "full",
    boundary: str = "fill",
    fillvalue=0,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """2-D convolution with scipy.signal.convolve2d's boundary semantics
    (fill/wrap/symm), batched over leading axes (extension; scipy is 2-D
    only).  Implemented by materializing the boundary as an explicit pad of
    ``in2.shape − 1`` per side, then slicing the padded full-mode FFT
    convolution — one fused rfft/fft pipeline either way."""
    in1 = jnp.asarray(in1)
    in2 = jnp.asarray(in2)
    if in1.ndim < 2 or in2.ndim != 2:
        raise ValueError("convolve2d needs a >=2-D in1 and a 2-D kernel")
    k0, k1 = in2.shape
    n0, n1 = in1.shape[-2:]
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
    if mode == "valid" and not ((n0 >= k0 and n1 >= k1) or
                                (k0 >= n0 and k1 >= n1)):
        raise ValueError("valid mode needs one input at least as large as "
                         "the other on every axis")
    if boundary == "fill":
        try:
            fv = complex(fillvalue)
        except (TypeError, ValueError):
            raise ValueError(f"fillvalue must be a scalar, got {fillvalue!r}")
        trivial_fill = fv == 0
    else:
        trivial_fill = False
    if trivial_fill:
        full = fft_convolve2(in1, in2[(None,) * (in1.ndim - 2)], mode="full",
                             config=config)
    else:
        p0, p1 = k0 - 1, k1 - 1
        xp = _pad_2d(in1, p0, p1, boundary, fillvalue)
        fullp = fft_convolve2(xp, in2[(None,) * (in1.ndim - 2)], mode="full",
                              config=config)
        # interior full-mode window of the padded result
        full = fullp[..., p0: p0 + n0 + k0 - 1, p1: p1 + n1 + k1 - 1]

    def _slice(o, axis, n, k):
        fl = n + k - 1
        if mode == "full":
            start, length = 0, fl
        elif mode == "same":
            start, length = (fl - n) // 2, n  # scipy: shape of in1
        else:
            smaller = min(n, k)
            start, length = smaller - 1, abs(n - k) + 1
        idx = [slice(None)] * o.ndim
        idx[axis] = slice(start, start + length)
        return o[tuple(idx)]

    return _slice(_slice(full, -2, n0, k0), -1, n1, k1)


def correlate2d(
    in1,
    in2,
    mode: str = "full",
    boundary: str = "fill",
    fillvalue=0,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """2-D cross-correlation with boundary handling
    (scipy.signal.correlate2d)."""
    in2 = jnp.asarray(in2)
    rev = jnp.flip(jnp.conj(in2), axis=(0, 1))
    return convolve2d(in1, rev, mode=mode, boundary=boundary,
                      fillvalue=fillvalue, config=config)


def choose_conv_method(in1, in2, mode: str = "full") -> str:
    """'fft' or 'direct' (scipy.signal.choose_conv_method semantics, sans
    timing): on an accelerator the FFT path wins long before it does on
    CPU — both routes are matmuls, but direct convolution scales as n·k while the
    padded-FFT path is n·log n — so the crossover is a small tap count."""
    s1 = np.shape(in1)[-1] if np.ndim(in1) else 1
    s2 = np.shape(in2)[-1] if np.ndim(in2) else 1
    if mode not in ("full", "same", "valid"):
        raise ValueError(f"mode must be full/same/valid, got {mode!r}")
    return "direct" if min(s1, s2) <= 16 else "fft"
