"""Subpixel image registration by phase cross-correlation.

Guizar-Sicairos, Thurman & Fienup (2008) "Efficient subpixel image
registration algorithms": the integer shift comes from the peak of the
inverse FFT of the cross-power spectrum; the subpixel refinement evaluates
an UPSAMPLED DFT of the cross-power spectrum only in a small neighborhood
of the coarse peak — as two dense matrix-DFT contractions (the matrix
product IS the upsampling), which is exactly a matmul shape.  No
zero-padded giant FFT is ever built.

skimage.registration.phase_cross_correlation conventions: the returned
shift moves ``moving`` onto ``reference`` (apply with jnp.roll or a
Fourier shift); ``error`` is the translation-invariant RMS metric (eq. 10).
Capability extension over the reference C library (1-D transforms only).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.config import DEFAULT_CONFIG, SpectralConfig
from .fft import fft2, ifft2

Array = jax.Array


def _upsampled_dft(
    R: Array, nr: int, nc: int, region: int, up: int,
    row0: Array, col0: Array, prec,
) -> Array:
    """region x region samples of the inverse DFT of ``R`` on a grid of
    1/up pixel spacing starting at (row0, col0) — two matrix-DFT
    contractions with runtime-phase kernels."""
    fr = np.fft.fftfreq(nr)  # cycles/pixel, fft bin order
    fc = np.fft.fftfreq(nc)
    steps = jnp.arange(region, dtype=R.real.dtype) / up
    rows = row0[..., None] + steps  # (…, region) pixel offsets
    cols = col0[..., None] + steps
    frd = jnp.asarray(fr, R.real.dtype)
    fcd = jnp.asarray(fc, R.real.dtype)
    # kernel_r[…, p, u] = exp(+2πi·rows[p]·fr[u]) — inverse-transform sign
    ang_r = (2.0 * np.pi) * rows[..., :, None] * frd[None, :]
    ang_c = (2.0 * np.pi) * cols[..., :, None] * fcd[None, :]
    Rr, Ri = jnp.real(R), jnp.imag(R)

    def cmm(ar, ai, ang, sub):
        cs, sn = jnp.cos(ang), jnp.sin(ang)
        re = jnp.einsum(sub, cs, ar, precision=prec) - jnp.einsum(
            sub, sn, ai, precision=prec
        )
        im = jnp.einsum(sub, cs, ai, precision=prec) + jnp.einsum(
            sub, sn, ar, precision=prec
        )
        return re, im

    # contract rows: (…, p, nr) x (…, nr, nc) -> (…, p, nc)
    tr, ti = cmm(Rr, Ri, ang_r, "...pu,...uc->...pc")
    # contract cols: (…, p, nc) x (…, q, nc) -> (…, p, q)
    out_r, out_i = cmm(tr, ti, ang_c, "...qu,...pu->...pq")
    return jax.lax.complex(out_r, out_i)


def phase_cross_correlation(
    reference,
    moving,
    upsample_factor: int = 1,
    normalization: str = "phase",
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tuple[Array, Array]:
    """Estimate the (row, col) translation registering ``moving`` onto
    ``reference`` to 1/upsample_factor pixel precision.

    Returns ``(shift, error)``: ``shift`` (…, 2) float is the translation
    to APPLY to ``moving`` (e.g. via :func:`fourier_shift`) to align it
    with ``reference`` (the negative of moving's displacement);
    ``error`` is the translation-invariant RMS of Guizar-Sicairos eq. 10,
    evaluated on the unnormalized cross-correlation at the estimated
    shift.  ``normalization='phase'`` whitens the
    cross-power spectrum (robust to illumination); ``None`` is plain
    cross-correlation.  Leading batch axes register image pairs
    independently; fully jittable (static upsample_factor)."""
    a = jnp.asarray(reference)
    b = jnp.asarray(moving)
    if a.shape != b.shape or a.ndim < 2:
        raise ValueError(
            f"reference/moving must share a (…, H, W) shape, got "
            f"{a.shape} vs {b.shape}"
        )
    up = int(upsample_factor)
    if up < 1:
        raise ValueError(f"upsample_factor must be >= 1, got {up}")
    if normalization not in ("phase", None):
        raise ValueError(
            f"normalization must be 'phase' or None, got {normalization!r}"
        )
    nr, nc = a.shape[-2], a.shape[-1]
    prec = config.op_precision
    if not jnp.issubdtype(a.dtype, jnp.inexact):
        a = a.astype(config.dtype)
    if not jnp.issubdtype(b.dtype, jnp.inexact):
        b = b.astype(config.dtype)
    Fa = fft2(a, config=config)
    Fb = fft2(b, config=config)
    R0 = Fa * jnp.conj(Fb)  # unnormalized: the error metric's correlation
    if normalization == "phase":
        mag = jnp.sqrt(jnp.real(R0) ** 2 + jnp.imag(R0) ** 2)
        R = R0 / jnp.maximum(mag, jnp.asarray(1e-20, mag.dtype))
    else:
        R = R0
    cc = ifft2(R, config=config)
    power = jnp.real(cc) ** 2 + jnp.imag(cc) ** 2
    flat = power.reshape(*power.shape[:-2], -1)
    amax = jnp.argmax(flat, axis=-1)
    row = (amax // nc).astype(jnp.float32)
    col = (amax % nc).astype(jnp.float32)
    # wrap to signed shifts
    row = jnp.where(row > nr / 2, row - nr, row)
    col = jnp.where(col > nc / 2, col - nc, col)

    # error metric terms (eq. 10): |CC(shift)|² / (Σ|a|²·Σ|b|²), with the
    # UNNORMALIZED cross-correlation evaluated at the estimated peak
    ab2 = jnp.sum(jnp.abs(Fa) ** 2, axis=(-2, -1)) * jnp.sum(
        jnp.abs(Fb) ** 2, axis=(-2, -1)
    ) / float(nr * nc) ** 2

    def _err_at(sr, sc):
        pt = _upsampled_dft(
            R0, nr, nc, 1, 1, sr.astype(jnp.real(R0).dtype),
            sc.astype(jnp.real(R0).dtype), prec,
        ) / float(nr * nc)
        p2 = (jnp.real(pt) ** 2 + jnp.imag(pt) ** 2)[..., 0, 0]
        return jnp.sqrt(jnp.maximum(1.0 - p2 / jnp.maximum(ab2, 1e-30), 0.0))

    if up == 1:
        shift = jnp.stack([row, col], axis=-1)
        return shift, _err_at(row, col)

    # refine: upsampled DFT over a 1.5·up window centered on the coarse peak
    region = int(np.ceil(1.5 * up))
    row0 = row - (region // 2) / up
    col0 = col - (region // 2) / up
    local = _upsampled_dft(
        R, nr, nc, region, up, row0.astype(jnp.real(R).dtype),
        col0.astype(jnp.real(R).dtype), prec,
    ) / float(nr * nc)
    lpow = jnp.real(local) ** 2 + jnp.imag(local) ** 2
    lflat = lpow.reshape(*lpow.shape[:-2], -1)
    lmax = jnp.argmax(lflat, axis=-1)
    pr = (lmax // region).astype(jnp.float32) / up
    pc = (lmax % region).astype(jnp.float32) / up
    shift_r = row0.astype(jnp.float32) + pr
    shift_c = col0.astype(jnp.float32) + pc
    shift = jnp.stack([shift_r, shift_c], axis=-1)
    return shift, _err_at(shift_r, shift_c)


def fourier_shift(x, shift, *, config: SpectralConfig = DEFAULT_CONFIG) -> Array:
    """Shift an image by a (possibly subpixel) (row, col) translation via
    linear phase in the frequency domain (scipy.ndimage.fourier_shift
    composed with the transforms).  Real input -> real output."""
    x = jnp.asarray(x)
    if x.ndim < 2:
        raise ValueError("x must be (…, H, W)")
    shift = jnp.asarray(shift)
    if shift.shape[-1] != 2:
        raise ValueError("shift must end in a (row, col) pair")
    nr, nc = x.shape[-2], x.shape[-1]
    real_in = not jnp.issubdtype(x.dtype, jnp.complexfloating)
    X = fft2(x, config=config)
    fr = jnp.asarray(np.fft.fftfreq(nr), jnp.real(X).dtype)
    fc = jnp.asarray(np.fft.fftfreq(nc), jnp.real(X).dtype)
    ang = -2.0 * np.pi * (
        shift[..., 0:1, None] * fr[:, None] + shift[..., 1:2, None] * fc[None, :]
    )
    ph = jax.lax.complex(jnp.cos(ang), jnp.sin(ang))
    out = ifft2(X * ph, config=config)
    return jnp.real(out) if real_in else out


def unwrap_phase_2d(psi, *, config: SpectralConfig = DEFAULT_CONFIG) -> Array:
    """Weighted-least-squares 2-D phase unwrapping (Ghiglia-Romero DCT
    algorithm): solve ∇²φ = div(wrapped gradients) with Neumann boundaries
    via one DCT-II Poisson solve — the standard InSAR/MRI unwrapper for
    smooth phase fields.

    Input wrapped phase (…, H, W) in radians; returns the least-squares
    unwrapped surface (defined up to an additive constant, anchored to
    mean zero).  Exact for phase fields whose true gradients never exceed
    π per pixel; residue-crossed fields get the least-squares smooth
    fit."""
    from .dct import dctn, idctn

    psi = jnp.asarray(psi)
    if psi.ndim < 2 or psi.shape[-1] < 2 or psi.shape[-2] < 2:
        raise ValueError("psi must be (…, H, W) with H, W >= 2")
    if jnp.issubdtype(psi.dtype, jnp.complexfloating):
        raise ValueError("psi must be a real phase field (radians)")
    psi = psi.astype(config.dtype)
    H, W = psi.shape[-2], psi.shape[-1]

    def wrap(a):
        return (a + np.pi) % (2.0 * np.pi) - np.pi

    dx = wrap(psi[..., 1:, :] - psi[..., :-1, :])  # (…, H-1, W)
    dy = wrap(psi[..., :, 1:] - psi[..., :, :-1])  # (…, H, W-1)
    z = jnp.zeros_like(psi[..., :1, :])
    rho_x = jnp.concatenate([dx, z], axis=-2) - jnp.concatenate(
        [z, dx], axis=-2
    )
    zy = jnp.zeros_like(psi[..., :, :1])
    rho_y = jnp.concatenate([dy, zy], axis=-1) - jnp.concatenate(
        [zy, dy], axis=-1
    )
    rho = rho_x + rho_y
    # Neumann-BC Poisson solve: DCT-II eigenvalues 2cos(pi k/N) - 2
    R = dctn(rho, axes=(-2, -1), config=config)
    ei = 2.0 * np.cos(np.pi * np.arange(H) / H) - 2.0
    ej = 2.0 * np.cos(np.pi * np.arange(W) / W) - 2.0
    denom = ei[:, None] + ej[None, :]
    denom[0, 0] = 1.0  # DC: gauge freedom, set below
    R = R / jnp.asarray(denom, R.dtype)
    R = R.at[..., 0, 0].set(0.0)
    phi = idctn(R, axes=(-2, -1), config=config)
    return phi - jnp.mean(phi, axis=(-2, -1), keepdims=True)
