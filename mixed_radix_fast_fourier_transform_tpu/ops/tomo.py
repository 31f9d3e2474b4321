"""Tomography: Radon transform and filtered backprojection.

Built on the projection-slice theorem instead of image rotation: the 1-D
Fourier transform of the projection at angle θ is the 2-D image spectrum
sampled along the line (ω·cosθ, ω·sinθ).  Both directions therefore ride
the library's NUFFT — a type-2 evaluation of the image's pixel "modes"
at polar spectral points for :func:`radon`, and a type-1 spreading of
ramp-filtered slices back onto the Cartesian grid for :func:`iradon` —
plus one batched engine (i)fft per direction.  No rotation resampling,
no per-angle loop; every angle is one more row of non-uniform points in
a single NUFFT call (block one-hot spreading underneath).

Conventions: the image is (…, N, N) with pixel (row, col) = (y, x) and
the center at index N//2; ``theta`` are angles in RADIANS; the
projection p_θ(s) integrates the image along the line
x·cosθ + y·sinθ = s, with s on the integer offset grid −N//2 … N//2−1
(skimage.transform.radon's geometry at circle=True, theta in radians).

Capability extension: the reference C library has nothing comparable;
this is the NUFFT showcase application (MRI gridding's sibling).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.config import DEFAULT_CONFIG, SpectralConfig
from .fft import fftshift, ifftshift, fft, ifft
from .nufft import nufft1_2d, nufft2_2d

Array = jax.Array


def _polar_points(n: int, theta: np.ndarray):
    """Host polar spectral grid: ω_m·(cosθ, sinθ), ω_m = 2π·m/n."""
    m = np.arange(n) - n // 2
    omega = 2.0 * np.pi * m / n  # (n,), in [-π, π)
    xs = omega[None, :] * np.cos(theta)[:, None]  # (T, n)
    ys = omega[None, :] * np.sin(theta)[:, None]
    return omega, xs.ravel(), ys.ravel()


def radon(
    image,
    theta=None,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Radon transform: (…, N, N) -> sinogram (…, n_theta, N).

    One 2-D type-2 NUFFT evaluates the image spectrum on every polar
    slice at once; one batched centered ifft turns slices into
    projections.  ``theta`` defaults to 180 angles over [0, π)."""
    image = jnp.asarray(image)
    if image.ndim < 2 or image.shape[-1] != image.shape[-2]:
        raise ValueError("image must be (…, N, N)")
    n = image.shape[-1]
    if n < 4:
        raise ValueError(f"image too small (N={n})")
    if theta is None:
        theta = np.linspace(0.0, np.pi, 180, endpoint=False)
    theta = np.atleast_1d(np.asarray(theta, np.float64))
    if theta.ndim != 1 or theta.size == 0:
        raise ValueError("theta must be a non-empty 1-D angle array")
    nt = theta.size
    _, xs, ys = _polar_points(n, theta)
    # pixel (row=y, col=x) offsets are the "mode" indices: evaluate
    # G(ω) = Σ g[y, x] e^{-i(ω_x·x + ω_y·y)} at the polar points
    g = image.astype(jnp.result_type(image.dtype, jnp.complex64))
    slices = nufft2_2d(ys, xs, g, isign=-1, config=config)
    slices = slices.reshape(slices.shape[:-1] + (nt, n))
    # centered inverse FT of each slice: p(s), s = -N/2 .. N/2-1
    p = fftshift(
        ifft(ifftshift(slices, axes=-1), config=config), axes=-1
    )
    if not jnp.issubdtype(image.dtype, jnp.complexfloating):
        p = jnp.real(p)
    return p


def iradon(
    sinogram,
    theta=None,
    filter_name: str = "ramp",
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Filtered backprojection: sinogram (…, n_theta, N) -> (…, N, N).

    Each projection's centered fft is ramp-filtered (|ω|, optionally
    Hann- or Shepp-Logan-apodized) and spread back onto the Cartesian
    spectral grid with ONE 2-D type-1 NUFFT; an inverse 2-D mode
    synthesis (the adjoint of :func:`radon`'s evaluation) finishes.
    Quantitative: the discrete polar-measure weights Δθ·Δω/(4π²) are
    applied, so a disk of value 1 reconstructs to ~1."""
    sino = jnp.asarray(sinogram)
    if sino.ndim < 2:
        raise ValueError("sinogram must be (…, n_theta, N)")
    nt, n = sino.shape[-2], sino.shape[-1]
    if theta is None:
        theta = np.linspace(0.0, np.pi, nt, endpoint=False)
    theta = np.atleast_1d(np.asarray(theta, np.float64))
    if theta.ndim != 1 or theta.size != nt:
        raise ValueError(
            f"theta must be 1-D with {nt} angles, got shape {theta.shape}"
        )
    omega, xs, ys = _polar_points(n, theta)
    absw = np.abs(omega)
    if filter_name == "ramp":
        filt = absw
    elif filter_name == "hann":
        filt = absw * (0.5 + 0.5 * np.cos(omega))
    elif filter_name == "shepp-logan":
        wnz = np.where(omega == 0.0, 1.0, omega)
        filt = absw * np.where(omega == 0.0, 1.0, np.sin(wnz / 2) / (wnz / 2))
    else:
        raise ValueError(f"unknown filter {filter_name!r}")
    rdt = jnp.real(sino).dtype
    s = sino.astype(jnp.result_type(sino.dtype, jnp.complex64))
    slices = fftshift(fft(ifftshift(s, axes=-1), config=config), axes=-1)
    slices = slices * jnp.asarray(filt, rdt)
    # polar quadrature: Δθ = π/n_theta, Δω = 2π/N, measure 1/(4π²)
    scale = (np.pi / nt) * (2.0 * np.pi / n) / (4.0 * np.pi**2)
    strengths = (slices * scale).reshape(slices.shape[:-2] + (nt * n,))
    modes = nufft1_2d(ys, xs, strengths, (n, n), isign=+1, config=config)
    # adjoint synthesis: g[y, x] = Σ modes · e^{+i(...)} is exactly what
    # nufft1 with isign=+1 produced — modes ARE the pixel values here
    out = modes
    if not jnp.issubdtype(sino.dtype, jnp.complexfloating):
        out = jnp.real(out)
    return out
