"""Narrowband array processing: steering vectors, Bartlett/MVDR spectra,
beamformer weights.

Capability extension (the reference C library has none): the sensor-array
layer that complements the temporal subspace estimators in
``ops.subspace`` — spatial covariance from snapshots, conventional
(Bartlett) and Capon (MVDR) direction-of-arrival spectra, and MVDR
weights for interference-nulling beamforming.

Device shape: snapshot covariance is one batched contraction; spectrum
grids evaluate as dense steering-matrix contractions (A ∈ ℂ^{n×G} — one
einsum per term covers the whole angle grid); the single m×m
solve/inverse rides ``jnp.linalg`` (tiny, on-device).  Element positions
and angle grids are host numpy, like every plan constant (CLAUDE.md
conventions).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.config import DEFAULT_CONFIG, SpectralConfig

Array = jax.Array

__all__ = [
    "steering_vector", "spatial_covariance", "bartlett_spectrum",
    "mvdr_spectrum", "mvdr_weights", "music_doa",
]


def _positions(n_or_pos) -> np.ndarray:
    """Element positions in wavelengths, shape (n, d).  An int builds a
    standard half-wavelength ULA on the x-axis."""
    if np.isscalar(n_or_pos):
        n = int(n_or_pos)
        if n < 2:
            raise ValueError(f"need >= 2 elements, got {n}")
        return np.stack(
            [0.5 * np.arange(n), np.zeros(n)], axis=1
        )
    pos = np.asarray(n_or_pos, np.float64)
    if pos.ndim == 1:
        pos = np.stack([pos, np.zeros_like(pos)], axis=1)
    if pos.ndim != 2 or pos.shape[0] < 2 or pos.shape[1] not in (1, 2, 3):
        raise ValueError(
            f"positions must be (n>=2, d<=3) in wavelengths, got {pos.shape}"
        )
    return pos


def steering_vector(array, angles_deg) -> np.ndarray:
    """Narrowband steering matrix A (n_elements × n_angles), unit-modulus
    phases exp(j·2π·pᵀu(θ)) for element positions p in WAVELENGTHS.

    ``array``: an element count (half-wavelength ULA) or an (n, d)
    position array, d ≤ 3.  ``angles_deg``: azimuth broadside angles θ
    (plane waves arriving from direction u = (sinθ, cosθ, 0)) — scalar or
    1-D.  Host fp64 (plan constant), exact integer-free phases.
    """
    pos = _positions(array)
    th = np.deg2rad(np.atleast_1d(np.asarray(angles_deg, np.float64)))
    u = np.stack([np.sin(th), np.cos(th), np.zeros_like(th)], axis=0)
    proj = pos @ u[: pos.shape[1]]  # (n, G) path lengths in wavelengths
    return np.exp(2j * np.pi * proj)


def spatial_covariance(x, forward_backward: bool = False) -> Array:
    """Sample spatial covariance R = (1/T)·Σ_t x_t x_tᴴ from snapshots
    x (…, n_elements, n_snapshots); one contraction.
    ``forward_backward=True`` averages with J·conj(R)·J (centro-Hermitian
    smoothing — doubles the effective snapshot count for ULAs)."""
    x = jnp.asarray(x)
    if x.ndim < 2:
        raise ValueError("snapshots must be (…, n_elements, n_snapshots)")
    cdt = jnp.result_type(x.dtype, jnp.complex64)
    x = x.astype(cdt)
    R = jnp.einsum("...it,...jt->...ij", x, jnp.conj(x)) / x.shape[-1]
    if forward_backward:
        Rb = jnp.conj(R)[..., ::-1, ::-1]
        R = 0.5 * (R + Rb)
    return R


def _grid(array, angles_deg):
    if angles_deg is None:
        angles_deg = np.linspace(-90.0, 90.0, 361)
    A = steering_vector(array, angles_deg)
    return np.atleast_1d(np.asarray(angles_deg, np.float64)), A


def bartlett_spectrum(
    R, array, angles_deg=None
) -> Tuple[np.ndarray, Array]:
    """Conventional (delay-and-sum) spatial spectrum
    P(θ) = aᴴRa / n² over an angle grid (default −90°…90°, 0.5° steps).
    Returns ``(angles_deg, power)``; batched over leading R axes."""
    R = jnp.asarray(R)
    ang, A = _grid(array, angles_deg)
    n = A.shape[0]
    if R.shape[-1] != n or R.shape[-2] != n:
        raise ValueError(
            f"R trailing dims {R.shape[-2:]} do not match array size {n}"
        )
    Aj = jnp.asarray(A, jnp.result_type(R.dtype, jnp.complex64))
    p = jnp.einsum("ig,...ij,jg->...g", jnp.conj(Aj), R, Aj)
    return ang, jnp.real(p) / (n * n)


def mvdr_spectrum(
    R, array, angles_deg=None, diagonal_loading: float = 0.0
) -> Tuple[np.ndarray, Array]:
    """Capon/MVDR spatial spectrum P(θ) = 1 / (aᴴR⁻¹a) over an angle grid
    — sharper peaks than Bartlett at the cost of a covariance solve.
    ``diagonal_loading`` adds δ·tr(R)/n·I before inversion (robustness
    with few snapshots).  Returns ``(angles_deg, power)``."""
    R = jnp.asarray(R)
    ang, A = _grid(array, angles_deg)
    n = A.shape[0]
    if R.shape[-1] != n or R.shape[-2] != n:
        raise ValueError(
            f"R trailing dims {R.shape[-2:]} do not match array size {n}"
        )
    cdt = jnp.result_type(R.dtype, jnp.complex64)
    R = R.astype(cdt)
    if diagonal_loading:
        tr = jnp.real(jnp.trace(R, axis1=-2, axis2=-1))[..., None, None]
        R = R + (diagonal_loading * tr / n) * jnp.eye(n, dtype=cdt)
    Aj = jnp.asarray(A, cdt)
    RiA = jnp.linalg.solve(
        R, jnp.broadcast_to(Aj, R.shape[:-2] + Aj.shape)
    )
    q = jnp.real(jnp.einsum("ig,...ig->...g", jnp.conj(Aj), RiA))
    return ang, 1.0 / jnp.maximum(q, jnp.finfo(jnp.real(R).dtype).tiny)


def mvdr_weights(
    R, array, angle_deg: float, diagonal_loading: float = 0.0
) -> Array:
    """MVDR (Capon) beamformer weights w = R⁻¹a / (aᴴR⁻¹a) steered to
    ``angle_deg``: unit gain toward the look direction, interference +
    noise power minimized.  Apply as ``wᴴ·x``:
    ``y = jnp.einsum("i,...it->...t", w.conj(), snapshots)``."""
    R = jnp.asarray(R)
    cdt = jnp.result_type(R.dtype, jnp.complex64)
    R = R.astype(cdt)
    a = steering_vector(array, float(angle_deg))[:, 0]
    n = a.shape[0]
    if R.shape[-1] != n or R.shape[-2] != n:
        raise ValueError(
            f"R trailing dims {R.shape[-2:]} do not match array size {n}"
        )
    if diagonal_loading:
        tr = jnp.real(jnp.trace(R, axis1=-2, axis2=-1))[..., None, None]
        R = R + (diagonal_loading * tr / n) * jnp.eye(n, dtype=cdt)
    aj = jnp.asarray(a, cdt)
    Ria = jnp.linalg.solve(R, jnp.broadcast_to(aj, R.shape[:-1]))
    denom = jnp.einsum("...i,...i->...", jnp.conj(aj), Ria)
    return Ria / denom[..., None]


def music_doa(
    R, array, n_sources: int, angles_deg=None
) -> Tuple[np.ndarray, np.ndarray]:
    """MUSIC direction-of-arrival pseudospectrum
    P(θ) = 1 / ||E_nᴴ a(θ)||² from a HOST covariance (the m×m eigenbasis
    is design-time fp64, matching ``ops.subspace.music``).  Returns
    ``(angles_deg, pseudospectrum)`` as numpy."""
    Rh = np.asarray(R, np.complex128)
    if Rh.ndim != 2 or Rh.shape[0] != Rh.shape[1]:
        raise ValueError(f"R must be square, got {Rh.shape}")
    p = int(n_sources)
    if not 1 <= p < Rh.shape[0]:
        raise ValueError(
            f"n_sources must be in [1, {Rh.shape[0] - 1}], got {p}"
        )
    ang, A = _grid(array, angles_deg)
    if A.shape[0] != Rh.shape[0]:
        raise ValueError(
            f"R size {Rh.shape[0]} does not match array size {A.shape[0]}"
        )
    w, v = np.linalg.eigh(0.5 * (Rh + Rh.conj().T))
    En = v[:, : Rh.shape[0] - p]  # noise subspace (ascending eigenvalues)
    q = np.sum(np.abs(En.conj().T @ A) ** 2, axis=0)
    return ang, 1.0 / np.maximum(q, np.finfo(np.float64).tiny)
