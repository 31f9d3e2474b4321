"""Parametric and subspace spectral estimation: MUSIC, ESPRIT, Prony.

Line-spectra estimators that resolve sinusoids far below the FFT's
resolution limit (the MATLAB pmusic/rootmusic/pburg family).  Split of
labor: the data-dependent heavy lifting — forming the forward-backward
autocorrelation matrix from signal frames — is a batched contraction;
the tiny (m×m, m ≲ 64) eigendecompositions and polynomial rootings run
host-side fp64 (design-time-class numerics, same convention as filter
design).  The MUSIC pseudospectrum grid evaluation is again one dense
contraction.

Capability extension; the reference C library has no estimation layer.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.config import DEFAULT_CONFIG, SpectralConfig

Array = jax.Array

__all__ = ["corr_matrix", "music", "root_music", "esprit", "prony",
           "pisarenko"]


def corr_matrix(x, m: int, *, config: SpectralConfig = DEFAULT_CONFIG
                ) -> np.ndarray:
    """Forward-backward averaged autocorrelation matrix estimate (m × m).

    Frames the signal into overlapping length-m snapshots (one static
    gather), averages xxᴴ on device (one einsum), and applies the
    forward-backward exchange J·conj(R)·J — the standard variance halver
    for line-spectra subspace methods."""
    x = jnp.asarray(x)
    if x.ndim != 1:
        raise ValueError("corr_matrix expects a 1-D signal")
    n = x.shape[0]
    if not 2 <= m <= n // 2:
        raise ValueError(f"need 2 <= m <= n//2 = {n // 2}, got m={m}")
    idx = np.arange(n - m + 1)[:, None] + np.arange(m)[None, :]
    snaps = x[idx]  # (n-m+1, m)
    z = snaps.astype(jnp.complex64 if not jnp.issubdtype(
        snaps.dtype, jnp.complexfloating) else snaps.dtype)
    R = jnp.einsum("ti,tj->ij", z, jnp.conj(z),
                   precision=jax.lax.Precision.HIGHEST) / (n - m + 1)
    Rh = np.asarray(R, np.complex128)
    J = np.eye(m)[::-1]
    return 0.5 * (Rh + J @ Rh.conj() @ J)


def _noise_subspace(R: np.ndarray, p: int) -> np.ndarray:
    """(m, m−p) orthonormal noise-subspace basis from the smallest
    eigenvectors of the Hermitian correlation matrix."""
    w, v = np.linalg.eigh(R)  # ascending
    return v[:, : R.shape[0] - p]


def music(x, p: int, m: Optional[int] = None, nfreq: int = 512, *,
          fs: float = 1.0, config: SpectralConfig = DEFAULT_CONFIG
          ) -> Tuple[np.ndarray, np.ndarray]:
    """MUSIC pseudospectrum: (freqs, P) with P(f) = 1/‖Eₙᴴ a(f)‖², peaking
    at the p sinusoid frequencies (real input: count each real tone as TWO
    complex exponentials, i.e. pass p = 2·n_tones).

    ``m`` is the correlation order (default 2·p+2); ``nfreq`` grid points
    over [0, fs/2] for real input, [−fs/2, fs/2) for complex."""
    x_arr = np.asarray(x)
    real_input = not np.iscomplexobj(x_arr)
    if m is None:
        m = min(2 * p + 2, len(x_arr) // 2)
    if not p < m:
        raise ValueError(f"need p < m, got p={p}, m={m}")
    R = corr_matrix(x, m, config=config)
    En = _noise_subspace(R, p)
    if real_input:
        freqs = np.linspace(0.0, 0.5, nfreq, endpoint=False)
    else:
        freqs = np.linspace(-0.5, 0.5, nfreq, endpoint=False)
    a = np.exp(2j * np.pi * freqs[:, None] * np.arange(m)[None, :])
    # ‖Enᴴ a‖² on the grid — dense (nfreq, m) @ (m, m-p); the conjugate
    # matters for complex input (aᵀEn would mirror the frequency axis)
    proj = a.conj() @ En
    P = 1.0 / np.maximum(np.sum(np.abs(proj) ** 2, axis=1), 1e-30)
    return freqs * fs, P


def root_music(x, p: int, m: Optional[int] = None, *, fs: float = 1.0,
               config: SpectralConfig = DEFAULT_CONFIG) -> np.ndarray:
    """Root-MUSIC frequency estimates: the p roots of the noise-subspace
    polynomial closest to (and inside) the unit circle, as frequencies in
    the units of ``fs`` (sorted ascending; real input: conjugate pairs
    collapse, pass p = 2·n_tones and read the non-negative half)."""
    x_arr = np.asarray(x)
    if m is None:
        m = min(2 * p + 2, len(x_arr) // 2)
    if not p < m:
        raise ValueError(f"need p < m, got p={p}, m={m}")
    R = corr_matrix(x, m, config=config)
    En = _noise_subspace(R, p)
    # C(z) = aᵀ(1/z) En Enᴴ a(z): coefficients from the diagonal sums
    G = En @ En.conj().T
    coeffs = np.array([np.trace(G, offset=k) for k in
                       range(-(m - 1), m)])  # z^{-(m-1)} .. z^{m-1}
    roots = np.roots(coeffs[::-1])
    # strictly inside: each conjugate-reciprocal pair (z, 1/conj(z)) must
    # contribute exactly one member, or a split pair could fill two of the
    # p slots with the same frequency
    roots = roots[np.abs(roots) < 1.0]
    # keep the p roots nearest the unit circle
    order = np.argsort(np.abs(np.abs(roots) - 1.0))
    sel = roots[order[:p]]
    f = np.angle(sel) / (2.0 * np.pi)
    return np.sort(f) * fs


def esprit(x, p: int, m: Optional[int] = None, *, fs: float = 1.0,
           config: SpectralConfig = DEFAULT_CONFIG) -> np.ndarray:
    """ESPRIT (LS rotational invariance) frequency estimates, sorted
    ascending, in the units of ``fs``.  Real input: pass p = 2·n_tones."""
    x_arr = np.asarray(x)
    if m is None:
        m = min(2 * p + 2, len(x_arr) // 2)
    if not p < m:
        raise ValueError(f"need p < m, got p={p}, m={m}")
    R = corr_matrix(x, m, config=config)
    w, v = np.linalg.eigh(R)
    Es = v[:, -p:]  # signal subspace (largest eigenvalues)
    phi = np.linalg.lstsq(Es[:-1], Es[1:], rcond=None)[0]
    f = np.angle(np.linalg.eigvals(phi)) / (2.0 * np.pi)
    return np.sort(f) * fs


def pisarenko(x, p: int, *, fs: float = 1.0,
              config: SpectralConfig = DEFAULT_CONFIG) -> np.ndarray:
    """Pisarenko harmonic decomposition — MUSIC's m = p+1 special case
    (one noise eigenvector; exact for noiseless sinusoids)."""
    return root_music(x, p, m=p + 1, fs=fs, config=config)


def prony(x, p: int, *, fs: float = 1.0) -> Tuple[np.ndarray, np.ndarray,
                                                  np.ndarray]:
    """Prony's method: fit x[k] ≈ Σᵢ hᵢ·zᵢᵏ with p complex exponentials.

    Returns (freqs, dampings, amplitudes): frequencies in the units of
    ``fs``, per-sample damping factors |zᵢ|, and complex amplitudes hᵢ —
    the parametric decomposition for damped sinusoids (where Fourier bins
    smear).  Host fp64 linear prediction + Vandermonde solve."""
    x = np.asarray(x, np.complex128 if np.iscomplexobj(x) else np.float64)
    if x.ndim != 1:
        raise ValueError("prony expects a 1-D signal")
    n = len(x)
    if not 0 < p <= n // 2:
        raise ValueError(f"need 0 < p <= n//2 = {n // 2}, got p={p}")
    # linear prediction: x[k] = -sum a_j x[k-j]
    rows = np.arange(p, n)[:, None] - np.arange(1, p + 1)[None, :]
    A = x[rows]
    a = np.linalg.lstsq(A, -x[p:n], rcond=None)[0]
    z = np.roots(np.concatenate([[1.0], a]))
    V = z[None, :] ** np.arange(n)[:, None]
    h = np.linalg.lstsq(V, x.astype(np.complex128), rcond=None)[0]
    f = np.angle(z) / (2.0 * np.pi) * fs
    order = np.argsort(f)
    return f[order], np.abs(z)[order], h[order]
