"""Higher-order spectra: bispectrum and bicoherence.

The direct (frame-averaged) estimators of Nikias & Raghuveer 1987: segment
the signal, FFT each frame with the engine (one batched transform), and
average the frequency-domain triple products

    B(f1, f2) = E[ X(f1) · X(f2) · conj(X(f1 + f2)) ]

over frames.  The triple product is a static outer product plus one static
index map for X(f1+f2) — no data-dependent control flow, so the whole
estimator jits into a single fused program; the averaging contraction runs
as matmuls.  Quadratic phase coupling (three tones at f1, f2, f1+f2 with
phases φ1, φ2, φ1+φ2) shows up as |bicoherence| → 1 at (f1, f2); independent
phases average to 0 — the classic nonlinearity test a power spectrum cannot
perform, since it discards phase.

Capability extension (MATLAB HOSA class); the reference C library has
nothing comparable.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.config import DEFAULT_CONFIG, SpectralConfig
from .rfft import rfft
from .stft import get_window

Array = jax.Array

__all__ = ["bispectrum", "bicoherence"]


def _frame_ffts(x: Array, nperseg: int, noverlap: Optional[int],
                window, detrend: bool,
                config: SpectralConfig) -> Array:
    """(..., frames, nperseg//2+1) windowed frame spectra via one batched
    rfft (frames carry no mean, per the HOS convention — third-order
    cumulants require zero-mean segments)."""
    x = jnp.asarray(x)
    if noverlap is None:
        noverlap = nperseg // 2
    if not 0 <= noverlap < nperseg:
        raise ValueError(f"need 0 <= noverlap < nperseg, got {noverlap}")
    if x.shape[-1] < nperseg:
        raise ValueError(f"signal length {x.shape[-1]} < nperseg {nperseg}")
    hop = nperseg - noverlap
    n_frames = 1 + (x.shape[-1] - nperseg) // hop
    idx = (np.arange(n_frames)[:, None] * hop
           + np.arange(nperseg)[None, :])
    frames = x[..., idx]
    if detrend:
        frames = frames - jnp.mean(frames, axis=-1, keepdims=True)
    win = get_window(window, nperseg, dtype=np.float32)
    return rfft(frames * win, axis=-1, config=config)


def _principal_domain(X: Array, nfreq: Optional[int]):
    """(X1, Xs, valid): the truncated spectra, the sum-frequency gather
    X(f1+f2), and the static principal-domain mask 0 <= f2 <= f1,
    f1+f2 <= Nyquist — shared by both triple-product estimators."""
    n_bins = X.shape[-1]
    F = n_bins if nfreq is None else min(int(nfreq), n_bins)
    f1 = np.arange(F)[:, None]
    f2 = np.arange(F)[None, :]
    valid = (f2 <= f1) & (f1 + f2 <= n_bins - 1)
    fsum = np.where(valid, f1 + f2, 0)
    X1 = X[..., :F]
    Xs = X[..., fsum.reshape(-1)].reshape(*X.shape[:-1], F, F)
    return X1, Xs, valid


def bispectrum(x, nperseg: int = 128, noverlap: Optional[int] = None,
               window="hann", *, nfreq: Optional[int] = None,
               detrend: bool = True, return_freqs: bool = False,
               config: SpectralConfig = DEFAULT_CONFIG):
    """Direct bispectrum estimate over the principal domain
    0 <= f2 <= f1, f1 + f2 <= Nyquist.

    Returns a complex (..., F, F) array (F = nfreq or nperseg//2 + 1) with
    B[f1, f2] the frame-averaged triple product; entries outside the
    principal domain are zero.  ``return_freqs=True`` additionally returns
    the bin frequencies (cycles/sample).
    """
    X1, Xs, valid = _principal_domain(
        _frame_ffts(x, nperseg, noverlap, window, detrend, config), nfreq)
    # triple product, frames averaged: (..., frames, F, F) -> (..., F, F)
    prod = (X1[..., :, None] * X1[..., None, :]) * jnp.conj(Xs)
    B = jnp.mean(prod, axis=-3) * jnp.asarray(valid, prod.dtype)
    if return_freqs:
        return B, np.arange(X1.shape[-1]) / nperseg
    return B


def bicoherence(x, nperseg: int = 128, noverlap: Optional[int] = None,
                window="hann", *, nfreq: Optional[int] = None,
                detrend: bool = True, return_freqs: bool = False,
                config: SpectralConfig = DEFAULT_CONFIG):
    """Squared bicoherence b²(f1, f2) ∈ [0, 1] — the bispectrum normalized
    by its Cauchy-Schwarz bound (Kim & Powers 1979):

        b² = |E[X1·X2·conj(Xs)]|² / (E[|X1·X2|²] · E[|Xs|²])

    → 1 for perfect quadratic phase coupling at (f1, f2), → 0 for
    independent phases.  Same principal-domain layout as :func:`bispectrum`.
    """
    X1, Xs, valid = _principal_domain(
        _frame_ffts(x, nperseg, noverlap, window, detrend, config), nfreq)
    pair = X1[..., :, None] * X1[..., None, :]
    num = jnp.abs(jnp.mean(pair * jnp.conj(Xs), axis=-3)) ** 2
    den = (jnp.mean(jnp.abs(pair) ** 2, axis=-3)
           * jnp.mean(jnp.abs(Xs) ** 2, axis=-3))
    b2 = jnp.where(den > 0, num / jnp.maximum(den, 1e-30), 0.0)
    b2 = b2 * jnp.asarray(valid, b2.dtype)
    if return_freqs:
        return b2, np.arange(X1.shape[-1]) / nperseg
    return b2
