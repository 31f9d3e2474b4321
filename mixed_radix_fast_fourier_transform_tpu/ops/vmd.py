"""Variational mode decomposition (Dragomiretskiy & Zosso 2014).

EMD's optimization-based successor: decompose a signal into K band-limited
modes by ADMM on min Σ_k ‖∂_t[(δ + j/πt) * u_k]e^{−jω_k t}‖² subject to
Σu_k = f.  Every ADMM update is ELEMENTWISE in the frequency domain — a
Wiener filter per mode plus a spectral centroid — so where EMD's sifting is
inherently host-side and data-dependent (ops/emd.py), VMD jits end-to-end:
one engine FFT in, a `lax.fori_loop` of vectorized updates, one inverse
FFT out.  The batched nonstationary decomposition.

Mirror extension (standard) removes boundary splits; iteration count is
static for jit.  Capability extension; oracle-tested on tone/chirp
separation and center-frequency recovery.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.config import DEFAULT_CONFIG, SpectralConfig
from .fft import fft, ifft

Array = jax.Array

__all__ = ["vmd"]


def vmd(x, K: int, alpha: float = 2000.0, tau: float = 0.0,
        n_iter: int = 300,
        init_omega=None, *,
        config: SpectralConfig = DEFAULT_CONFIG
        ) -> Tuple[Array, Array]:
    """Decompose ``x`` (..., T) into ``K`` band-limited modes.

    Returns (modes (..., K, T), center_freqs (..., K) in cycles/sample,
    sorted ascending).  ``alpha`` is the bandwidth penalty (larger =
    narrower modes), ``tau`` the dual ascent step (0 = no exact-recon
    constraint, robust to noise).  ``n_iter`` is a fixed count (static
    for jit — VMD converges geometrically, so a fixed budget is the
    compiler-friendly stopping rule).

    ``init_omega``: ``"peaks"`` (default) seeds the center frequencies at
    the ``K`` largest mutually-separated spectral peaks (greedy on-device
    argmax with a T/(16K)-bin suppression window, per batch element) —
    ADMM descends from inside each tone's basin, where the classic
    uniform grid can drop a tone whose nearest grid point is closer to a
    stronger neighbor (measured: three tones at 0.05/0.15/0.31 lose 0.15
    from the uniform grid, recovered exactly from peaks).  ``"uniform"``
    is the Dragomiretskiy & Zosso grid; an explicit (K,) array pins the
    initialization.
    """
    x = jnp.asarray(x)
    if x.shape[-1] < 8:
        raise ValueError("vmd needs a signal of length >= 8")
    if not 1 <= K <= 32:
        raise ValueError(f"need 1 <= K <= 32, got {K}")
    if jnp.issubdtype(x.dtype, jnp.complexfloating):
        raise ValueError("vmd expects a real signal (decompose the real "
                         "and imaginary parts separately for IQ data)")
    if not jnp.issubdtype(x.dtype, jnp.floating):
        x = x.astype(config.dtype)
    T0 = x.shape[-1]
    half = T0 // 2
    # mirror extension: [rev(first half), x, rev(last half)]
    xm = jnp.concatenate([x[..., :half][..., ::-1], x,
                          x[..., T0 - half:][..., ::-1]], axis=-1)
    T = xm.shape[-1]
    f_hat = fft(xm.astype(jnp.complex64), config=config)
    # analytic one-sided spectrum: bins 0..T//2 (incl. Nyquist for even T
    # — fftfreq reports it as −0.5, so a freqs>=0 mask would drop it)
    freqs = np.fft.fftfreq(T)                       # cycles/sample
    pos = jnp.asarray((np.arange(T) <= T // 2).astype(np.float32))
    f_pos = f_hat * pos
    w = jnp.asarray(np.abs(freqs).astype(np.float32))  # |ω| grid

    batch = x.shape[:-1]
    if init_omega is None:
        init_omega = "peaks"
    if isinstance(init_omega, str):
        if init_omega == "peaks":
            # greedy K-peak pick on the one-sided power spectrum: argmax,
            # record w there, suppress a window, repeat (K static, jits)
            p = jnp.abs(f_pos) ** 2                    # (..., T)
            halfw = max(1, T // (16 * K))
            bins = jnp.arange(T)
            oms = []
            for _ in range(K):
                m = jnp.argmax(p, axis=-1)             # (...,)
                oms.append(jnp.take(w, m))
                keep = jnp.abs(bins - m[..., None]) > halfw
                p = p * keep
            omega_init = jnp.sort(jnp.stack(oms, axis=-1), axis=-1)
        elif init_omega == "uniform":
            omega0 = 0.5 * (np.arange(K) + 0.5) / K    # uniform in [0, 0.5)
            omega_init = jnp.broadcast_to(
                jnp.asarray(omega0, jnp.float32), batch + (K,))
        else:
            raise ValueError(
                f"init_omega must be 'peaks', 'uniform', or a (K,) array, "
                f"got {init_omega!r}")
    else:
        omega0 = np.asarray(init_omega, np.float64)
        if omega0.shape != (K,):
            raise ValueError(f"init_omega must have shape ({K},)")
        omega_init = jnp.broadcast_to(
            jnp.asarray(omega0, jnp.float32), batch + (K,))
    u_init = jnp.zeros(batch + (K, T), jnp.complex64)
    lam_init = jnp.zeros(batch + (T,), jnp.complex64)

    def body(_, state):
        u, omega, lam = state
        # sequential-over-k Gauss-Seidel sweep (K is small and static)
        sum_u = jnp.sum(u, axis=-2)
        for k in range(K):
            sum_u = sum_u - u[..., k, :]
            wk = omega[..., k][..., None]
            denom = 1.0 + 2.0 * alpha * (w - wk) ** 2
            u_k = (f_pos - sum_u + lam / 2.0) / denom
            u_k = u_k * pos                          # stay one-sided
            power = jnp.abs(u_k) ** 2
            num = jnp.sum(w * power, axis=-1)
            den = jnp.sum(power, axis=-1) + 1e-30
            omega = omega.at[..., k].set(num / den)
            u = u.at[..., k, :].set(u_k)
            sum_u = sum_u + u_k
        lam = lam + tau * (f_pos - sum_u)
        return (u, omega, lam)

    u, omega, _ = jax.lax.fori_loop(
        0, n_iter, body, (u_init, omega_init, lam_init))

    # modes: Hermitian-complete the one-sided spectra, inverse, un-mirror.
    # The flip/roll maps bin m → conj(u[(T−m) mod T]); the self-conjugate
    # bins (0 and, for even T, T/2) map onto themselves and would double —
    # reset them to their (real) one-sided values.
    u_full = u + jnp.conj(jnp.flip(jnp.roll(u, -1, axis=-1), axis=-1))
    u_full = u_full.at[..., 0].set(jnp.real(u[..., 0]).astype(u.dtype))
    if T % 2 == 0:
        u_full = u_full.at[..., T // 2].set(
            jnp.real(u[..., T // 2]).astype(u.dtype))
    modes = jnp.real(ifft(u_full, config=config))[..., half: half + T0]
    order = jnp.argsort(omega, axis=-1)
    modes = jnp.take_along_axis(modes, order[..., None], axis=-2)
    omega = jnp.take_along_axis(omega, order, axis=-1)
    return modes, omega
