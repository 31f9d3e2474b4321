"""Quadratic time-frequency representations: Wigner-Ville.

The (pseudo-)Wigner-Ville distribution of the analytic signal z:

    W[n, f] = Σ_tau  h[tau] · z[n+tau] · conj(z[n−tau]) · e^{−4πi·f·tau}

— optimal time-frequency concentration for linear chirps (the WVD of a
chirp is a line along its instantaneous frequency), at the price of
cross-terms between components, tamed by the ``window`` h (pseudo-WVD).

Device shape: the lag products gather through STATIC host index matrices
(z[n+tau], z[n−tau] are two fancy-indexed views — XLA lowers them to
slices), and the lag axis transforms with one batched engine FFT; no
per-time-step loop.  tftb / Matlab ``wvd`` discrete conventions (odd
window, frequency bins f_k = k·fs/(2·nfreq)).

Capability extension: the reference C library has no time-frequency
analysis at all.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.config import DEFAULT_CONFIG, SpectralConfig
from .fft import fft, ifft
from .signal import hilbert
from .stft import get_window

Array = jax.Array


def wigner_ville(
    x,
    nperseg: Optional[int] = None,
    hop: int = 1,
    window="hann",
    analytic: bool = True,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Pseudo-Wigner-Ville distribution: (…, T) -> (…, n_times, nperseg)
    real array, times n = 0, hop, 2·hop, … and frequency bins
    f_k = k·fs/(2·nperseg) (the lag FFT sees doubled frequencies, so the
    unaliased band is [0, fs/4] for real inputs made analytic; bins above
    nperseg/2 mirror).

    ``nperseg`` (odd; default min(257, largest odd <= T)) is the lag-window
    length — shorter windows smooth cross-terms at some frequency
    resolution cost.  ``analytic=True`` takes the Hilbert analytic signal
    first (halves cross-term interference for real inputs)."""
    x = jnp.asarray(x)
    if x.ndim < 1 or x.shape[-1] < 3:
        raise ValueError("wigner_ville needs a signal of length >= 3")
    T = x.shape[-1]
    if nperseg is None:
        nperseg = min(257, T if T % 2 else T - 1)
    nperseg = int(nperseg)
    if nperseg < 3 or nperseg % 2 == 0:
        raise ValueError(f"nperseg must be odd and >= 3, got {nperseg}")
    if nperseg > T:
        raise ValueError(f"nperseg={nperseg} > signal length {T}")
    if hop < 1:
        raise ValueError(f"hop must be >= 1, got {hop}")
    if analytic and not jnp.issubdtype(x.dtype, jnp.complexfloating):
        z = hilbert(x, config=config)
    else:
        z = x.astype(jnp.result_type(x.dtype, jnp.complex64))
    times = np.arange(0, T, hop)
    prod = _lag_products(z, T, nperseg, times)
    return jnp.real(fft(_windowed_lag_roll(prod, nperseg, window),
                        config=config))


def _lag_products(z: Array, T: int, nperseg: int,
                  times: np.ndarray, w: Optional[Array] = None) -> Array:
    """Instantaneous (cross-)correlation R[t, τ] = z[t+τ]·conj(w[t−τ]) over
    the static (times × lags −half..half) grid, zero outside the signal
    (``w`` defaults to ``z`` — the auto case)."""
    if w is None:
        w = z
    half = nperseg // 2
    tau = np.arange(-half, half + 1)  # (nperseg,)
    ip = times[:, None] + tau[None, :]
    im = times[:, None] - tau[None, :]
    valid = (ip >= 0) & (ip < T) & (im >= 0) & (im < T)
    ipc = np.clip(ip, 0, T - 1)
    imc = np.clip(im, 0, T - 1)
    zp = z[..., ipc]
    zm = jnp.conj(w[..., imc])
    return zp * zm * jnp.asarray(valid, jnp.real(z).dtype)


def _windowed_lag_roll(prod: Array, nperseg: int, window) -> Array:
    """Apply the symmetric lag window and reorder lags [0..half, −half..−1]
    so the final FFT sees lag 0 first."""
    half = nperseg // 2
    w = get_window(window, nperseg - 1, np.float64)
    h = np.concatenate([w, w[:1]])  # symmetric, centered at lag 0
    h = np.fft.ifftshift(h)  # reorder so index 0 is lag 0 after the roll
    prod = jnp.roll(prod, -half, axis=-1)
    return prod * jnp.asarray(h, jnp.real(prod).dtype)


def xwigner_ville(
    x,
    y,
    nperseg: Optional[int] = None,
    hop: int = 1,
    window="hann",
    analytic: bool = True,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Cross-Wigner-Ville distribution of two equal-length signals:
    complex (…, n_times, nperseg), W_xy(t, f) = FFT_τ{x(t+τ)·conj(y(t−τ))}
    — time-frequency coherence/phase analysis between channels (its phase
    carries the local delay; the auto case is :func:`wigner_ville`)."""
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    if x.shape != y.shape:
        raise ValueError("x and y must have the same shape")
    if x.ndim < 1 or x.shape[-1] < 3:
        raise ValueError("xwigner_ville needs signals of length >= 3")
    T = x.shape[-1]
    if nperseg is None:
        nperseg = min(257, T if T % 2 else T - 1)
    nperseg = int(nperseg)
    if nperseg < 3 or nperseg % 2 == 0:
        raise ValueError(f"nperseg must be odd and >= 3, got {nperseg}")
    if nperseg > T:
        raise ValueError(f"nperseg={nperseg} > signal length {T}")
    if hop < 1:
        raise ValueError(f"hop must be >= 1, got {hop}")

    def _prep(v):
        if analytic and not jnp.issubdtype(v.dtype, jnp.complexfloating):
            return hilbert(v, config=config)
        return v.astype(jnp.result_type(v.dtype, jnp.complex64))

    zx, zy = _prep(x), _prep(y)
    times = np.arange(0, T, hop)
    prod = _lag_products(zx, T, nperseg, times, w=zy)
    return fft(_windowed_lag_roll(prod, nperseg, window), config=config)


_COHEN_KERNELS = ("wigner", "choi-williams", "born-jordan")


def cohen_class(
    x,
    kernel: str = "choi-williams",
    sigma: float = 1.0,
    nperseg: Optional[int] = None,
    hop: int = 1,
    window="hann",
    analytic: bool = True,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Cohen-class time-frequency distribution: a pseudo-Wigner-Ville with
    an ambiguity-domain kernel Φ(ν, τ) that suppresses the WVD's
    oscillatory cross-terms (…, T) → real (…, n_times, nperseg).

    Kernels: ``"wigner"`` (Φ = 1, reproduces :func:`wigner_ville`),
    ``"choi-williams"`` (exponential Φ = exp(−(2πν·ℓ)²/σ); smaller ``sigma``
    = stronger cross-term suppression, more auto-term smearing) and
    ``"born-jordan"`` (sinc Φ).  Pipeline: instantaneous autocorrelation by
    static gathers → FFT over TIME to the ambiguity plane → host-precomputed
    kernel multiply → inverse time FFT → windowed lag FFT — four batched
    engine transforms, no data-dependent control flow.  Frequency bins match
    :func:`wigner_ville` (f_k = k·fs/(2·nperseg)).

    Capability extension (the classic Cohen 1989 family; the reference has
    no time-frequency layer at all).
    """
    if kernel not in _COHEN_KERNELS:
        raise ValueError(f"kernel must be one of {_COHEN_KERNELS}, "
                         f"got {kernel!r}")
    x = jnp.asarray(x)
    if x.ndim < 1 or x.shape[-1] < 3:
        raise ValueError("cohen_class needs a signal of length >= 3")
    T = x.shape[-1]
    if nperseg is None:
        nperseg = min(257, T if T % 2 else T - 1)
    nperseg = int(nperseg)
    if nperseg < 3 or nperseg % 2 == 0:
        raise ValueError(f"nperseg must be odd and >= 3, got {nperseg}")
    if nperseg > T:
        raise ValueError(f"nperseg={nperseg} > signal length {T}")
    if hop < 1:
        raise ValueError(f"hop must be >= 1, got {hop}")
    if analytic and not jnp.issubdtype(x.dtype, jnp.complexfloating):
        z = hilbert(x, config=config)
    else:
        z = x.astype(jnp.result_type(x.dtype, jnp.complex64))
    if kernel == "wigner":
        # no doppler filtering: only the hop-decimated rows are needed
        prod = _lag_products(z, T, nperseg, np.arange(0, T, hop))
        return jnp.real(fft(_windowed_lag_roll(prod, nperseg, window),
                            config=config))
    # the doppler filter needs the FULL time axis; subsample AFTER filtering
    prod = _lag_products(z, T, nperseg, np.arange(T))  # (..., T, nperseg)
    if kernel != "wigner":
        half = nperseg // 2
        ell = 2.0 * np.arange(-half, half + 1)          # true lag, samples
        theta = 2.0 * np.pi * np.fft.fftfreq(T)          # doppler, rad/sample
        if kernel == "choi-williams":
            phi = np.exp(-(theta[:, None] * ell[None, :]) ** 2
                         / max(sigma, 1e-12))
        else:  # born-jordan
            arg = theta[:, None] * ell[None, :] / 2.0
            phi = np.sinc(arg / np.pi)  # sin(arg)/arg
        A = fft(jnp.moveaxis(prod, -1, -2), config=config)  # over time
        A = A * jnp.asarray(phi.T, jnp.complex64)  # (..., nperseg, T)
        prod = jnp.moveaxis(ifft(A, config=config), -2, -1)
    if hop > 1:
        prod = prod[..., ::hop, :]
    C = fft(_windowed_lag_roll(prod, nperseg, window), config=config)
    return jnp.real(C)


def choi_williams(x, sigma: float = 1.0, nperseg: Optional[int] = None,
                  hop: int = 1, window="hann", analytic: bool = True, *,
                  config: SpectralConfig = DEFAULT_CONFIG) -> Array:
    """Choi-Williams exponential distribution — :func:`cohen_class` with the
    exponential kernel."""
    return cohen_class(x, kernel="choi-williams", sigma=sigma,
                       nperseg=nperseg, hop=hop, window=window,
                       analytic=analytic, config=config)


def _morlet_hat(xi: np.ndarray, w: float) -> np.ndarray:
    """Analytic Morlet in frequency: pi^{-1/4}·exp(-(xi-w)²/2) for xi > 0."""
    out = np.pi ** -0.25 * np.exp(-0.5 * (xi - w) ** 2)
    return np.where(xi > 0, out, 0.0)


def ssq_cwt(
    x,
    n_scales: int = 64,
    n_freqs: Optional[int] = None,
    fmin: float = 1.0 / 512.0,
    fmax: float = 0.5,
    w: float = 6.0,
    gamma: float = 1e-4,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
):
    """Synchrosqueezed continuous wavelet transform: (…, T) ->
    ``(S, freqs)`` with S complex (…, n_freqs, T) and ``freqs`` the
    log-spaced bin centers in cycles/sample.

    The Morlet CWT and its exact time derivative are computed in the
    frequency domain (one batched engine FFT + 2·n_scales ifft rows); the
    phase transform ω(a, b) = Im(∂_b W / W)/2π reassigns each (scale,
    time) cell to its nearest log-frequency bin, and the squeeze runs as a
    data-dependent ONE-HOT contraction over scales (the NUFFT-spreading
    trick — no scatter).  Cells with |W| <= gamma·max|W| are dropped.
    Tones and chirps collapse from the wavelet's constant-Q smear to
    ~single-bin ridges — the sharpened spectrogram of Daubechies'
    synchrosqueezing.

    Capability extension; conventions follow ssqueezepy's log-frequency
    ladder (S sums W over reassigned cells)."""
    x = jnp.asarray(x)
    if x.ndim < 1 or x.shape[-1] < 8:
        raise ValueError("ssq_cwt needs a signal of length >= 8")
    if not 0.0 < fmin < fmax <= 0.5:
        raise ValueError(
            f"need 0 < fmin < fmax <= 0.5 cycles/sample, got {fmin}, {fmax}"
        )
    if n_scales < 2:
        raise ValueError(f"n_scales must be >= 2, got {n_scales}")
    if n_freqs is None:
        n_freqs = n_scales
    if n_freqs < 2:
        raise ValueError(f"n_freqs must be >= 2, got {n_freqs}")
    T = x.shape[-1]
    if jnp.issubdtype(x.dtype, jnp.complexfloating):
        z = x
    else:
        z = hilbert(x, config=config)
    X = fft(z, config=config)  # (…, T)
    xi = 2.0 * np.pi * np.fft.fftfreq(T)  # rad/sample
    # scales: wavelet peak at a·xi = w  ->  a_j = w / (2π f_j)
    f_sc = np.exp(np.linspace(np.log(fmin), np.log(fmax), n_scales))
    scales = w / (2.0 * np.pi * f_sc)
    psi = np.stack([_morlet_hat(a * xi, w) for a in scales])  # (S, T) real
    rdtype = jnp.real(X).dtype
    psid = jnp.asarray(psi, rdtype)
    Wf = X[..., None, :] * psid  # (…, S, T) spectra (psi real: cheap)
    Wt = ifft(Wf, config=config)  # CWT rows
    xid = jnp.broadcast_to(jnp.asarray(xi, rdtype), psid.shape)
    dWt = ifft(Wf * jax.lax.complex(jnp.zeros_like(psid), xid), config=config)
    wr, wi = jnp.real(Wt), jnp.imag(Wt)
    dr, di = jnp.real(dWt), jnp.imag(dWt)
    mag2 = wr * wr + wi * wi
    # ω = Im(dW / W) / 2π  (cycles/sample)
    omega = (di * wr - dr * wi) / (
        2.0 * np.pi * jnp.maximum(mag2, jnp.asarray(1e-30, rdtype))
    )
    thresh = gamma * jnp.sqrt(
        jnp.max(mag2, axis=(-2, -1), keepdims=True)
    )
    alive = mag2 > thresh * thresh
    # nearest log-frequency bin
    fbins = np.exp(np.linspace(np.log(fmin), np.log(fmax), n_freqs))
    dlf = (np.log(fmax) - np.log(fmin)) / (n_freqs - 1)
    pos = jnp.log(jnp.maximum(omega, jnp.asarray(1e-30, rdtype)))
    idx = jnp.round((pos - float(np.log(fmin))) / dlf)
    in_range = (idx >= 0) & (idx <= n_freqs - 1) & alive & (omega > 0)
    idx = jnp.clip(idx, 0, n_freqs - 1)
    kgrid = jnp.arange(n_freqs, dtype=idx.dtype)
    onehot = (
        (idx[..., None] == kgrid) & in_range[..., None]
    ).astype(rdtype)  # (…, S, T, K)
    prec = config.op_precision
    Sr = jnp.einsum("...st,...stk->...kt", wr, onehot, precision=prec)
    Si = jnp.einsum("...st,...stk->...kt", wi, onehot, precision=prec)
    return jax.lax.complex(Sr, Si), fbins


def _window_derivative(w: np.ndarray) -> np.ndarray:
    """d/dj of a periodic window, exact in the DFT basis (host fp64)."""
    n = len(w)
    return np.fft.irfft(
        np.fft.rfft(w) * (2j * np.pi * np.fft.rfftfreq(n)), n=n
    )


def _centered_frames(x: Array, nperseg: int, hop: int, n_frames: int,
                     config: SpectralConfig) -> Array:
    """Frames aligned with ``stft(center=True)``: frame m's sample j is
    original sample m·hop + j − nperseg//2 (reflect-padded edges)."""
    from .stft import _frame

    pad = [(0, 0)] * (x.ndim - 1) + [(nperseg // 2, nperseg // 2)]
    xm = jnp.pad(x.astype(config.dtype), pad, mode="reflect")
    t = xm.shape[-1]
    full = nperseg + (n_frames - 1) * hop
    if full > t:
        xm = jnp.pad(xm, [(0, 0)] * (x.ndim - 1) + [(0, full - t)])
    return _frame(xm, nperseg, hop)[..., :n_frames, :]


def ssq_stft(
    x,
    nperseg: int = 256,
    noverlap: Optional[int] = None,
    window="hann",
    gamma: float = 1e-4,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
):
    """Synchrosqueezed STFT: (…, T) -> (S, freqs) with S complex
    (…, n_frames, nperseg//2+1) and ``freqs`` in cycles/sample.

    The phase transform ω(f, t) = f − Im(S_dw/S)/2π (S_dw the STFT taken
    with the window's derivative) reassigns each cell to its nearest
    LINEAR frequency bin; the squeeze is the same scatter-free one-hot
    contraction as :func:`ssq_cwt`, here over the frequency axis.  Tones
    collapse from the window's mainlobe smear to ~single bins.

    Phase convention: bins are referenced to the FRAME CENTER (the
    modified STFT S·e^{2πik·c/n}, c = nperseg//2 — a (−1)^k sign flip for
    even nperseg).  This makes the squeezed coefficients bin-sum
    invertible: :func:`issq_stft` reconstructs the signal at the frame
    centers by a plain sum over frequency bins."""
    from .stft import stft as _stft
    from .rfft import rfft as _rfft

    x = jnp.asarray(x)
    if jnp.issubdtype(x.dtype, jnp.complexfloating):
        raise ValueError("ssq_stft takes real signals")
    if noverlap is None:
        noverlap = nperseg - max(1, nperseg // 8)
    S = _stft(x, nperseg, noverlap, window, center=True, config=config)
    # derivative-window STFT: d/dt of the periodic window, host fp64
    w = get_window(window, nperseg, np.float64)
    wd = _window_derivative(w)
    hop = nperseg - noverlap
    frames = _centered_frames(x, nperseg, hop, S.shape[-2], config)
    Sd = _rfft(frames * jnp.asarray(wd, frames.dtype), config=config)
    # reference phases to the frame center (modified STFT): bin-sum
    # reconstruction then needs no per-bin phase factor (see issq_stft)
    cmod = np.exp(
        2j * np.pi * np.arange(nperseg // 2 + 1) * (nperseg // 2) / nperseg
    )
    S = S * jnp.asarray(cmod, S.dtype)
    Sd = Sd * jnp.asarray(cmod, Sd.dtype)
    sr, si = jnp.real(S), jnp.imag(S)
    dr, di = jnp.real(Sd), jnp.imag(Sd)
    mag2 = sr * sr + si * si
    rdtype = sr.dtype
    nb = S.shape[-1]
    fgrid = np.fft.rfftfreq(nperseg)  # cycles/sample
    omega = jnp.asarray(fgrid, rdtype) - (di * sr - dr * si) / (
        2.0 * np.pi * jnp.maximum(mag2, jnp.asarray(1e-30, rdtype))
    )
    thresh = gamma * jnp.sqrt(jnp.max(mag2, axis=(-2, -1), keepdims=True))
    alive = mag2 > thresh * thresh
    df = fgrid[1]
    idx = jnp.round(omega / df)
    in_range = (idx >= 0) & (idx <= nb - 1) & alive
    idx = jnp.clip(idx, 0, nb - 1)
    kgrid = jnp.arange(nb, dtype=idx.dtype)
    onehot = ((idx[..., None] == kgrid) & in_range[..., None]).astype(rdtype)
    prec = config.op_precision
    Sr = jnp.einsum("...tf,...tfk->...tk", sr, onehot, precision=prec)
    Si = jnp.einsum("...tf,...tfk->...tk", si, onehot, precision=prec)
    return jax.lax.complex(Sr, Si), fgrid


def issq_cwt(
    S,
    n_scales: int = 64,
    fmin: float = 1.0 / 512.0,
    fmax: float = 0.5,
    w: float = 6.0,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
):
    """Inverse synchrosqueezed CWT: Daubechies' one-integral formula.

    Because :func:`ssq_cwt` squeezes an amplitude-preserving (L1) Morlet
    CWT over a LOG-spaced scale ladder, summing the squeezed plane over
    frequency bins recovers Σ_j W(a_j, b) — and with Δln a constant,

        x(b) ≈ Re[ (Δln a / C_ψ) · Σ_k S(k, b) ],   C_ψ = ∫₀^∞ ψ̂(u) du/u,

    one dense reduction, no scatter/gather.  Pass the SAME analysis
    parameters (``n_scales``, ``fmin``, ``fmax``, ``w``) used at
    :func:`ssq_cwt` time; accurate for content whose frequencies lie in
    the interior of the [fmin, fmax] ladder (the scale integral is
    truncated at the ladder ends).
    """
    S = jnp.asarray(S)
    if not 0.0 < fmin < fmax <= 0.5:
        raise ValueError(
            f"need 0 < fmin < fmax <= 0.5 cycles/sample, got {fmin}, {fmax}"
        )
    if n_scales < 2:
        raise ValueError(f"n_scales must be >= 2, got {n_scales}")
    dloga = (np.log(fmax) - np.log(fmin)) / (n_scales - 1)
    # C_ψ by host fp64 quadrature (integrand a Gaussian bump at u = w)
    u = np.linspace(1e-4, w + 15.0, 200_001)
    trapz = getattr(np, "trapezoid", None) or np.trapz  # numpy<2 compat
    c_psi = float(trapz(_morlet_hat(u, w) / u, u))
    return jnp.sum(jnp.real(S), axis=-2) * jnp.asarray(
        dloga / c_psi, jnp.real(S).dtype
    )


def issq_stft(
    S,
    nperseg: int = 256,
    window="hann",
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
):
    """Inverse synchrosqueezed STFT: (…, n_frames, nperseg//2+1) ->
    (…, n_frames), the signal sampled AT THE FRAME CENTERS t_m = m·hop
    (pass hop=1 at analysis time for a full-rate reconstruction).

    :func:`ssq_stft` coefficients are frame-center referenced, so the
    full-spectrum inversion Σ_k S_full[k] = n·x(t_m)·w[c] needs only the
    one-sided-to-full weights (2 everywhere but DC/Nyquist):

        x(t_m) = (2·Re Σ_k S[m,k] − Re S[m,0] − Re S[m,n/2]) / (n·w[c]).
    """
    S = jnp.asarray(S)
    nb = S.shape[-1]
    if nb != nperseg // 2 + 1:
        raise ValueError(
            f"S has {nb} bins; expected nperseg//2+1 = {nperseg // 2 + 1}"
        )
    wvals = get_window(window, nperseg, np.float64)
    wc = float(wvals[nperseg // 2])
    if abs(wc) < 1e-12:
        raise ValueError("window vanishes at the frame center; not invertible")
    sr = jnp.real(S)
    total = 2.0 * jnp.sum(sr, axis=-1) - sr[..., 0]
    if nperseg % 2 == 0:
        total = total - sr[..., -1]
    return total / jnp.asarray(nperseg * wc, sr.dtype)


def reassigned_spectrogram(
    x,
    nperseg: int = 256,
    noverlap: Optional[int] = None,
    window="hann",
    gamma: float = 1e-4,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
):
    """Time-frequency reassigned spectrogram (Auger-Flandrin):
    (…, T) -> (E, freqs) with E real (…, n_frames, nperseg//2+1), frame m
    centered on sample m·hop and ``freqs`` in cycles/sample.

    Each spectrogram cell's ENERGY |S|² moves to its local center of
    gravity: frequency ω̂ = f − Im(S_dw/S)/2π (derivative-window STFT) and
    time t̂ = t_m + Re(S_tw/S) (time-weighted-window STFT) — impulses
    collapse to their true frame, chirps to their instantaneous-frequency
    ridge, in BOTH axes (synchrosqueezing sharpens frequency only).

    Device shape: the 2-D relocation is a small static loop over frame
    offsets o ∈ [−⌈c/hop⌉, ⌈c/hop⌉] (time shifts are bounded by the
    window half-length c), each a masked one-hot frequency contraction
    (matmul) placed by a static pad — no scatter.  Cells with
    |S| <= gamma·max|S| or targets outside the plane are dropped, as in
    reassignment literature (librosa.reassigned_spectrogram semantics with
    energy accumulation instead of coordinate output)."""
    from .stft import stft as _stft
    from .rfft import rfft as _rfft

    x = jnp.asarray(x)
    if jnp.issubdtype(x.dtype, jnp.complexfloating):
        raise ValueError("reassigned_spectrogram takes real signals")
    if noverlap is None:
        noverlap = nperseg - max(1, nperseg // 8)
    S = _stft(x, nperseg, noverlap, window, center=True, config=config)
    hop = nperseg - noverlap
    n_frames = S.shape[-2]
    nb = S.shape[-1]
    c = nperseg // 2
    w = get_window(window, nperseg, np.float64)
    wd = _window_derivative(w)
    wt = (np.arange(nperseg) - c) * w  # time-weighted window, sample units
    frames = _centered_frames(x, nperseg, hop, n_frames, config)
    Sd = _rfft(frames * jnp.asarray(wd, frames.dtype), config=config)
    St = _rfft(frames * jnp.asarray(wt, frames.dtype), config=config)
    sr, si = jnp.real(S), jnp.imag(S)
    dr, di = jnp.real(Sd), jnp.imag(Sd)
    tr, ti = jnp.real(St), jnp.imag(St)
    rdtype = sr.dtype
    mag2 = sr * sr + si * si
    denom = jnp.maximum(mag2, jnp.asarray(1e-30, rdtype))
    fgrid = np.fft.rfftfreq(nperseg)
    omega = jnp.asarray(fgrid, rdtype) - (di * sr - dr * si) / (
        2.0 * np.pi * denom
    )
    dt = (tr * sr + ti * si) / denom  # Re(St/S), samples
    thresh = gamma * jnp.sqrt(jnp.max(mag2, axis=(-2, -1), keepdims=True))
    alive = mag2 > thresh * thresh
    df = fgrid[1]
    fidx = jnp.round(omega / df)
    f_ok = (fidx >= 0) & (fidx <= nb - 1) & alive
    fidx = jnp.clip(fidx, 0, nb - 1)
    kgrid = jnp.arange(nb, dtype=fidx.dtype)
    onehot_f = (fidx[..., None] == kgrid).astype(rdtype)  # (…, t, f, k)
    off = jnp.round(dt / hop)  # frame offset of the reassigned time
    max_off = int(np.ceil(c / hop))
    prec = config.op_precision
    pieces = []
    for o in range(-max_off, max_off + 1):
        m_o = (f_ok & (off == o)).astype(rdtype)
        P = jnp.einsum(
            "...tf,...tfk->...tk", mag2 * m_o, onehot_f, precision=prec
        )
        # place rows at target frames t+o inside a 2·max_off-padded plane
        pads = [(0, 0)] * (P.ndim - 2) + [
            (max_off + o, max_off - o), (0, 0)
        ]
        pieces.append(jnp.pad(P, pads))
    total = sum(pieces)[..., max_off : max_off + n_frames, :]
    return total, fgrid


def stockwell(
    x,
    fmin: int = 0,
    fmax: Optional[int] = None,
    gamma: float = 1.0,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
):
    """Stockwell transform (S-transform): (…, T) -> (S, freqs) with S
    complex (…, K, T), rows the voice at each rfft bin k ∈ [fmin, fmax]
    (default the full one-sided ladder) and ``freqs`` in cycles/sample.

    The S-transform is an STFT whose Gaussian window scales with frequency
    (σ_f = f/γ — constant relative bandwidth like the CWT, but keeping the
    Fourier phase reference at t=0):

        S[k, t] = ifft_j( X[(j+k) mod T] · e^{−2π²γ²j²/k²} )[t] ,

    row k=0 carrying the mean.  Device shape: one engine FFT, a STATIC
    host-index roll gather to (K, T), a host Gaussian voice-window
    constant, and one batched engine ifft over rows — no loops.  Row sums
    recover X[k] exactly (the window is 1 at j=0), so :func:`istockwell`
    inverts losslessly when all rows are kept (Stockwell 1996 Eq. 19).

    ``gamma`` > 1 widens the window in time — σ_t = γ/(2πf) — trading
    event localization for sharper frequencies."""
    x = jnp.asarray(x)
    if jnp.issubdtype(x.dtype, jnp.complexfloating):
        raise ValueError("stockwell takes real signals")
    if x.ndim < 1 or x.shape[-1] < 4:
        raise ValueError("stockwell needs a signal of length >= 4")
    T = x.shape[-1]
    nb = T // 2 + 1
    if fmax is None:
        fmax = nb - 1
    if not (0 <= fmin <= fmax <= nb - 1):
        raise ValueError(
            f"need 0 <= fmin <= fmax <= {nb - 1}, got {fmin}, {fmax}"
        )
    if gamma <= 0:
        raise ValueError(f"gamma must be > 0, got {gamma}")
    z = x.astype(config.dtype)
    X = fft(z.astype(jnp.result_type(z.dtype, jnp.complex64)), config=config)
    ks = np.arange(fmin, fmax + 1)
    idx = np.arange(T)
    j = np.where(idx < (T + 1) // 2, idx, idx - T)  # signed bin offsets
    # voice windows in frequency: Gaussian of width k/γ
    G = np.exp(
        -2.0 * (np.pi * gamma * j[None, :].astype(np.float64)) ** 2
        / np.maximum(ks[:, None], 1) ** 2
    )
    rows = (j[None, :] + ks[:, None]) % T  # static gather indices
    V = X[..., rows] * jnp.asarray(G, jnp.real(X).dtype)
    S = ifft(V, config=config)
    if fmin == 0:
        # k=0 voice: the literature keeps the plain mean, not a window
        mean_row = jnp.mean(z, axis=-1, keepdims=True)[..., None, :]
        mean_row = jnp.broadcast_to(
            mean_row, S.shape[:-2] + (1, T)
        ).astype(S.dtype)
        S = jnp.concatenate([mean_row, S[..., 1:, :]], axis=-2)
    freqs = ks / T
    return S, freqs


def istockwell(
    S,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
):
    """Invert a FULL-ladder :func:`stockwell` transform: (…, T//2+1, T) ->
    (…, T) real.  Time-marginals of each voice recover the spectrum
    (Σ_t S[k, t] = X[k]); one engine irfft finishes."""
    from .rfft import irfft as _irfft

    S = jnp.asarray(S)
    if S.ndim < 2:
        raise ValueError("S must be (…, K, T)")
    nb, T = S.shape[-2], S.shape[-1]
    if nb != T // 2 + 1:
        raise ValueError(
            f"istockwell needs the full one-sided ladder: {T // 2 + 1} rows "
            f"for T={T}, got {nb}"
        )
    Xh = jnp.sum(S, axis=-1)
    # row 0 holds the mean replicated across time: its sum is T·mean = X[0]
    return _irfft(Xh, n=T, config=config)


def ambiguity(
    x,
    max_lag: Optional[int] = None,
    analytic: bool = True,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Narrowband ambiguity function A[τ, ν] = Σ_t z[t+τ]·z*[t−τ]·e^{−2πiνt/T}:
    (…, T) -> complex (…, 2·max_lag+1, T), lag axis τ = −max_lag..max_lag
    (in HALF-lag units like the discrete WVD — effective delay 2τ) and
    doppler bins ν = fftfreq(T)·T cycles (fftshifted to center zero).

    The dual of :func:`wigner_ville` (they are a 2-D Fourier pair): matched
    filters and delay-doppler radar maps read straight off it.  Same device
    shape as the WVD — static lag-index gathers, one batched engine FFT
    along TIME per lag row."""
    x = jnp.asarray(x)
    if x.ndim < 1 or x.shape[-1] < 3:
        raise ValueError("ambiguity needs a signal of length >= 3")
    T = x.shape[-1]
    if max_lag is None:
        max_lag = min(128, (T - 1) // 2)
    max_lag = int(max_lag)
    if not 1 <= max_lag <= (T - 1) // 2:
        raise ValueError(f"need 1 <= max_lag <= {(T - 1) // 2}, got {max_lag}")
    if analytic and not jnp.issubdtype(x.dtype, jnp.complexfloating):
        z = hilbert(x, config=config)
    else:
        z = x.astype(jnp.result_type(x.dtype, jnp.complex64))
    tau = np.arange(-max_lag, max_lag + 1)
    tgrid = np.arange(T)
    ip = tgrid[None, :] + tau[:, None]
    im = tgrid[None, :] - tau[:, None]
    valid = (ip >= 0) & (ip < T) & (im >= 0) & (im < T)
    prod = z[..., np.clip(ip, 0, T - 1)] * jnp.conj(
        z[..., np.clip(im, 0, T - 1)]
    )
    prod = prod * jnp.asarray(valid, jnp.real(z).dtype)
    A = fft(prod, config=config)  # doppler transform along time
    return jnp.fft.fftshift(A, axes=-1)
