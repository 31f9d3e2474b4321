"""Short-time Fourier transform family: stft / istft / spectrogram.

Capability extension beyond the reference (which offers only single-shot
transforms and convolution) — built for the device: framing is a reshape/gather
into a (frames, nperseg) batch, the window multiply fuses into the rFFT's
first stage matmul, and the whole thing is one batched matmul pipeline.
istft uses windowed overlap-add with the standard NOLA normalization.
"""

from __future__ import annotations

from typing import Optional

import functools as _functools

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.config import DEFAULT_CONFIG, SpectralConfig
from .rfft import irfft, rfft

Array = jax.Array


def _sym_triang(m: int) -> np.ndarray:
    n = np.arange(1, (m + 1) // 2 + 1, dtype=np.float64)
    if m % 2 == 0:
        w = (2 * n - 1.0) / m
        return np.concatenate([w, w[::-1]])
    w = 2 * n / (m + 1.0)
    return np.concatenate([w, w[-2::-1]])


def _sym_parzen(m: int) -> np.ndarray:
    n = np.arange(-(m - 1) / 2.0, (m - 1) / 2.0 + 0.5, 1.0)
    na = np.abs(n) / (m / 2.0)
    outer = 2.0 * (1.0 - na) ** 3
    inner = 1.0 - 6.0 * na**2 + 6.0 * na**3
    return np.where(np.abs(n) <= (m - 1) / 4.0, inner, outer)


def _sym_bohman(m: int) -> np.ndarray:
    fac = np.abs(np.linspace(-1.0, 1.0, m))
    w = (1.0 - fac) * np.cos(np.pi * fac) + np.sin(np.pi * fac) / np.pi
    w[0] = w[-1] = 0.0
    return w


def _sym_cosine(m: int) -> np.ndarray:
    return np.sin(np.pi / m * (np.arange(m) + 0.5))


def _sym_barthann(m: int) -> np.ndarray:
    fac = np.abs(np.arange(m, dtype=np.float64) / (m - 1.0) - 0.5)
    return 0.62 - 0.48 * fac + 0.38 * np.cos(2 * np.pi * fac)


def _sym_lanczos(m: int) -> np.ndarray:
    return np.sinc(2 * np.arange(m, dtype=np.float64) / (m - 1.0) - 1.0)


def _sym_nuttall(m: int) -> np.ndarray:
    a = (0.3635819, 0.4891775, 0.1365995, 0.0106411)
    fac = np.linspace(-np.pi, np.pi, m)
    return sum(a[k] * np.cos(k * fac) for k in range(4))


def _sym_exponential(m: int, tau: float) -> np.ndarray:
    n = np.arange(m, dtype=np.float64)
    return np.exp(-np.abs(n - (m - 1) / 2.0) / tau)


def _sym_chebwin(m: int, at: float) -> np.ndarray:
    """Dolph-Chebyshev window of ``at`` dB sidelobe attenuation (scipy's
    frequency-sampling construction: T_{m-1} on the scaled cosine grid,
    one real DFT back, peak-normalized)."""
    if np.abs(10 ** (np.abs(at) / 20.0)) > 1e150:
        raise ValueError("chebwin attenuation too large")
    order = m - 1.0
    beta = np.cosh(1.0 / order * np.arccosh(10 ** (np.abs(at) / 20.0)))
    k = np.arange(m, dtype=np.float64)
    x = beta * np.cos(np.pi * k / m)
    p = np.zeros_like(x)
    gt = x > 1
    lt = x < -1
    mid = ~(gt | lt)
    p[gt] = np.cosh(order * np.arccosh(x[gt]))
    p[lt] = (2 * (m % 2) - 1) * np.cosh(order * np.arccosh(-x[lt]))
    p[mid] = np.cos(order * np.arccos(x[mid]))
    if m % 2:
        w = np.real(np.fft.fft(p))
        n = (m + 1) // 2
        w = w[:n]
        w = np.concatenate([w[n - 1 : 0 : -1], w])
    else:
        p = p * np.exp(1j * np.pi / m * np.arange(m))
        w = np.real(np.fft.fft(p))
        n = m // 2 + 1
        w = np.concatenate([w[n - 1 : 0 : -1], w[1:n]])
    return w / np.max(w)


_SYM_WINDOWS = {
    "triang": _sym_triang,
    "parzen": _sym_parzen,
    "bohman": _sym_bohman,
    "cosine": _sym_cosine,
    "barthann": _sym_barthann,
    "lanczos": _sym_lanczos,
    "nuttall": _sym_nuttall,
}


def get_window(window, nperseg: int, dtype=np.float32, *, sym: bool = False) -> np.ndarray:
    """Named window ('hann', 'hamming', 'blackman', 'blackmanharris',
    'bartlett', 'flattop', 'boxcar', 'triang', 'parzen', 'bohman',
    'cosine', 'barthann', 'lanczos', 'nuttall', ('kaiser', beta),
    ('tukey', alpha), ('gaussian', std), ('exponential', tau),
    ('chebwin', attenuation_dB)) or an explicit array — scipy.signal
    window set.  Periodic (DFT-even) convention by default, matching
    scipy's spectral estimators; ``sym=True`` returns the symmetric
    (filter-design) variant — a symmetric window of length n is the
    periodic window of length n-1 with its (symmetric) first sample
    appended.  Used by the FIR designers (firwin/remez) and the CQT
    kernel builder."""
    if sym:
        if not isinstance(window, (str, tuple)):
            w = np.asarray(window, dtype=dtype)
            if w.shape != (nperseg,):
                raise ValueError(f"window shape {w.shape} != ({nperseg},)")
            return w
        if nperseg < 2:
            return np.ones(nperseg, dtype)
        wp = get_window(window, nperseg - 1, np.float64)
        return np.concatenate([wp, wp[:1]]).astype(dtype)
    if nperseg < 2 and isinstance(window, (str, tuple)):
        # scipy's length guard: every named window degenerates to ones
        # (the periodic formulas would return their left-edge sample)
        return np.ones(max(nperseg, 0), dtype)
    if isinstance(window, tuple):
        name, *params = window
        if name == "exponential":
            # ("exponential", tau) or scipy's ("exponential", None, tau);
            # custom centers are not supported (they break the periodic
            # drop-last identity)
            if len(params) == 2 and params[0] is None:
                tau = float(params[1])
            elif len(params) == 1 and params[0] is not None:
                tau = float(params[0])
            else:
                raise ValueError(f"unsupported exponential window {window!r}")
            return _sym_exponential(nperseg + 1, tau)[:nperseg].astype(dtype)
        if len(params) != 1 or name not in (
            "kaiser", "tukey", "gaussian", "chebwin"
        ):
            raise ValueError(f"unknown parameterized window {window!r}")
        if name == "chebwin":
            return _sym_chebwin(nperseg + 1, float(params[0]))[:nperseg].astype(dtype)
        n = np.arange(nperseg, dtype=np.float64)
        if name == "kaiser":
            beta = float(params[0])
            ratio = 2.0 * n / nperseg - 1.0
            w = np.i0(beta * np.sqrt(np.maximum(1.0 - ratio ** 2, 0.0))) / np.i0(beta)
        elif name == "tukey":
            # periodic = symmetric length nperseg+1 with the last point dropped
            alpha = float(params[0])
            if alpha <= 0:
                w = np.ones(nperseg)
            elif alpha >= 1:
                w = 0.5 - 0.5 * np.cos(2 * np.pi * n / nperseg)
            else:
                edge = alpha * nperseg / 2.0
                w = np.ones(nperseg)
                lo = n < edge
                w[lo] = 0.5 * (1 + np.cos(np.pi * (n[lo] / edge - 1.0)))
                hi = n > nperseg - edge
                w[hi] = 0.5 * (1 + np.cos(np.pi * ((nperseg - n[hi]) / edge - 1.0)))
        else:  # gaussian
            std = float(params[0])
            w = np.exp(-0.5 * ((n - nperseg / 2.0) / std) ** 2)
        return w.astype(dtype)
    if isinstance(window, str):
        n = np.arange(nperseg, dtype=np.float64)
        ph = 2 * np.pi * n / nperseg
        if window == "hann":
            w = 0.5 - 0.5 * np.cos(ph)
        elif window == "hamming":
            w = 0.54 - 0.46 * np.cos(ph)
        elif window == "blackman":
            w = 0.42 - 0.5 * np.cos(ph) + 0.08 * np.cos(2 * ph)
        elif window == "blackmanharris":
            w = (0.35875 - 0.48829 * np.cos(ph) + 0.14128 * np.cos(2 * ph)
                 - 0.01168 * np.cos(3 * ph))
        elif window == "flattop":
            w = (0.21557895 - 0.41663158 * np.cos(ph) + 0.277263158 * np.cos(2 * ph)
                 - 0.083578947 * np.cos(3 * ph) + 0.006947368 * np.cos(4 * ph))
        elif window == "bartlett":
            w = 1.0 - np.abs(2.0 * n / nperseg - 1.0)
        elif window == "boxcar":
            w = np.ones(nperseg)
        elif window in _SYM_WINDOWS:
            # periodic = symmetric length n+1 with the last point dropped
            w = _SYM_WINDOWS[window](nperseg + 1)[:nperseg]
        else:
            raise ValueError(f"unknown window {window!r}")
        return w.astype(dtype)
    w = np.asarray(window, dtype=dtype)
    if w.shape != (nperseg,):
        raise ValueError(f"window shape {w.shape} != ({nperseg},)")
    return w


def _frame(x: Array, nperseg: int, hop: int) -> Array:
    """(..., T) -> (..., frames, nperseg) via a strided gather XLA turns into
    cheap dynamic slices (frame starts are static)."""
    t = x.shape[-1]
    n_frames = 1 + (t - nperseg) // hop
    starts = np.arange(n_frames) * hop
    idx = starts[:, None] + np.arange(nperseg)[None, :]
    return x[..., idx]


def stft(
    x,
    nperseg: int = 256,
    noverlap: Optional[int] = None,
    window="hann",
    *,
    center: bool = True,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """STFT of a real signal: (..., T) -> (..., frames, nperseg//2 + 1).

    ``center=True`` reflect-pads by nperseg//2 so frame f is centered on
    sample f·hop (librosa/scipy convention).
    """
    x = jnp.asarray(x)
    if noverlap is None:
        noverlap = nperseg // 2
    if not 0 <= noverlap < nperseg:
        raise ValueError(f"need 0 <= noverlap < nperseg, got {noverlap}")
    hop = nperseg - noverlap
    if center:
        pad = [(0, 0)] * (x.ndim - 1) + [(nperseg // 2, nperseg // 2)]
        x = jnp.pad(x, pad, mode="reflect")
    if x.shape[-1] < nperseg:
        raise ValueError(f"signal length {x.shape[-1]} < nperseg {nperseg}")
    # zero-pad the tail so every sample lands in a whole frame
    t = x.shape[-1]
    n_frames = 1 + -(-(t - nperseg) // hop)
    full = nperseg + (n_frames - 1) * hop
    if full > t:
        pad = [(0, 0)] * (x.ndim - 1) + [(0, full - t)]
        x = jnp.pad(x, pad)
    w = jnp.asarray(get_window(window, nperseg, np.dtype(config.dtype)))
    frames = _frame(x, nperseg, hop) * w
    return rfft(frames, config=config)


def istft(
    spec,
    nperseg: int = 256,
    noverlap: Optional[int] = None,
    window="hann",
    *,
    center: bool = True,
    length: Optional[int] = None,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Inverse STFT with windowed overlap-add (NOLA normalization)."""
    spec = jnp.asarray(spec)
    if noverlap is None:
        noverlap = nperseg // 2
    hop = nperseg - noverlap
    frames = irfft(spec, n=nperseg, config=config)  # (..., n_frames, nperseg)
    n_frames = frames.shape[-2]
    t_padded = nperseg + (n_frames - 1) * hop
    w = jnp.asarray(get_window(window, nperseg, np.dtype(config.dtype)))
    frames = frames * w

    # overlap-add via segment scatter: out[f*hop + i] += frames[f, i]
    starts = np.arange(n_frames) * hop
    idx = (starts[:, None] + np.arange(nperseg)[None, :]).reshape(-1)
    batch = frames.shape[:-2]
    flat = frames.reshape(*batch, n_frames * nperseg)
    out = jnp.zeros((*batch, t_padded), dtype=frames.dtype)
    out = out.at[..., idx].add(flat)

    # NOLA normalization: sum of squared windows at each sample — from the
    # HOST window (the device constant is a tracer under an outer trace,
    # e.g. griffinlim's fori_loop)
    wsq = np.zeros(t_padded, dtype=np.float64)
    w_np = get_window(window, nperseg, np.float64) ** 2
    for s in starts:
        wsq[s : s + nperseg] += w_np
    safe = np.where(wsq > 1e-10, wsq, 1.0)
    norm = jnp.asarray(np.where(wsq > 1e-10, 1.0 / safe, 0.0), dtype=out.dtype)
    out = out * norm

    if center:
        out = out[..., nperseg // 2 : t_padded - nperseg // 2]
    if length is not None:
        out = out[..., :length]
    return out


def spectrogram(
    x,
    nperseg: int = 256,
    noverlap: Optional[int] = None,
    window="hann",
    *,
    center: bool = True,
    power: float = 2.0,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """|STFT|^power — (..., frames, bins) real."""
    s = stft(x, nperseg, noverlap, window, center=center, config=config)
    mag = jnp.abs(s)
    if power == 1.0:
        return mag
    if power == 2.0:
        return jnp.real(s) ** 2 + jnp.imag(s) ** 2
    return mag ** power


@_functools.lru_cache(maxsize=16)
def _dpss_host(M: int, NW: float, Kmax: int):
    """Host fp64 DPSS tapers + concentration ratios.

    Slepian's trick (Percival & Walden 1993 §8.3): the discrete prolate
    spheroidal sequences are eigenvectors of a symmetric TRIDIAGONAL matrix
    commuting with the concentration operator — d[t] = ((M-1-2t)/2)²cos(2πW),
    e[t] = t(M-t)/2 — so no dense kernel is ever built for the tapers.
    Concentrations come from the autocorrelation identity
    λ_k = Σ_t r_xx[t]·(4W·sinc(2W·t)) (r[0] term 2W).  scipy.signal.windows
    .dpss sign conventions: symmetric tapers positive mean, antisymmetric
    tapers positive first lobe."""
    W = NW / M
    t = np.arange(M, dtype=np.float64)
    d = ((M - 1 - 2.0 * t) / 2.0) ** 2 * np.cos(2.0 * np.pi * W)
    e = t[1:] * (M - t[1:]) / 2.0
    try:
        # O(M·Kmax)-class tridiagonal solver with index selection — the
        # only tractable route at audio lengths (dense eigh is O(M³):
        # minutes at M ~ 20k, where this is milliseconds)
        from scipy.linalg import eigh_tridiagonal

        _, V = eigh_tridiagonal(d, e, select="i",
                                select_range=(M - Kmax, M - 1))
        tapers = V[:, ::-1].T.copy()  # (Kmax, M), best-concentrated first
    except ImportError:  # pragma: no cover - scipy is normally present
        A = np.zeros((M, M))
        A[np.arange(M), np.arange(M)] = d
        A[np.arange(M - 1), np.arange(1, M)] = e
        A[np.arange(1, M), np.arange(M - 1)] = e
        _, V = np.linalg.eigh(A)
        tapers = V[:, ::-1][:, :Kmax].T.copy()
    for k in range(0, Kmax, 2):  # symmetric: positive average
        if tapers[k].sum() < 0:
            tapers[k] *= -1.0
    thresh = max(1e-7, 1.0 / M)
    for k in range(1, Kmax, 2):  # antisymmetric: positive first lobe
        w = tapers[k]
        if w[w * w > thresh][0] < 0:
            tapers[k] *= -1.0
    # concentration ratios via the autocorrelation identity
    nfft = 2 ** int(np.ceil(np.log2(2 * M - 1)))
    spec = np.abs(np.fft.rfft(tapers, n=nfft, axis=-1)) ** 2
    rxx = np.fft.irfft(spec, n=nfft, axis=-1)[:, :M]
    r = 4.0 * W * np.sinc(2.0 * W * t)
    r[0] = 2.0 * W
    ratios = rxx @ r
    return tapers, ratios


def dpss(
    M: int, NW: float, Kmax: Optional[int] = None, *,
    return_ratios: bool = False, dtype=np.float32,
):
    """Discrete prolate spheroidal (Slepian) tapers — the maximally
    band-concentrated windows (scipy.signal.windows.dpss semantics with
    norm=2: orthonormal rows).  ``NW`` is the time-halfbandwidth product;
    ``Kmax`` defaults to the ~2NW-1 well-concentrated tapers.  Returns
    (Kmax, M) host array (+ concentration ratios when requested) — inputs
    to :func:`..signal.multitaper`."""
    if M < 2:
        raise ValueError(f"M must be >= 2, got {M}")
    if not 0.0 < NW < M / 2.0:
        raise ValueError(f"need 0 < NW < M/2, got NW={NW}, M={M}")
    if Kmax is None:
        Kmax = max(int(2 * NW) - 1, 1)
    if not 0 < Kmax <= M:
        raise ValueError(f"need 0 < Kmax <= M, got {Kmax}")
    tapers, ratios = _dpss_host(int(M), float(NW), int(Kmax))
    if return_ratios:
        return tapers.astype(dtype), ratios.astype(dtype)
    return tapers.astype(dtype)


def griffinlim(
    mag,
    n_iter: int = 32,
    nperseg: int = 256,
    noverlap: Optional[int] = None,
    window="hann",
    momentum: float = 0.99,
    *,
    center: bool = True,
    length: Optional[int] = None,
    seed: int = 0,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Griffin-Lim phase retrieval: reconstruct a real signal from an STFT
    MAGNITUDE (…, n_frames, nperseg//2+1) by alternating projections
    between the magnitude constraint and the set of consistent spectrograms
    (istft -> stft), with Perraudin-style momentum (librosa's accelerated
    default).  The whole iteration is one lax.fori_loop of engine
    rfft/irfft pairs — jittable end to end.

    Returns the time signal (length inferred from the frame count, or
    ``length``)."""
    mag = jnp.asarray(mag)
    if jnp.issubdtype(mag.dtype, jnp.complexfloating):
        raise ValueError("griffinlim takes a magnitude (real) spectrogram")
    if mag.ndim < 2 or mag.shape[-1] != nperseg // 2 + 1:
        raise ValueError(
            f"mag must be (…, n_frames, {nperseg // 2 + 1}) for "
            f"nperseg={nperseg}, got {mag.shape}"
        )
    if n_iter < 1:
        raise ValueError(f"n_iter must be >= 1, got {n_iter}")
    if not 0.0 <= momentum < 1.0:
        raise ValueError(f"momentum must be in [0, 1), got {momentum}")
    mag = mag.astype(config.dtype)
    if noverlap is None:
        noverlap = nperseg // 2
    hop = nperseg - noverlap
    n_frames = mag.shape[-2]
    t_padded = nperseg + (n_frames - 1) * hop
    max_len = t_padded - (nperseg if center else 0)
    if max_len < 1:
        raise ValueError(
            f"n_frames={n_frames} with nperseg={nperseg}, hop={hop}, "
            f"center={center} spans no samples — need more frames"
        )
    sig_len = max_len
    if length is not None:
        sig_len = int(length)
        if not 1 <= sig_len <= max_len:
            raise ValueError(
                f"length={sig_len} not reachable from {n_frames} frames "
                f"(max {max_len}); istft can only crop"
            )
        # the projection loop needs stft(istft(spec)) to return at least
        # n_frames frames, or the fori_loop carry changes shape
        t_eff = sig_len + (2 * (nperseg // 2) if center else 0)
        sig_len_frames = 1 + -(-max(t_eff - nperseg, 0) // hop)
        if sig_len_frames < n_frames:
            raise ValueError(
                f"length={sig_len} yields only {sig_len_frames} frames, mag "
                f"has {n_frames} — raise length or pass fewer frames"
            )

    def project(spec):
        """Magnitude-consistent projection: istft then stft."""
        x = istft(
            spec, nperseg, noverlap, window, center=center, length=sig_len,
            config=config,
        )
        return stft(
            x, nperseg, noverlap, window, center=center, config=config
        )[..., :n_frames, :]

    # random initial phase (angle-uniform), deterministic by seed
    key = jax.random.PRNGKey(seed)
    ph = jax.random.uniform(
        key, mag.shape, mag.dtype, 0.0, 2.0 * float(np.pi)
    )
    spec0 = jax.lax.complex(mag * jnp.cos(ph), mag * jnp.sin(ph))

    def rephase(c):
        a = jnp.sqrt(jnp.real(c) ** 2 + jnp.imag(c) ** 2)
        safe = jnp.maximum(a, jnp.asarray(1e-16, mag.dtype))
        return jax.lax.complex(mag * jnp.real(c) / safe,
                               mag * jnp.imag(c) / safe)

    mom = jnp.asarray(momentum, mag.dtype)

    def body(_, carry):
        spec, prev = carry
        est = project(spec)
        accel = est + mom * (est - prev)
        return rephase(accel), est

    spec, _ = jax.lax.fori_loop(0, n_iter, body, (spec0, spec0))
    return istft(
        spec, nperseg, noverlap, window, center=center, length=sig_len,
        config=config,
    )


def phase_vocoder(
    S,
    rate: float,
    hop: Optional[int] = None,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Phase-vocoder time stretch of a complex STFT (…, frames, bins) by
    ``rate`` (>1 speeds up) — librosa.phase_vocoder (Flanagan-Golden with
    phase accumulation).

    Device shape: the fractional read positions are HOST constants (rate and
    the frame count are static), so the two source frames per output step
    are one static gather; the only sequential part — phase accumulation —
    is a lax.scan over output frames of pure elementwise work."""
    S = jnp.asarray(S)
    if not jnp.issubdtype(S.dtype, jnp.complexfloating):
        raise ValueError("phase_vocoder takes a complex STFT")
    if S.ndim < 2:
        raise ValueError("S must be (…, frames, bins)")
    if rate <= 0:
        raise ValueError(f"rate must be > 0, got {rate}")
    n_frames, nb = S.shape[-2], S.shape[-1]
    nfft = 2 * (nb - 1)
    hop = nfft // 4 if hop is None else int(hop)
    steps = np.arange(0, n_frames, rate)  # host fp64
    lo = np.minimum(steps.astype(np.int64), n_frames - 1)
    hi = np.minimum(lo + 1, n_frames - 1)
    frac = jnp.asarray(steps - lo, jnp.real(S).dtype)[:, None]
    S0 = S[..., lo, :]
    S1 = S[..., hi, :]
    phi_adv = jnp.asarray(
        np.linspace(0, np.pi * hop, nb), jnp.real(S).dtype
    )
    eps = jnp.asarray(1e-30, jnp.real(S).dtype)
    mag = (1.0 - frac) * jnp.abs(S0) + frac * jnp.abs(S1)
    ang0 = jnp.angle(S0 + eps)
    dphi = jnp.angle(S1 + eps) - ang0 - phi_adv
    dphi = dphi - 2.0 * np.pi * jnp.round(dphi / (2.0 * np.pi))
    inc = jnp.moveaxis(phi_adv + dphi, -2, 0)  # (steps, …, bins)
    mag_steps = jnp.moveaxis(mag, -2, 0)
    init = jnp.angle(S[..., 0, :] + eps)

    def step(phase, xs):
        inc_m, mag_m = xs
        out = mag_m * jax.lax.complex(jnp.cos(phase), jnp.sin(phase))
        return phase + inc_m, out

    _, outs = jax.lax.scan(step, init, (inc, mag_steps))
    return jnp.moveaxis(outs, 0, -2)


def time_stretch(
    x,
    rate: float,
    nperseg: int = 2048,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Time-stretch a real signal by ``rate`` without changing pitch
    (librosa.effects.time_stretch): stft -> :func:`phase_vocoder` ->
    istft at length round(T/rate)."""
    x = jnp.asarray(x)
    if jnp.issubdtype(x.dtype, jnp.complexfloating):
        raise ValueError("time_stretch takes real signals")
    if rate <= 0:
        raise ValueError(f"rate must be > 0, got {rate}")
    hop = nperseg // 4
    S = stft(x, nperseg, nperseg - hop, "hann", center=True, config=config)
    S2 = phase_vocoder(S, rate, hop, config=config)
    n_out = int(round(x.shape[-1] / rate))
    return istft(
        S2, nperseg, nperseg - hop, "hann", center=True, length=n_out,
        config=config,
    )


def pitch_shift(
    x,
    sr: float,
    n_steps: float,
    bins_per_octave: int = 12,
    nperseg: int = 2048,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Pitch-shift a real signal by ``n_steps`` (fractional allowed) in
    ``bins_per_octave``-TET without changing duration
    (librosa.effects.pitch_shift): time-stretch by 2^{-steps/bpo}, then
    resample back to the original length with the polyphase resampler."""
    from fractions import Fraction

    from .signal import resample_poly

    x = jnp.asarray(x)
    if bins_per_octave < 1:
        raise ValueError(f"bins_per_octave must be >= 1, got {bins_per_octave}")
    rate = 2.0 ** (-float(n_steps) / bins_per_octave)
    y = time_stretch(x, rate, nperseg, config=config)
    frac = Fraction(rate).limit_denominator(1000)
    z = resample_poly(y, frac.numerator, frac.denominator, config=config)
    n = x.shape[-1]
    z = z[..., :n]
    if z.shape[-1] < n:
        padw = [(0, 0)] * (z.ndim - 1) + [(0, n - z.shape[-1])]
        z = jnp.pad(z, padw)
    return z
