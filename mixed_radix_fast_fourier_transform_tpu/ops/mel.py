"""Mel-scale audio features: filterbank, mel spectrogram, MFCC.

The standard speech/audio front end, built on the engine's STFT and DCT:
a host-generated (n_mels, n_fft//2+1) triangular filterbank applied as one
matmul over the power spectrogram, then a log and a type-II DCT for
cepstral coefficients.  Conventions follow librosa's defaults (Slaney-style
mel scale and filter normalization, HTK formula available) so feature
pipelines port directly; the filterbank is an lru-cached host constant
like the other kernel builders (DPSS, CQT, Wigner-d).

Capability extension: the reference has no time-frequency analysis
(src/ is the C FFT engine and convolve.c alone).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.config import DEFAULT_CONFIG, SpectralConfig
from .dct import dct as _dct
from .stft import stft as _stft

Array = jax.Array


def hz_to_mel(f, htk: bool = False) -> np.ndarray:
    """Hz -> mel.  Slaney (librosa default): linear below 1 kHz, log above;
    ``htk=True``: 2595·log10(1 + f/700)."""
    f = np.asarray(f, np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    logstep = np.log(6.4) / 27.0
    mel = f / f_sp
    above = f >= min_log_hz
    return np.where(
        above,
        min_log_hz / f_sp + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
        mel,
    )


def mel_to_hz(m, htk: bool = False) -> np.ndarray:
    """Inverse of :func:`hz_to_mel`."""
    m = np.asarray(m, np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    above = m >= min_log_mel
    return np.where(above, min_log_hz * np.exp(logstep * (m - min_log_mel)),
                    f_sp * m)


def mel_frequencies(
    n_mels: int, fmin: float = 0.0, fmax: float = 11025.0, htk: bool = False
) -> np.ndarray:
    """``n_mels`` frequencies evenly spaced on the mel scale in [fmin, fmax]."""
    if n_mels < 1:
        raise ValueError(f"n_mels must be >= 1, got {n_mels}")
    mels = np.linspace(hz_to_mel(fmin, htk), hz_to_mel(fmax, htk), n_mels)
    return mel_to_hz(mels, htk)


@functools.lru_cache(maxsize=16)
def _mel_filterbank_cached(
    sr: float, n_fft: int, n_mels: int, fmin: float, fmax: float,
    htk: bool, norm,
):
    freqs = np.fft.rfftfreq(n_fft, 1.0 / sr)  # (n_fft//2 + 1,)
    edges = mel_frequencies(n_mels + 2, fmin, fmax, htk)  # band edges
    fb = np.zeros((n_mels, freqs.size))
    for i in range(n_mels):
        lo, ctr, hi = edges[i], edges[i + 1], edges[i + 2]
        up = (freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - freqs) / max(hi - ctr, 1e-10)
        fb[i] = np.maximum(0.0, np.minimum(up, down))
    if norm == "slaney":
        # equal-area normalization: each filter integrates to ~1
        enorm = 2.0 / (edges[2:] - edges[:-2])
        fb *= enorm[:, None]
    elif norm is not None:
        raise ValueError(f"norm must be 'slaney' or None, got {norm!r}")
    return fb


def mel_filterbank(
    sr: float,
    n_fft: int,
    n_mels: int = 128,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    htk: bool = False,
    norm="slaney",
    dtype=np.float32,
) -> np.ndarray:
    """Triangular mel filterbank (n_mels, n_fft//2 + 1) — librosa
    ``filters.mel`` conventions (Slaney scale + equal-area norm by
    default)."""
    if n_fft < 2:
        raise ValueError(f"n_fft must be >= 2, got {n_fft}")
    if n_mels < 1:
        raise ValueError(f"n_mels must be >= 1, got {n_mels}")
    fmax = sr / 2.0 if fmax is None else float(fmax)
    if not 0.0 <= fmin < fmax:
        raise ValueError(f"need 0 <= fmin < fmax, got {fmin}, {fmax}")
    if fmax > sr / 2.0:
        raise ValueError(
            f"fmax={fmax} exceeds Nyquist ({sr / 2.0}): bands above Nyquist "
            "would be silently empty"
        )
    fb = _mel_filterbank_cached(
        float(sr), int(n_fft), int(n_mels), float(fmin), fmax, bool(htk), norm
    )
    return fb.astype(dtype)


def melspectrogram(
    x,
    sr: float = 22050.0,
    n_fft: int = 2048,
    hop: Optional[int] = None,
    window="hann",
    n_mels: int = 128,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    power: float = 2.0,
    htk: bool = False,
    norm="slaney",
    center: bool = True,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Mel-scaled spectrogram: (…, T) -> (…, n_frames, n_mels).

    |STFT|^power contracted against the mel filterbank — one batched frame
    rfft (the engine) plus one (bins, n_mels) matmul."""
    x = jnp.asarray(x)
    if jnp.issubdtype(x.dtype, jnp.complexfloating):
        raise ValueError("melspectrogram expects a real signal")
    hop = n_fft // 4 if hop is None else int(hop)
    if hop < 1:
        raise ValueError(f"hop must be >= 1, got {hop}")
    spec = _stft(
        x, nperseg=n_fft, noverlap=n_fft - hop, window=window, center=center,
        config=config,
    )  # (…, frames, bins)
    p = jnp.real(spec) ** 2 + jnp.imag(spec) ** 2
    if power != 2.0:
        p = jnp.power(jnp.maximum(p, 0.0), power / 2.0)
    fb = mel_filterbank(sr, n_fft, n_mels, fmin, fmax, htk, norm)
    return jnp.einsum(
        "...tb,mb->...tm", p, jnp.asarray(fb, p.dtype),
        precision=config.op_precision,
    )


def mfcc(
    x,
    sr: float = 22050.0,
    n_mfcc: int = 20,
    n_fft: int = 2048,
    hop: Optional[int] = None,
    n_mels: int = 128,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    top_db: float = 80.0,
    lifter: float = 0.0,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Mel-frequency cepstral coefficients: (…, T) -> (…, frames, n_mfcc).

    log-power mel spectrogram (dB, floored ``top_db`` below the per-signal
    peak like librosa's power_to_db) followed by an orthonormal type-II DCT
    over the mel axis.  ``lifter`` > 0 applies librosa's sinusoidal
    cepstral liftering 1 + (L/2)·sin(π(k+1)/L)."""
    if n_mfcc < 1:
        raise ValueError(f"n_mfcc must be >= 1, got {n_mfcc}")
    if n_mfcc > n_mels:
        raise ValueError(f"n_mfcc={n_mfcc} > n_mels={n_mels}")
    if lifter < 0:
        raise ValueError(f"lifter must be >= 0, got {lifter}")
    m = melspectrogram(
        x, sr, n_fft, hop, n_mels=n_mels, fmin=fmin, fmax=fmax, config=config
    )
    amin = jnp.asarray(1e-10, m.dtype)
    db = 10.0 * jnp.log10(jnp.maximum(m, amin))
    if top_db is not None:
        peak = jnp.max(db, axis=(-2, -1), keepdims=True)
        db = jnp.maximum(db, peak - top_db)
    C = _dct(db, type=2, norm="ortho", config=config)[..., :n_mfcc]
    if lifter > 0:
        lif = 1.0 + (lifter / 2.0) * np.sin(
            np.pi * np.arange(1, n_mfcc + 1) / lifter
        )
        C = C * jnp.asarray(lif, C.dtype)
    return C


def mfcc_to_mel(
    C,
    n_mels: int = 128,
    lifter: float = 0.0,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Invert MFCCs to a mel POWER spectrogram
    (librosa.feature.inverse.mfcc_to_mel): unlifter, zero-pad the cepstrum
    to ``n_mels``, inverse orthonormal DCT-II, and undo the dB scaling.
    Exact when n_mfcc == n_mels and no floor was hit; a smoothed (cepstral
    low-pass) estimate otherwise."""
    from .dct import idct as _idct

    C = jnp.asarray(C)
    if C.ndim < 2:
        raise ValueError("C must be (…, frames, n_mfcc)")
    n_mfcc = C.shape[-1]
    if n_mfcc > n_mels:
        raise ValueError(f"n_mfcc={n_mfcc} > n_mels={n_mels}")
    if lifter < 0:
        raise ValueError(f"lifter must be >= 0, got {lifter}")
    if lifter > 0:
        lif = 1.0 + (lifter / 2.0) * np.sin(
            np.pi * np.arange(1, n_mfcc + 1) / lifter
        )
        # librosa adds tiny() so an exactly-zero lifter entry (which zeroed
        # the forward coefficient) inverts to 0 instead of NaN
        C = C / jnp.asarray(lif + np.sign(lif + 1e-300) * 1e-30, C.dtype)
    pad = [(0, 0)] * (C.ndim - 1) + [(0, n_mels - n_mfcc)]
    full = jnp.pad(C, pad)
    db = _idct(full, type=2, norm="ortho", config=config)
    return jnp.power(10.0, db / 10.0)


def mfcc_to_audio(
    C,
    sr: float = 22050.0,
    n_fft: int = 2048,
    hop: Optional[int] = None,
    n_mels: int = 128,
    n_iter_nnls: int = 32,
    n_iter_gl: int = 32,
    lifter: float = 0.0,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    length: Optional[int] = None,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """MFCCs all the way back to a waveform: :func:`mfcc_to_mel` ->
    :func:`mel_to_audio` (NNLS + Griffin-Lim) — librosa
    feature.inverse.mfcc_to_audio, one jittable pipeline.  Pass the SAME
    ``fmin``/``fmax`` used at :func:`mfcc` time so the NNLS inverts the
    matching filterbank."""
    M = mfcc_to_mel(C, n_mels=n_mels, lifter=lifter, config=config)
    return mel_to_audio(
        M, sr, n_fft, hop, n_iter_nnls=n_iter_nnls, n_iter_gl=n_iter_gl,
        fmin=fmin, fmax=fmax, length=length, config=config,
    )


def mel_to_stft(
    M,
    sr: float = 22050.0,
    n_fft: int = 2048,
    power: float = 2.0,
    n_iter: int = 32,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    htk: bool = False,
    norm="slaney",
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Approximate-invert a mel spectrogram to STFT MAGNITUDES:
    (…, frames, n_mels) -> (…, frames, n_fft//2+1) — librosa
    ``feature.inverse.mel_to_stft`` semantics (its NNLS step).

    NNLS per frame; device shape: initialize at the clipped pseudo-inverse
    solution (one host pinv of the small (n_mels, bins) filterbank, one
    matmul) and refine with ``n_iter`` projected-gradient steps at the
    exact Lipschitz rate 1/||F Fᵀ||₂ — a lax.fori_loop of two matmuls per
    step, jittable end to end."""
    M = jnp.asarray(M)
    if jnp.issubdtype(M.dtype, jnp.complexfloating):
        raise ValueError("mel_to_stft takes a real mel spectrogram")
    if M.ndim < 2:
        raise ValueError("M must be (…, frames, n_mels)")
    if n_iter < 0:
        raise ValueError(f"n_iter must be >= 0, got {n_iter}")
    n_mels = M.shape[-1]
    fb = mel_filterbank(
        sr, n_fft, n_mels, fmin, fmax, htk, norm, dtype=np.float64
    )  # (n_mels, bins)
    pinv = np.linalg.pinv(fb)  # (bins, n_mels)
    lam = 1.0 / max(float(np.linalg.norm(fb @ fb.T, 2)), 1e-12)
    rdtype = M.dtype
    fbd = jnp.asarray(fb, rdtype)
    prec = config.op_precision
    s0 = jnp.maximum(
        jnp.einsum("...tm,bm->...tb", M, jnp.asarray(pinv, rdtype),
                   precision=prec),
        0.0,
    )

    def step(_, s):
        resid = jnp.einsum("...tb,mb->...tm", s, fbd, precision=prec) - M
        grad = jnp.einsum("...tm,mb->...tb", resid, fbd, precision=prec)
        return jnp.maximum(s - lam * grad, 0.0)

    s = jax.lax.fori_loop(0, n_iter, step, s0) if n_iter else s0
    # mel power -> linear magnitude
    return jnp.power(jnp.maximum(s, 0.0), 1.0 / power)


def mel_to_audio(
    M,
    sr: float = 22050.0,
    n_fft: int = 2048,
    hop: Optional[int] = None,
    window="hann",
    power: float = 2.0,
    n_iter_nnls: int = 32,
    n_iter_gl: int = 32,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    length: Optional[int] = None,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Invert a mel spectrogram to a waveform: NNLS filterbank inversion
    (:func:`mel_to_stft`) followed by Griffin-Lim phase retrieval —
    librosa ``feature.inverse.mel_to_audio`` semantics, one jittable
    pipeline of engine rfft/irfft rounds."""
    from .stft import griffinlim as _griffinlim

    hop = n_fft // 4 if hop is None else int(hop)
    mag = mel_to_stft(
        M, sr, n_fft, power, n_iter_nnls, fmin, fmax, config=config
    )
    return _griffinlim(
        mag, n_iter=n_iter_gl, nperseg=n_fft, noverlap=n_fft - hop,
        window=window, length=length, config=config,
    )


def _median_filter_axis(x: Array, size: int, axis: int) -> Array:
    """Sliding median along ``axis`` (reflect edges) — static window
    gather + one jnp.median over the window axis; no loops."""
    n = x.shape[axis]
    half = size // 2
    idx = np.arange(n)[:, None] + np.arange(size)[None, :] - half
    idx = np.abs(idx)  # reflect at 0
    idx = np.where(idx >= n, 2 * (n - 1) - idx, idx)  # reflect at n-1
    xm = jnp.moveaxis(x, axis, -1)
    win = xm[..., idx]  # (…, n, size)
    med = jnp.median(win, axis=-1)
    return jnp.moveaxis(med, -1, axis)


def _softmask(x: Array, ref: Array, power: float) -> Array:
    """librosa.util.softmask: x^p / (x^p + ref^p), scale-invariant and
    zero-safe; power=inf gives the hard mask x > ref."""
    if np.isinf(power):
        return (x > ref).astype(x.dtype)
    z = jnp.maximum(jnp.maximum(x, ref), jnp.asarray(1e-30, x.dtype))
    xp = (x / z) ** power
    rp = (ref / z) ** power
    return xp / (xp + rp)


def hpss(
    S,
    kernel_size=31,
    power: float = 2.0,
    margin=1.0,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
):
    """Harmonic-percussive source separation on a spectrogram
    (…, frames, bins) — librosa.decompose.hpss (Fitzgerald 2010 /
    Driedger 2014 margins): harmonic enhancement is a median filter
    ALONG TIME, percussive along FREQUENCY; soft Wiener-style masks of
    exponent ``power`` (inf = hard) recombine the input.

    ``kernel_size`` and ``margin`` take scalars or (harmonic,
    percussive) pairs.  Returns ``(S_harmonic, S_percussive)`` with the
    dtype of ``S`` (complex in, complex out — run istft after to get the
    separated signals).  Device shape: two static window gathers +
    jnp.median reductions and elementwise masks; no data-dependent
    control flow."""
    S = jnp.asarray(S)
    if S.ndim < 2:
        raise ValueError("S must be (…, frames, bins)")
    kh, kp = (kernel_size if np.ndim(kernel_size) else (kernel_size,) * 2)
    mh, mp = (margin if np.ndim(margin) else (margin,) * 2)
    if kh < 1 or kp < 1 or kh % 2 == 0 or kp % 2 == 0:
        raise ValueError("kernel sizes must be odd and >= 1")
    if mh < 1.0 or mp < 1.0:
        raise ValueError("margins must be >= 1")
    if min(S.shape[-2], S.shape[-1]) < 2:
        raise ValueError("spectrogram too small to separate")
    mag = jnp.abs(S) if jnp.issubdtype(S.dtype, jnp.complexfloating) else S
    harm = _median_filter_axis(mag, min(kh, 2 * S.shape[-2] - 1), -2)
    perc = _median_filter_axis(mag, min(kp, 2 * S.shape[-1] - 1), -1)
    mask_h = _softmask(harm, perc * jnp.asarray(mh, harm.dtype), power)
    mask_p = _softmask(perc, harm * jnp.asarray(mp, perc.dtype), power)
    return S * mask_h.astype(jnp.real(S).dtype), S * mask_p.astype(
        jnp.real(S).dtype
    )


def _yin_cmnd(x, fmin, fmax, sr, frame_length, win_length, hop, center,
              config):
    """Cumulative-mean-normalized difference frames shared by yin/pyin:
    (…, T) -> (cmnd (…, F, tau_max+1), tau_min, tau_max)."""
    from .stft import _frame
    from .rfft import rfft as _rfft, irfft as _irfft

    x = jnp.asarray(x)
    if jnp.issubdtype(x.dtype, jnp.complexfloating):
        raise ValueError("pitch estimators take real signals")
    if not 0 < fmin < fmax <= sr / 2:
        raise ValueError(f"need 0 < fmin < fmax <= sr/2, got {fmin}, {fmax}")
    win_length = frame_length // 2 if win_length is None else int(win_length)
    hop = frame_length // 4 if hop is None else int(hop)
    if not 0 < win_length < frame_length:
        raise ValueError("need 0 < win_length < frame_length")
    if hop < 1:
        raise ValueError(f"hop must be >= 1, got {hop}")
    tau_max = min(frame_length - win_length, int(np.ceil(sr / fmin)))
    tau_min = max(1, int(np.floor(sr / fmax)))
    if tau_min + 2 > tau_max:
        raise ValueError(
            f"frequency range [{fmin}, {fmax}] needs lags in "
            f"[{tau_min}, {tau_max}] — enlarge frame_length or the range"
        )
    xw = x.astype(config.dtype)
    if center:
        pad = [(0, 0)] * (x.ndim - 1) + [(frame_length // 2,) * 2]
        xw = jnp.pad(xw, pad, mode="constant")
    frames = _frame(xw, frame_length, hop)  # (…, F, frame_length)
    W = win_length
    # d(τ) = e0 + e(τ) − 2c(τ): sliding energy + one FFT correlation
    sq = frames * frames
    csum = jnp.cumsum(sq, axis=-1)
    zero = jnp.zeros_like(csum[..., :1])
    csum = jnp.concatenate([zero, csum], axis=-1)  # (…, F, fl+1)
    taus = np.arange(tau_max + 1)
    e0 = csum[..., W] - csum[..., 0]
    e_tau = csum[..., taus + W] - csum[..., taus]
    nfft = int(2 ** np.ceil(np.log2(frame_length + W)))
    head = frames[..., :W]
    pad_head = jnp.concatenate(
        [head, jnp.zeros(frames.shape[:-1] + (nfft - W,), frames.dtype)], -1
    )
    pad_full = jnp.concatenate(
        [frames, jnp.zeros(frames.shape[:-1] + (nfft - frame_length,),
                           frames.dtype)], -1
    )
    spec = _rfft(pad_full, config=config) * jnp.conj(
        _rfft(pad_head, config=config)
    )
    corr = _irfft(spec, n=nfft, config=config)[..., : tau_max + 1]
    d = e0[..., None] + e_tau - 2.0 * corr  # (…, F, tau_max+1)
    # cumulative mean normalized difference
    tau_f = jnp.asarray(taus, d.dtype)
    run = jnp.cumsum(d[..., 1:], axis=-1)
    cmnd = jnp.concatenate(
        [jnp.ones_like(d[..., :1]),
         d[..., 1:] * tau_f[1:] / jnp.maximum(run, 1e-12)], -1
    )
    return cmnd, tau_min, tau_max, e0


def _cmnd_troughs(cmnd, tau_min: int, tau_max: int):
    """Shared yin/pyin trough detection: (lo, trough_mask, in_band) over
    the interior lag axis 1..tau_max-1."""
    lo = cmnd[..., 1:-1]
    is_trough = (lo <= cmnd[..., :-2]) & (lo <= cmnd[..., 2:])
    lag_idx = np.arange(1, cmnd.shape[-1] - 1)
    in_band = jnp.asarray((lag_idx >= tau_min) & (lag_idx <= tau_max - 1))
    return lo, is_trough & in_band, in_band


def _parabolic_lag(cmnd, pick):
    """Sub-sample lag: parabolic minimum of cmnd around integer ``pick``."""
    p0 = jnp.take_along_axis(cmnd, pick[..., None] - 1, axis=-1)[..., 0]
    p1 = jnp.take_along_axis(cmnd, pick[..., None], axis=-1)[..., 0]
    p2 = jnp.take_along_axis(cmnd, pick[..., None] + 1, axis=-1)[..., 0]
    denom = p0 + p2 - 2.0 * p1
    shift = jnp.where(jnp.abs(denom) > 1e-12, 0.5 * (p0 - p2) / denom, 0.0)
    return pick.astype(cmnd.dtype) + jnp.clip(shift, -0.5, 0.5)


def yin(
    x,
    fmin: float,
    fmax: float,
    sr: float = 22050.0,
    frame_length: int = 2048,
    win_length: Optional[int] = None,
    hop: Optional[int] = None,
    trough_threshold: float = 0.1,
    center: bool = True,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """YIN fundamental-frequency estimation (de Cheveigné & Kawahara
    2002; librosa.yin conventions): (…, T) -> f0 in Hz per frame
    (…, n_frames), frame m centered on sample m·hop.

    Device shape: the difference function d(τ) = Σ_j (x_j − x_{j+τ})²
    evaluates per frame as sliding energies (one cumsum) plus a cross
    term computed with ONE batched engine rfft/irfft correlation — no
    lag loop; the cumulative-mean normalization is a cumsum; the
    "first trough under threshold, else global minimum" pick and the
    parabolic refinement are argmax/gather compositions, so the whole
    estimator jits with no data-dependent control flow."""
    cmnd, tau_min, tau_max, _ = _yin_cmnd(
        x, fmin, fmax, sr, frame_length, win_length, hop, center, config
    )
    lo, trough, in_band = _cmnd_troughs(cmnd, tau_min, tau_max)
    below = trough & (lo < trough_threshold)
    # first below-threshold trough (argmax finds the first True), else the
    # global in-band minimum of the normalized difference
    any_below = jnp.any(below, axis=-1)
    first = jnp.argmax(below, axis=-1)
    masked = jnp.where(in_band, lo, jnp.inf)
    fallback = jnp.argmin(masked, axis=-1)
    pick = jnp.where(any_below, first, fallback) + 1  # back to lag units
    tau_hat = _parabolic_lag(cmnd, pick)
    return jnp.asarray(sr, cmnd.dtype) / tau_hat


def pyin(
    x,
    fmin: float,
    fmax: float,
    sr: float = 22050.0,
    frame_length: int = 2048,
    win_length: Optional[int] = None,
    hop: Optional[int] = None,
    resolution: float = 0.1,
    switch_prob: float = 0.01,
    max_semitones_per_frame: float = 12.0,
    center: bool = True,
    fill_unvoiced: float = np.nan,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
):
    """Probabilistic YIN (Mauch & Dixon 2014 style): (…, T) ->
    ``(f0, voiced_flag, voiced_prob)``, each (…, n_frames); unvoiced
    frames carry ``fill_unvoiced`` in f0.

    Per frame, EVERY trough of the cumulative-mean-normalized difference
    becomes a pitch candidate weighted by the Beta(2, 18) threshold prior
    of the original pYIN (P[threshold > depth] has the closed form
    (1−d)¹⁹ + 19·d·(1−d)¹⁸ — no incomplete-beta calls); candidates spread
    onto a log-pitch grid of ``resolution`` semitones through a STATIC
    lag→bin one-hot matmul.  A single-unvoiced-state HMM (triangular
    pitch transitions capped at ``max_semitones_per_frame``,
    ``switch_prob`` voicing switches) is decoded by max-product Viterbi —
    one lax.scan forward with int32 backpointers and one reverse scan, so
    the whole tracker jits.  Simplification vs librosa.pyin: one unvoiced
    state instead of per-pitch unvoiced states (pitch memory resets
    across unvoiced gaps)."""
    cmnd, tau_min, tau_max, e0 = _yin_cmnd(
        x, fmin, fmax, sr, frame_length, win_length, hop, center, config
    )
    if not 0.0 < switch_prob < 1.0:
        raise ValueError(f"switch_prob must be in (0, 1), got {switch_prob}")
    if resolution <= 0:
        raise ValueError(f"resolution must be > 0, got {resolution}")
    rdt = cmnd.dtype
    lo, trough, _ = _cmnd_troughs(cmnd, tau_min, tau_max)
    lag_idx = np.arange(1, tau_max)
    d = jnp.clip(lo, 0.0, 1.0)
    # P[Beta(2,18) threshold > depth] = (1-d)^19 + 19 d (1-d)^18
    w = jnp.where(
        trough, (1.0 - d) ** 19 + 19.0 * d * (1.0 - d) ** 18, 0.0
    )  # (…, F, tau_max-1)
    # pYIN's Boltzmann prior over trough RANK (parameter 2): earlier
    # (shorter-lag) troughs dominate by e² per rank — this both suppresses
    # octave-below errors and outweighs the +log2/frame self-transition
    # bonus the truncated triangular HMM kernel gives the edge pitch bins
    rank = jnp.cumsum(trough.astype(rdt), axis=-1) - trough.astype(rdt)
    w = w * jnp.exp(-2.0 * rank)
    # silence gate: zero-energy frames carry no pitch evidence (the CMND
    # of an all-zero frame is 0/0 -> 0, which would read as deep troughs)
    emax = jnp.max(e0, axis=-1, keepdims=True)
    live = e0 > 1e-10 * jnp.maximum(emax, 1e-30)
    w = w * live[..., None].astype(rdt)
    total = jnp.sum(w, -1)
    # frame voicing = min(total, 1); candidates split that mass in
    # proportion to w (normalize by total ALWAYS — normalizing only when
    # total > 1 would square the voicing probability into the voiced
    # observations and bias the decoder unvoiced on moderate evidence)
    p_voiced = jnp.minimum(total, 1.0)
    cand = w / jnp.maximum(total, 1e-12)[..., None]
    # static lag -> log-pitch-bin map
    n_bins = int(np.ceil(12.0 * np.log2(fmax / fmin) / resolution)) + 1
    bin_f = fmin * 2.0 ** (resolution * np.arange(n_bins) / 12.0)
    lag_f = sr / lag_idx.astype(np.float64)
    bin_of = np.clip(np.round(
        12.0 * np.log2(np.maximum(lag_f, 1e-10) / fmin) / resolution
    ), 0, n_bins - 1).astype(np.int64)
    onehot = jnp.asarray(
        bin_of[:, None] == np.arange(n_bins)[None, :], rdt
    )  # (lags, bins)
    obs_v = jnp.einsum("...fl,lb->...fb", cand, onehot,
                       precision=config.op_precision)
    obs_v = obs_v * p_voiced[..., None]
    obs_u = (1.0 - p_voiced)[..., None]
    eps = jnp.asarray(1e-12, rdt)
    obs = jnp.log(jnp.concatenate([obs_v, obs_u], -1) + eps)  # (…,F,S)
    # transition matrix (host): triangular pitch window + voicing switch
    width = max(int(round(max_semitones_per_frame / resolution)), 1)
    db = np.abs(np.arange(n_bins)[:, None] - np.arange(n_bins)[None, :])
    tri = np.maximum(1.0 - db / (width + 1.0), 0.0)
    tri /= np.maximum(tri.sum(1, keepdims=True), 1e-30)
    T = np.zeros((n_bins + 1, n_bins + 1))
    T[:n_bins, :n_bins] = (1.0 - switch_prob) * tri
    T[:n_bins, n_bins] = switch_prob
    T[n_bins, :n_bins] = switch_prob / n_bins
    T[n_bins, n_bins] = 1.0 - switch_prob
    logT = jnp.asarray(np.log(T + 1e-30), rdt)  # (S, S)

    # Viterbi: forward max-product with backpointers, then backtrace
    obs_steps = jnp.moveaxis(obs, -2, 0)  # (F, …, S)

    def fwd(v, ob):
        scores = v[..., :, None] + logT  # (…, S_prev, S)
        best = jnp.max(scores, axis=-2)
        arg = jnp.argmax(scores, axis=-2).astype(jnp.int32)
        return best + ob, arg

    v0 = obs_steps[0]
    vT, bps = jax.lax.scan(fwd, v0, obs_steps[1:])
    last = jnp.argmax(vT, axis=-1).astype(jnp.int32)

    def back(state, bp):
        # bp[t] maps state_{t+1} -> state_t; emit state_{t+1}, carry state_t
        prev = jnp.take_along_axis(bp, state[..., None], axis=-1)[..., 0]
        return prev, state

    s0, path_rev = jax.lax.scan(back, last, bps, reverse=True)
    path = jnp.concatenate(
        [s0[..., None], jnp.moveaxis(path_rev, 0, -1)], -1
    )  # (…, F) states 0..F-1
    voiced = path < n_bins
    bsel = jnp.minimum(path, n_bins - 1)
    # refine the decoded bin to sub-sample pitch: among the troughs that
    # map to the selected bin, take the strongest and interpolate the
    # CMND parabolically (yin's refinement) — near fmax adjacent integer
    # lags are several bin-widths apart, so the bin center alone would be
    # far coarser than `resolution` promises
    colsel = jnp.moveaxis(jnp.take(onehot, bsel, axis=1), 0, -1)  # (…,F,l)
    wsel = w * colsel
    has_lag = jnp.any(wsel > 0, axis=-1)
    pick = jnp.argmax(wsel, axis=-1) + 1  # lag units
    tau_hat = _parabolic_lag(cmnd, pick)
    f0_fine = jnp.asarray(sr, rdt) / tau_hat
    f0_bin = jnp.asarray(bin_f, rdt)[bsel]
    f0 = jnp.where(has_lag, f0_fine, f0_bin)
    f0 = jnp.where(voiced, f0, jnp.asarray(fill_unvoiced, rdt))
    return f0, voiced, p_voiced


def pcen(
    S,
    sr: float = 22050.0,
    hop: int = 512,
    gain=0.98,
    bias=2.0,
    power=0.5,
    time_constant: float = 0.4,
    eps: float = 1e-6,
    b=None,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Per-channel energy normalization (Wang et al. 2017;
    librosa.pcen defaults): (…, frames, bands) -> same shape,

        PCEN = (S / (eps + M)^gain + bias)^power − bias^power,

    with M the per-band IIR-smoothed energy (one-pole, coefficient ``b``
    from ``time_constant`` seconds at the given frame rate, or passed
    directly) — the learnable-frontend alternative to log-mel.  The
    smoother is one lax.scan over frames of pure elementwise work;
    everything else fuses.  ``gain``/``bias``/``power``/``b`` accept
    scalars OR per-band (traced) arrays, so the trainable frontend
    (models/audio_frontend) calls this same kernel with learned
    coefficients."""
    S = jnp.asarray(S)
    if S.ndim < 2:
        raise ValueError("S must be (…, frames, bands)")
    if jnp.issubdtype(S.dtype, jnp.complexfloating):
        raise ValueError("pcen takes a magnitude/power spectrogram")
    if b is None:
        if time_constant <= 0 or hop < 1:
            raise ValueError("need time_constant > 0 and hop >= 1")
        t_frames = time_constant * sr / float(hop)
        # librosa: b from the equivalent-width of the one-pole smoother
        b = (np.sqrt(1.0 + 4.0 * t_frames**2) - 1.0) / (2.0 * t_frames**2)
    bd = jnp.asarray(b, S.dtype)
    steps = jnp.moveaxis(S, -2, 0)

    def smooth(m, s):
        m2 = (1.0 - bd) * m + bd * s
        return m2, m2

    _, M = jax.lax.scan(smooth, steps[0], steps)
    M = jnp.moveaxis(M, 0, -2)
    epsd = jnp.asarray(eps, S.dtype)
    smooth_gain = jnp.exp(-jnp.asarray(gain, S.dtype) * jnp.log(epsd + M))
    biasd = jnp.asarray(bias, S.dtype)
    powerd = jnp.asarray(power, S.dtype)
    return (S * smooth_gain + biasd) ** powerd - biasd**powerd


def A_weighting(frequencies) -> np.ndarray:
    """IEC 61672 A-weighting in dB at the given frequencies (host fp64,
    librosa.A_weighting conventions — 0 dB at 1 kHz)."""
    f = np.atleast_1d(np.asarray(frequencies, np.float64))
    f2 = np.maximum(f, 1e-10) ** 2
    c1, c2, c3, c4 = 12194.217**2, 20.598997**2, 107.65265**2, 737.86223**2
    num = c1 * f2**2
    den = (f2 + c2) * np.sqrt((f2 + c3) * (f2 + c4)) * (f2 + c1)
    ra = num / den
    return 2.0 + 20.0 * np.log10(np.maximum(ra, 1e-30))
