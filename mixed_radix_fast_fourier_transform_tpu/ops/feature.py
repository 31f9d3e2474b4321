"""Spectral descriptors (librosa.feature conventions, batched).

All features run off ONE shared engine STFT magnitude (computed here or
passed in as ``S``) and reduce with dense matmul/weighted-moment
arithmetic — each descriptor is a couple of elementwise ops and
reductions XLA fuses into the spectrogram pass.  Frames follow the
library's stft: frame m centered on sample m·hop, (…, frames, bins).

Capability extension: the reference C library has no feature extraction.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.config import DEFAULT_CONFIG, SpectralConfig
from .stft import stft as _stft

Array = jax.Array


def _magspec(x, S, nperseg, hop, window, power, config) -> Array:
    if S is not None:
        S = jnp.asarray(S)
        if S.ndim < 2:
            raise ValueError("S must be (…, frames, bins)")
        mag = jnp.abs(S) if jnp.issubdtype(S.dtype, jnp.complexfloating) else S
        return mag ** power if power != 1.0 else mag
    x = jnp.asarray(x)
    if jnp.issubdtype(x.dtype, jnp.complexfloating):
        raise ValueError("features take real signals")
    spec = _stft(x, nperseg, nperseg - hop, window, center=True,
                 config=config)
    mag = jnp.abs(spec)
    return mag ** power if power != 1.0 else mag


def spectral_centroid(
    x=None, sr: float = 22050.0, nperseg: int = 2048,
    hop: Optional[int] = None, window="hann", S=None,
    *, config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """First moment of the magnitude spectrum per frame, in Hz:
    (…, T) -> (…, frames)."""
    hop = nperseg // 4 if hop is None else int(hop)
    mag = _magspec(x, S, nperseg, hop, window, 1.0, config)
    freqs = jnp.asarray(
        np.fft.rfftfreq(2 * (mag.shape[-1] - 1)) * sr, mag.dtype
    )
    norm = jnp.maximum(jnp.sum(mag, -1), jnp.asarray(1e-30, mag.dtype))
    return jnp.sum(mag * freqs, -1) / norm


def spectral_bandwidth(
    x=None, sr: float = 22050.0, nperseg: int = 2048,
    hop: Optional[int] = None, window="hann", S=None, p: float = 2.0,
    *, config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """p-th-order spread about the centroid per frame, in Hz
    (librosa.feature.spectral_bandwidth)."""
    hop = nperseg // 4 if hop is None else int(hop)
    mag = _magspec(x, S, nperseg, hop, window, 1.0, config)
    freqs = jnp.asarray(
        np.fft.rfftfreq(2 * (mag.shape[-1] - 1)) * sr, mag.dtype
    )
    norm = jnp.maximum(jnp.sum(mag, -1), jnp.asarray(1e-30, mag.dtype))
    cent = (jnp.sum(mag * freqs, -1) / norm)[..., None]
    dev = jnp.abs(freqs - cent) ** p
    return (jnp.sum(mag * dev, -1) / norm) ** (1.0 / p)


def spectral_rolloff(
    x=None, sr: float = 22050.0, nperseg: int = 2048,
    hop: Optional[int] = None, window="hann", S=None,
    roll_percent: float = 0.85,
    *, config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Frequency below which ``roll_percent`` of the spectral energy
    lies, per frame, in Hz (first bin crossing the threshold — an argmax
    over a cumulative-sum mask, no data-dependent control flow)."""
    if not 0.0 < roll_percent < 1.0:
        raise ValueError(f"roll_percent must be in (0, 1), got {roll_percent}")
    hop = nperseg // 4 if hop is None else int(hop)
    mag = _magspec(x, S, nperseg, hop, window, 1.0, config)
    freqs = jnp.asarray(
        np.fft.rfftfreq(2 * (mag.shape[-1] - 1)) * sr, mag.dtype
    )
    csum = jnp.cumsum(mag, -1)
    thresh = roll_percent * csum[..., -1:]
    idx = jnp.argmax(csum >= thresh, axis=-1)
    return freqs[idx]


def spectral_flatness(
    x=None, nperseg: int = 2048, hop: Optional[int] = None, window="hann",
    S=None, power: float = 2.0, amin: float = 1e-10,
    *, config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Wiener entropy per frame: geometric / arithmetic mean of the power
    spectrum — 1 for white noise, →0 for pure tones."""
    hop = nperseg // 4 if hop is None else int(hop)
    p = _magspec(x, S, nperseg, hop, window, power, config)
    p = jnp.maximum(p, jnp.asarray(amin, p.dtype))
    gmean = jnp.exp(jnp.mean(jnp.log(p), -1))
    return gmean / jnp.mean(p, -1)


def spectral_contrast(
    x=None, sr: float = 22050.0, nperseg: int = 2048,
    hop: Optional[int] = None, window="hann", S=None,
    n_bands: int = 6, fmin: float = 200.0, quantile: float = 0.02,
    *, config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Peak-to-valley contrast (dB) in octave-spaced bands
    (Jiang et al. 2002; librosa.feature.spectral_contrast):
    (…, T) -> (…, frames, n_bands+1).  Band quantiles are top-k sums on
    sorted static slices."""
    if n_bands < 1:
        raise ValueError(f"n_bands must be >= 1, got {n_bands}")
    if not 0.0 < quantile < 1.0:
        raise ValueError(f"quantile must be in (0, 1), got {quantile}")
    hop = nperseg // 4 if hop is None else int(hop)
    mag = _magspec(x, S, nperseg, hop, window, 1.0, config)
    nb = mag.shape[-1]
    freqs = np.fft.rfftfreq(2 * (nb - 1)) * sr
    edges = fmin * (2.0 ** np.arange(n_bands + 1))
    if np.any(edges[:-1] >= sr / 2):
        raise ValueError(
            f"octave band edges exceed Nyquist ({edges[-2]} >= {sr / 2}); "
            "reduce n_bands or fmin"
        )
    edges[-1] = min(edges[-1], sr / 2)  # top band clamps at Nyquist
    bounds = np.concatenate([[0.0], edges])
    out = []
    tiny = jnp.asarray(1e-30, mag.dtype)
    for b in range(n_bands + 1):
        lo, hi = bounds[b], bounds[b + 1]
        sel = (freqs >= lo) & (freqs < hi) if b < n_bands else (
            (freqs >= lo) & (freqs <= sr / 2)
        )
        k = max(int(sel.sum()), 1)
        band = mag[..., np.where(sel)[0]] if sel.any() else mag[..., :1]
        srt = jnp.sort(band, axis=-1)
        q = max(int(np.ceil(quantile * k)), 1)
        valley = jnp.mean(srt[..., :q], -1)
        peak = jnp.mean(srt[..., -q:], -1)
        out.append(jnp.log10(jnp.maximum(peak, tiny))
                   - jnp.log10(jnp.maximum(valley, tiny)))
    # librosa convention: power_to_db on the MAGNITUDE quantiles -> 10·log10
    return 10.0 * jnp.stack(out, axis=-1)


def zero_crossing_rate(
    x, frame_length: int = 2048, hop: Optional[int] = None,
    *, config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Fraction of sign changes per frame: (…, T) -> (…, frames)
    (librosa conventions, center-padded frames)."""
    from .stft import _frame

    x = jnp.asarray(x)
    if jnp.issubdtype(x.dtype, jnp.complexfloating):
        raise ValueError("zero_crossing_rate takes real signals")
    hop = frame_length // 4 if hop is None else int(hop)
    pad = [(0, 0)] * (x.ndim - 1) + [(frame_length // 2,) * 2]
    xp = jnp.pad(x.astype(config.dtype), pad)
    frames = _frame(xp, frame_length, hop)
    sign = frames >= 0
    flips = sign[..., 1:] != sign[..., :-1]
    return jnp.mean(flips.astype(config.dtype), -1)


def rms(
    x=None, frame_length: int = 2048, hop: Optional[int] = None, S=None,
    *, config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Root-mean-square energy per frame, from the waveform or (Parseval)
    from a spectrogram magnitude."""
    from .stft import _frame

    hop = frame_length // 4 if hop is None else int(hop)
    if S is not None:
        S = jnp.asarray(S)
        if S.ndim < 2:
            raise ValueError("S must be (…, frames, bins)")
        mag2 = (jnp.abs(S) if jnp.issubdtype(S.dtype, jnp.complexfloating)
                else S) ** 2
        n = 2 * (S.shape[-1] - 1)
        # Parseval: undo the one-sided fold, normalize by n²
        full = 2.0 * jnp.sum(mag2, -1) - mag2[..., 0] - mag2[..., -1]
        return jnp.sqrt(jnp.maximum(full, 0.0) / (n * n))
    x = jnp.asarray(x)
    if jnp.issubdtype(x.dtype, jnp.complexfloating):
        raise ValueError("rms takes real signals")
    pad = [(0, 0)] * (x.ndim - 1) + [(frame_length // 2,) * 2]
    xp = jnp.pad(x.astype(config.dtype), pad)
    frames = _frame(xp, frame_length, hop)
    return jnp.sqrt(jnp.mean(frames * frames, -1))


def specaugment(
    S,
    key,
    n_freq_masks: int = 2,
    freq_mask_width: int = 16,
    n_time_masks: int = 2,
    time_mask_width: int = 32,
    mask_value: float = 0.0,
):
    """SpecAugment masking (Park et al. 2019) on a spectrogram
    (…, frames, bins): ``n_freq_masks`` random bands of width up to
    ``freq_mask_width`` zeroed along frequency, ``n_time_masks`` along
    time.  ``key`` is a jax PRNG key; leading batch dims get independent
    masks.  Pure comparisons against uniform draws — no dynamic slicing,
    so it jits and vmaps freely (the standard audio-ML augmentation)."""
    S = jnp.asarray(S)
    if S.ndim < 2:
        raise ValueError("S must be (…, frames, bins)")
    if n_freq_masks < 0 or n_time_masks < 0:
        raise ValueError("mask counts must be >= 0")
    if freq_mask_width < 0 or time_mask_width < 0:
        raise ValueError("mask widths must be >= 0")
    T, F = S.shape[-2], S.shape[-1]
    batch = S.shape[:-2]
    rdtype = jnp.real(S).dtype

    def _axis_mask(k, n_masks, width, size):
        if n_masks == 0 or width == 0:
            return jnp.ones(batch + (size,), bool)
        kw, ks = jax.random.split(k)
        w = jax.random.randint(kw, batch + (n_masks, 1), 0, width + 1)
        s = jax.random.uniform(ks, batch + (n_masks, 1)) * jnp.maximum(
            size - w, 1
        ).astype(jnp.float32)
        s = s.astype(jnp.int32)
        grid = jnp.arange(size)
        hit = (grid >= s) & (grid < s + w)  # (…, n_masks, size)
        return ~jnp.any(hit, axis=-2)

    kf, kt = jax.random.split(key)
    fmask = _axis_mask(kf, n_freq_masks, freq_mask_width, F)
    tmask = _axis_mask(kt, n_time_masks, time_mask_width, T)
    keep = fmask[..., None, :] & tmask[..., :, None]
    fill = jnp.asarray(mask_value, S.dtype)
    return jnp.where(keep, S, fill)


def chroma_filterbank(sr: float, n_fft: int, n_chroma: int = 12,
                      tuning: float = 0.0, ctroct: float = 5.0,
                      octwidth: float = 2.0) -> np.ndarray:
    """Chroma filterbank (n_chroma, n_fft//2+1) — librosa.filters.chroma
    conventions: Gaussian pitch-class bins on the log-frequency axis with
    a soft octave-centering envelope; lru-cached host fp64 constant (same
    pattern as the mel filterbank)."""
    if n_chroma < 2:
        raise ValueError(f"n_chroma must be >= 2, got {n_chroma}")
    return _chroma_filterbank_cached(
        float(sr), int(n_fft), int(n_chroma), float(tuning), float(ctroct),
        float(octwidth),
    )


@functools.lru_cache(maxsize=16)
def _chroma_filterbank_cached(sr: float, n_fft: int, n_chroma: int,
                              tuning: float, ctroct: float,
                              octwidth: float) -> np.ndarray:
    nb = n_fft // 2 + 1
    freqs = np.fft.rfftfreq(n_fft) * sr
    freqs = freqs[1:]  # DC has no pitch
    # fractional chroma bin of each frequency (A440 reference, C-based)
    frqbins = n_chroma * (np.log2(freqs / (440.0 / 16.0)) - tuning / n_chroma)
    # width: half a semitone in chroma-bin units (librosa binwidthbins)
    wts = np.zeros((n_chroma, nb))
    binwidth = np.concatenate([
        np.maximum(frqbins[1:] - frqbins[:-1], 1.0), [1.0]
    ])
    d = frqbins[None, :] - np.arange(n_chroma)[:, None]
    nc2 = round(n_chroma / 2)
    d = np.remainder(d + nc2 + 10 * n_chroma, n_chroma) - nc2
    w = np.exp(-0.5 * (2 * d / np.tile(binwidth, (n_chroma, 1))) ** 2)
    # normalize columns then apply the octave-weighting envelope
    w = w / np.maximum(np.sqrt(np.sum(w * w, axis=0, keepdims=True)), 1e-30)
    if octwidth:
        w *= np.exp(-0.5 * ((frqbins / n_chroma - ctroct) / octwidth) ** 2)
    wts[:, 1:] = w
    # the A440/16 reference puts A at row 0; roll 3 semitones so row 0 = C
    return np.roll(wts, -3 * (n_chroma // 12), axis=0)


def chroma_stft(
    x=None, sr: float = 22050.0, nperseg: int = 2048,
    hop: Optional[int] = None, window="hann", S=None, n_chroma: int = 12,
    tuning: float = 0.0, power: float = 2.0,
    *, config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Chromagram: (…, T) -> (…, frames, n_chroma), energy folded onto
    pitch classes (librosa.feature.chroma_stft shape conventions, max-
    normalized per frame) — one filterbank matmul on the power
    spectrogram."""
    hop = nperseg // 4 if hop is None else int(hop)
    p = _magspec(x, S, nperseg, hop, window, power, config)
    fb = chroma_filterbank(sr, 2 * (p.shape[-1] - 1), n_chroma, tuning)
    c = jnp.einsum("...tb,cb->...tc", p, jnp.asarray(fb, p.dtype),
                   precision=config.op_precision)
    peak = jnp.max(c, axis=-1, keepdims=True)
    return c / jnp.maximum(peak, jnp.asarray(1e-30, c.dtype))


def onset_strength(
    x=None, sr: float = 22050.0, nperseg: int = 2048,
    hop: Optional[int] = None, n_mels: int = 128, S=None,
    *, config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Spectral-flux onset envelope: (…, T) -> (…, frames) — positive
    first difference of the log-mel spectrogram, averaged over bands
    (librosa.onset.onset_strength's default recipe)."""
    from .mel import melspectrogram

    hop = nperseg // 4 if hop is None else int(hop)
    if S is None:
        S = melspectrogram(x, sr, n_fft=nperseg, hop=hop, n_mels=n_mels,
                           config=config)
    else:
        S = jnp.asarray(S)
        if S.ndim < 2:
            raise ValueError("S must be (…, frames, bands)")
    amin = jnp.asarray(1e-10, jnp.real(S).dtype)
    db = 10.0 * jnp.log10(jnp.maximum(S, amin))
    flux = jnp.maximum(db[..., 1:, :] - db[..., :-1, :], 0.0)
    env = jnp.mean(flux, axis=-1)
    pad = [(0, 0)] * (env.ndim - 1) + [(1, 0)]
    return jnp.pad(env, pad)


def tempo(
    x=None, sr: float = 22050.0, nperseg: int = 2048,
    hop: Optional[int] = None, onset_env=None,
    start_bpm: float = 120.0, std_bpm: float = 1.0,
    max_bpm: float = 320.0, min_bpm: float = 24.0,
    *, config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Global tempo estimate in BPM: (…, T) -> (…,) scalar per signal —
    the log-normal-weighted peak of the onset-envelope autocorrelation
    (librosa.beat.tempo's autocorrelation recipe), computed with one
    engine rfft/irfft round."""
    from .rfft import rfft as _rfft, irfft as _irfft

    hop = nperseg // 4 if hop is None else int(hop)
    env = (onset_strength(x, sr, nperseg, hop, config=config)
           if onset_env is None else jnp.asarray(onset_env))
    n = env.shape[-1]
    if n < 8:
        raise ValueError("onset envelope too short for a tempo estimate")
    env = env - jnp.mean(env, axis=-1, keepdims=True)
    nfft = int(2 ** np.ceil(np.log2(2 * n)))
    pad = [(0, 0)] * (env.ndim - 1) + [(0, nfft - n)]
    spec = _rfft(jnp.pad(env, pad), config=config)
    ac = _irfft(spec * jnp.conj(spec), n=nfft, config=config)[..., :n]
    # lag -> bpm grid (host): bpm = 60 / (lag · hop / sr)
    lags = np.arange(1, n)
    bpms = 60.0 * sr / (hop * lags)
    keep = (bpms >= min_bpm) & (bpms <= max_bpm)
    lags = lags[keep]
    bpms = bpms[keep]
    if lags.size == 0:
        raise ValueError("BPM window excludes every lag; widen the range")
    prior = np.exp(-0.5 * ((np.log2(bpms / start_bpm)) / std_bpm) ** 2)
    score = ac[..., lags] * jnp.asarray(prior, ac.dtype)
    best = jnp.argmax(score, axis=-1)
    return jnp.asarray(bpms, ac.dtype)[best]


def delta(
    data,
    width: int = 9,
    order: int = 1,
    axis: int = -2,
    *, config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Local-slope delta features (librosa.feature.delta semantics: a
    Savitzky-Golay derivative of the feature track along ``axis``,
    'interp' edges) — one static tap contraction via
    :func:`~..ops.signal.savgol_filter`."""
    from .signal import savgol_filter

    if width < 3 or width % 2 == 0:
        raise ValueError(f"width must be odd and >= 3, got {width}")
    if order < 1:
        raise ValueError(f"order must be >= 1, got {order}")
    # librosa: polyorder == deriv order (the least-squares local slope)
    return savgol_filter(
        data, width, polyorder=order, deriv=order, axis=axis, config=config,
    )


def beat_track(
    x=None, sr: float = 22050.0, nperseg: int = 2048,
    hop: Optional[int] = None, onset_env=None, bpm=None,
    tightness: float = 100.0, min_bpm: float = 24.0, max_bpm: float = 320.0,
    *, config: SpectralConfig = DEFAULT_CONFIG,
) -> tuple:
    """Dynamic-programming beat tracker (Ellis 2007;
    librosa.beat.beat_track's recipe): (…, T) -> (bpm, beat_mask) with
    ``beat_mask`` boolean per frame (frame m centered on sample m·hop).

    Score C[t] = O[t] + max_Δ [ C[t−Δ] − tightness·log²(Δ/p) ] runs as one
    lax.scan with a static Δ-window ring buffer (the window covers
    2·p_max, so the tempo may be traced data); the beat sequence
    reconstructs with a reverse scan over backpointers — fully jittable,
    fixed shapes."""
    hop = nperseg // 4 if hop is None else int(hop)
    env = (onset_strength(x, sr, nperseg, hop, config=config)
           if onset_env is None else jnp.asarray(onset_env))
    if env.ndim != 1:
        raise ValueError("beat_track takes a single signal/envelope")
    n = env.shape[-1]
    if n < 8:
        raise ValueError("onset envelope too short to track beats")
    if bpm is None:
        bpm = tempo(onset_env=env, sr=sr, nperseg=nperseg, hop=hop,
                    start_bpm=120.0, min_bpm=min_bpm, max_bpm=max_bpm,
                    config=config)
    bpm = jnp.asarray(bpm)
    period = 60.0 * sr / (hop * jnp.maximum(bpm, 1e-3))  # frames (traced)
    rdt = env.dtype
    env = env / jnp.maximum(jnp.std(env), jnp.asarray(1e-10, rdt))
    D = int(min(np.ceil(2.0 * 60.0 * sr / (hop * min_bpm)), n - 1))
    deltas = jnp.arange(1, D + 1, dtype=rdt)
    # transition penalty (traced in period, static in Δ)
    pen = -tightness * jnp.log(deltas / period) ** 2  # (D,)
    neg = jnp.asarray(-1e9, rdt)

    def step(carry, o_t):
        buf, t = carry  # buf[k] = C[t-1-k], k = 0..D-1
        valid = jnp.arange(D) < t  # only scores from real frames
        cand = jnp.where(valid, buf + pen, neg)
        best = jnp.max(cand)
        arg = jnp.argmax(cand).astype(jnp.int32)  # Δ-1
        score = o_t + jnp.maximum(best, 0.0)  # allow fresh starts
        started = best > 0.0
        bp = jnp.where(started, arg + 1, 0).astype(jnp.int32)  # 0 = start
        buf2 = jnp.concatenate([score[None], buf[:-1]])
        return (buf2, t + 1), (score, bp)

    buf0 = jnp.full((D,), neg, rdt)
    (_, _), (scores, bps) = jax.lax.scan(
        step, (buf0, jnp.asarray(0, jnp.int32)), env
    )
    end = jnp.argmax(scores).astype(jnp.int32)

    def back(carry, t):
        cur = carry  # frame index of the next beat at or before t
        here = t == cur
        delta = bps[jnp.maximum(cur, 0)]
        nxt = jnp.where(here & (delta > 0), cur - delta, cur)
        nxt = jnp.where(here & (delta == 0), jnp.asarray(-1, jnp.int32), nxt)
        return nxt, here

    _, mask_rev = jax.lax.scan(
        back, end, jnp.arange(n - 1, -1, -1, dtype=jnp.int32)
    )
    beats = mask_rev[::-1]
    # silence gate: with a flat-zero envelope every DP score is 0 and the
    # backtrace would emit a phantom beat at frame 0
    beats = beats & (jnp.max(scores) > jnp.asarray(1e-6, rdt))
    return bpm, beats


def decompose(
    S,
    n_components: int = 8,
    n_iter: int = 200,
    key=None,
    eps: float = 1e-10,
    *, config: SpectralConfig = DEFAULT_CONFIG,
):
    """Nonnegative matrix factorization of a spectrogram
    (librosa.decompose.decompose's role): S (frames, bins) ≈
    activations (frames, k) @ components (k, bins), both nonnegative.

    Lee-Seung multiplicative updates for the Euclidean objective — a
    lax.fori_loop of six matmuls per iteration, jittable end to end;
    ``key`` (jax PRNG, default PRNGKey(0)) seeds the nonnegative init."""
    S = jnp.asarray(S)
    if S.ndim != 2:
        raise ValueError("decompose takes a single (frames, bins) matrix")
    if jnp.issubdtype(S.dtype, jnp.complexfloating):
        raise ValueError("decompose takes a magnitude/power spectrogram")
    if n_components < 1 or n_iter < 0:
        raise ValueError("need n_components >= 1 and n_iter >= 0")
    F, B = S.shape
    k = n_components
    if key is None:
        key = jax.random.PRNGKey(0)
    ka, kc = jax.random.split(key)
    scale = jnp.sqrt(jnp.mean(S) / k + eps)
    A = scale * jax.random.uniform(ka, (F, k), S.dtype, 0.1, 1.0)
    C = scale * jax.random.uniform(kc, (k, B), S.dtype, 0.1, 1.0)
    prec = config.op_precision
    epsd = jnp.asarray(eps, S.dtype)

    def step(_, state):
        A, C = state
        mm = lambda X, Y: jnp.matmul(X, Y, precision=prec)
        A = A * mm(S, C.T) / (mm(A, mm(C, C.T)) + epsd)
        C = C * mm(A.T, S) / (mm(mm(A.T, A), C) + epsd)
        return A, C

    A, C = jax.lax.fori_loop(0, n_iter, step, (A, C))
    return A, C


def _frame_loud(x: np.ndarray, top_db: float, frame_length: int,
                hop: int) -> np.ndarray:
    """Host per-frame loudness mask: frame RMS STRICTLY above the
    peak-relative threshold (so an all-zero signal is all-silent, the
    librosa convention)."""
    x = np.asarray(x, np.float64)
    n = x.shape[-1]
    if n < frame_length:
        x = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, frame_length - n)])
        n = frame_length
    n_frames = 1 + (n - frame_length) // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(frame_length)
    frames = x[..., idx]
    rms_ = np.sqrt(np.mean(frames * frames, axis=-1))
    return rms_ > rms_.max() * 10.0 ** (-top_db / 20.0)


def trim(x, top_db: float = 60.0, frame_length: int = 2048,
         hop: int = 512):
    """Trim leading/trailing silence (librosa.effects.trim): returns
    ``(trimmed, (start, end))`` sample indices.  HOST function (numpy in,
    numpy out) — the output length is data-dependent, so this cannot jit;
    use it in the input pipeline, not inside a compiled step."""
    x = np.asarray(x)
    if x.ndim != 1:
        raise ValueError("trim takes a single 1-D signal")
    if top_db <= 0:
        raise ValueError(f"top_db must be > 0, got {top_db}")
    loud = np.where(_frame_loud(x, top_db, frame_length, hop))[0]
    if loud.size == 0:
        return x[:0], (0, 0)
    start = int(loud[0] * hop)
    # the last loud frame covers [loud[-1]·hop, loud[-1]·hop + frame_length)
    end = int(min(loud[-1] * hop + frame_length, x.shape[-1]))
    return x[start:end], (start, end)


def split(x, top_db: float = 60.0, frame_length: int = 2048,
          hop: int = 512) -> np.ndarray:
    """Split on silence (librosa.effects.split): (n_intervals, 2) array of
    non-overlapping [start, end) sample indices of non-silent runs.
    HOST function — see :func:`trim`."""
    x = np.asarray(x)
    if x.ndim != 1:
        raise ValueError("split takes a single 1-D signal")
    if top_db <= 0:
        raise ValueError(f"top_db must be > 0, got {top_db}")
    loud = _frame_loud(x, top_db, frame_length, hop)
    padded = np.concatenate([[False], loud, [False]])
    d = np.diff(padded.astype(np.int8))
    run_starts = np.flatnonzero(d == 1)
    run_ends = np.flatnonzero(d == -1)  # one past the last loud frame
    out = []
    for i, (s, e) in enumerate(zip(run_starts, run_ends)):
        end = min((e - 1) * hop + frame_length, x.shape[-1])
        if i + 1 < len(run_starts):  # short gaps must not overlap the next run
            end = min(end, run_starts[i + 1] * hop)
        out.append([int(s * hop), int(end)])
    return np.asarray(out, np.int64).reshape(-1, 2)


def mu_law_encode(x, quantization_channels: int = 256) -> Array:
    """μ-law companding to integer classes (torchaudio conventions):
    float in [−1, 1] -> int32 in [0, Q−1]."""
    q = int(quantization_channels)
    if q < 2:
        raise ValueError(f"quantization_channels must be >= 2, got {q}")
    x = jnp.clip(jnp.asarray(x), -1.0, 1.0)
    mu = q - 1.0
    y = jnp.sign(x) * jnp.log1p(mu * jnp.abs(x)) / np.log1p(mu)
    return ((y + 1.0) / 2.0 * mu + 0.5).astype(jnp.int32)


def mu_law_decode(y, quantization_channels: int = 256) -> Array:
    """Inverse of :func:`mu_law_encode`: classes -> float in [−1, 1]."""
    q = int(quantization_channels)
    if q < 2:
        raise ValueError(f"quantization_channels must be >= 2, got {q}")
    mu = q - 1.0
    yf = jnp.asarray(y).astype(jnp.float32) * 2.0 / mu - 1.0
    return jnp.sign(yf) * (jnp.expm1(jnp.abs(yf) * np.log1p(mu))) / mu


def power_to_db(S, ref=1.0, amin: float = 1e-10,
                top_db: Optional[float] = 80.0) -> Array:
    """Power -> decibels, 10·log10(S/ref), floored ``top_db`` below the
    per-array peak (librosa.power_to_db; ``ref`` a scalar or 'max')."""
    S = jnp.asarray(S)
    if amin <= 0:
        raise ValueError(f"amin must be > 0, got {amin}")
    if top_db is not None and top_db < 0:
        raise ValueError(f"top_db must be >= 0, got {top_db}")
    if jnp.issubdtype(S.dtype, jnp.complexfloating):
        # librosa warns and proceeds on |S|; jnp.maximum on complex raises
        S = jnp.abs(S)
    amind = jnp.asarray(amin, jnp.real(S).dtype)
    mag = jnp.maximum(S, amind)
    if isinstance(ref, str):
        if ref != "max":
            raise ValueError(f"ref must be a scalar or 'max', got {ref!r}")
        refv = jnp.maximum(jnp.max(mag), amind)
    else:
        refv = jnp.maximum(jnp.asarray(abs(ref), mag.dtype), amind)
    db = 10.0 * (jnp.log10(mag) - jnp.log10(refv))
    if top_db is not None:
        db = jnp.maximum(db, jnp.max(db) - top_db)
    return db


def db_to_power(db, ref: float = 1.0) -> Array:
    """Inverse of :func:`power_to_db`: ref·10^(db/10)."""
    db = jnp.asarray(db)
    return ref * jnp.power(10.0, db / 10.0)


def amplitude_to_db(S, ref=1.0, amin: float = 1e-5,
                    top_db: Optional[float] = 80.0) -> Array:
    """Amplitude -> decibels: power_to_db on |S|² with matched refs
    (librosa.amplitude_to_db)."""
    S = jnp.asarray(S)
    mag = jnp.abs(S) if jnp.issubdtype(S.dtype, jnp.complexfloating) else S
    refv = ref if isinstance(ref, str) else abs(ref) ** 2
    return power_to_db(mag * mag, ref=refv, amin=amin * amin, top_db=top_db)


def db_to_amplitude(db, ref: float = 1.0) -> Array:
    """Inverse of :func:`amplitude_to_db`: ref·10^(db/20)."""
    db = jnp.asarray(db)
    return ref * jnp.power(10.0, db / 20.0)


def lpc(y, order: int, axis: int = -1) -> Array:
    """Linear prediction coefficients via Burg's method (librosa.lpc
    conventions): (…, N) -> (…, order+1) with ``a[0] = 1``, minimizing the
    summed forward+backward prediction error.  The all-pole spectral
    envelope is ``1/|A(e^{jw})|²`` (evaluate with :func:`freqz`).

    Device shape: ``order`` is static and small, so the Burg recursion
    unrolls at trace time — each step is batched elementwise work over
    the signal axis (two AXPYs + three reductions); there is no per-sample
    sequential scan.  A zero signal returns a[1:] = 0 instead of raising
    (librosa propagates a FloatingPointError from the 0/0)."""
    y = jnp.asarray(y)
    if jnp.issubdtype(y.dtype, jnp.complexfloating):
        raise ValueError("lpc takes real signals")
    order = int(order)
    if order < 1:
        raise ValueError(f"order must be >= 1, got {order}")
    y = jnp.moveaxis(y, axis, -1)
    n = y.shape[-1]
    if n <= order:
        raise ValueError(f"signal length {n} must exceed order {order}")
    dt = jnp.result_type(y.dtype, jnp.float32)
    y = y.astype(dt)
    tiny = jnp.asarray(np.finfo(np.float32).tiny, dt)
    fwd = y[..., 1:]
    bwd = y[..., :-1]
    den = jnp.sum(fwd * fwd, -1) + jnp.sum(bwd * bwd, -1)
    ar = jnp.zeros(y.shape[:-1] + (order + 1,), dt)
    ar = ar.at[..., 0].set(1.0)
    for i in range(order):
        reflect = -2.0 * jnp.sum(bwd * fwd, -1) / jnp.maximum(den, tiny)
        # a_new[j] = a[j] + k·a[i+1−j] over the active head j = 0..i+1
        # (a[0] stays 1 because a[i+1] is still 0 on entry)
        head = ar[..., : i + 2]
        ar = jnp.concatenate(
            [head + reflect[..., None] * head[..., ::-1], ar[..., i + 2:]],
            axis=-1,
        )
        fwd_prev = fwd
        fwd = fwd + reflect[..., None] * bwd
        bwd = bwd + reflect[..., None] * fwd_prev
        den = (1.0 - reflect * reflect) * den \
            - fwd[..., 0] ** 2 - bwd[..., -1] ** 2
        fwd = fwd[..., 1:]
        bwd = bwd[..., :-1]
    return ar


def chroma_cqt(
    x, sr: float = 22050.0, hop: int = 512, n_chroma: int = 12,
    n_octaves: int = 6, fmin: float = 32.703195662574764,
    bins_per_octave: int = 36,
    *, config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Constant-Q chromagram (librosa.feature.chroma_cqt's recipe):
    (…, T) -> (…, frames, n_chroma) — CQT magnitudes folded onto pitch
    classes (bin k of B-per-octave maps to class (k·n_chroma/B) mod
    n_chroma; with B a multiple of n_chroma the fold is an exact static
    one-hot matmul).  Sharper pitch-class profiles than the STFT chroma
    at low frequencies (the CQT ladder is log-spaced)."""
    from .cqt import cqt as _cqt

    if n_chroma < 2 or n_octaves < 1:
        raise ValueError("need n_chroma >= 2 and n_octaves >= 1")
    if bins_per_octave % n_chroma:
        raise ValueError(
            f"bins_per_octave ({bins_per_octave}) must be a multiple of "
            f"n_chroma ({n_chroma})"
        )
    n_bins = n_octaves * bins_per_octave
    C = jnp.abs(_cqt(x, fs=sr, fmin=fmin, n_bins=n_bins,
                     bins_per_octave=bins_per_octave, hop=hop,
                     config=config))
    cls = (np.arange(n_bins) * n_chroma // bins_per_octave) % n_chroma
    # librosa cq_to_chroma (base_c): roll so class 0 is always C, whatever
    # pitch class fmin sits on — midi(f) = 12·log2(f/440) + 69
    midi_fmin = 12.0 * np.log2(fmin / 440.0) + 69.0
    cls = (cls + int(round((midi_fmin % 12.0) * n_chroma / 12.0))) % n_chroma
    onehot = jnp.asarray(
        cls[:, None] == np.arange(n_chroma)[None, :], C.dtype
    )
    ch = jnp.einsum("...tb,bc->...tc", C, onehot,
                    precision=config.op_precision)
    peak = jnp.max(ch, axis=-1, keepdims=True)
    return ch / jnp.maximum(peak, jnp.asarray(1e-30, ch.dtype))


def tonnetz(
    x=None, sr: float = 22050.0, chroma=None,
    *, config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Tonal centroid features (Harte et al. 2006;
    librosa.feature.tonnetz): project an L1-normalized chromagram onto
    the 6-D circle-of-fifths / minor-third / major-third basis —
    (…, frames, 12) -> (…, frames, 6), one static matmul."""
    if chroma is None:
        chroma = chroma_cqt(x, sr, config=config)
    c = jnp.asarray(chroma)
    if c.ndim < 2 or c.shape[-1] != 12:
        raise ValueError("chroma must be (…, frames, 12)")
    d = np.arange(12)
    # Harte et al. 2006 radii R = [1, 1, 1, 1, 0.5, 0.5]: fifths and minor
    # thirds at radius 1, the major-third circle at radius 0.5
    r = np.array([1.0, 1.0, 0.5])
    phi = np.stack([
        r[0] * np.sin(d * 7 * np.pi / 6), r[0] * np.cos(d * 7 * np.pi / 6),
        r[1] * np.sin(d * 3 * np.pi / 2), r[1] * np.cos(d * 3 * np.pi / 2),
        r[2] * np.sin(d * 2 * np.pi / 3), r[2] * np.cos(d * 2 * np.pi / 3),
    ])  # (6, 12)
    norm = jnp.maximum(jnp.sum(jnp.abs(c), -1, keepdims=True),
                       jnp.asarray(1e-30, c.dtype))
    return jnp.einsum("...tc,dc->...td", c / norm,
                      jnp.asarray(phi, c.dtype),
                      precision=config.op_precision)


def gcc_phat(
    x, y, max_lag: Optional[int] = None, interp: bool = True,
    *, config: SpectralConfig = DEFAULT_CONFIG,
):
    """Generalized cross-correlation with phase transform (GCC-PHAT):
    estimate the delay of ``y`` relative to ``x`` in (fractional)
    samples — the standard TDOA estimator, robust to reverberation
    because only PHASE information survives the |X·Y*| whitening.

    Returns ``(lag, cc)``: the (…,) delay estimate and the whitened
    cross-correlation (…, 2·max_lag+1) on the lag grid
    −max_lag..max_lag.  One engine rfft/irfft round; the peak pick and
    parabolic refinement are argmax/gather, so it jits."""
    from .rfft import rfft as _rfft, irfft as _irfft

    x = jnp.asarray(x)
    y = jnp.asarray(y)
    if x.shape[-1] != y.shape[-1]:
        raise ValueError("x and y must share the last-axis length")
    if jnp.issubdtype(x.dtype, jnp.complexfloating) or \
            jnp.issubdtype(y.dtype, jnp.complexfloating):
        raise ValueError("gcc_phat takes real signals")
    n = x.shape[-1]
    if max_lag is None:
        max_lag = n // 2 - 1
    max_lag = int(max_lag)
    if not 1 <= max_lag < n:
        raise ValueError(f"need 1 <= max_lag < {n}, got {max_lag}")
    nfft = int(2 ** np.ceil(np.log2(2 * n)))
    pad = [(0, 0)] * (x.ndim - 1) + [(0, nfft - n)]
    X = _rfft(jnp.pad(x.astype(jnp.float32), pad), config=config)
    Y = _rfft(jnp.pad(y.astype(jnp.float32), pad), config=config)
    S = Y * jnp.conj(X)
    S = S / jnp.maximum(jnp.abs(S), jnp.asarray(1e-12, jnp.float32))
    cc_full = _irfft(S, n=nfft, config=config)
    # lags -max_lag..max_lag via the circular layout
    neg = cc_full[..., nfft - max_lag:]
    pos = cc_full[..., : max_lag + 1]
    cc = jnp.concatenate([neg, pos], axis=-1)
    k = jnp.argmax(cc, axis=-1)
    if interp:
        km = jnp.clip(k, 1, 2 * max_lag - 1)
        p0 = jnp.take_along_axis(cc, km[..., None] - 1, -1)[..., 0]
        p1 = jnp.take_along_axis(cc, km[..., None], -1)[..., 0]
        p2 = jnp.take_along_axis(cc, km[..., None] + 1, -1)[..., 0]
        denom = p0 + p2 - 2.0 * p1
        shift = jnp.where(jnp.abs(denom) > 1e-12,
                          0.5 * (p0 - p2) / denom, 0.0)
        # a peak AT ±max_lag has no valid 3-point neighborhood: the fit
        # around the clipped center biases the lag, so return the integer
        shift = jnp.where(k == km, jnp.clip(shift, -0.5, 0.5), 0.0)
        lag = k.astype(cc.dtype) + shift - max_lag
    else:
        lag = k.astype(cc.dtype) - max_lag
    return lag, cc
