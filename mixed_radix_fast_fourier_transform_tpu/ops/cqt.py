"""Constant-Q transform (CQT) — log-frequency spectral analysis.

Brown/Puckette spectral-kernel method, device-first: each constant-Q band k is
a windowed complex exponential g_k (length N_k ∝ 1/f_k, so every band has
the same Q = f_k/Δf_k).  Instead of correlating each band in the time
domain (ragged lengths — hostile to matmuls), all kernels are embedded in
one n_fft frame and applied in the frequency domain:

    CQT[t, k] = Σ_n x[t·hop + n]·conj(g_k[n])
              = (1/n_fft)·Σ_b X_t[b]·conj(Ĝ_k[b])   (Parseval)

so the whole transform is one batched frame FFT (the plan engine) followed
by one dense (n_fft, n_bins) matmul — the classic "sparse spectral kernel"
trick, except on an accelerator the DENSE kernel matmul is the fast path and
sparsification would only add gather traffic.  Kernels are built on the
host in fp64 (exact integer phase reduction like the twiddle machinery) and
baked into the jitted computation as constants.

Capability extension: the reference has no time-frequency analysis at all
(src/ contains only the FFT engine and convolve.c); this rides the same
plan-based FFT with librosa-class semantics (geometric frequency ladder,
per-band windows, hop-synchronous frames).
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.config import DEFAULT_CONFIG, SpectralConfig
from ..utils.factorize import next_pow2
from .fft import fft, ifft
from .stft import _frame, get_window

Array = jax.Array


def cqt_frequencies(
    n_bins: int, fmin: float, bins_per_octave: int = 12
) -> np.ndarray:
    """Center frequencies of the constant-Q ladder: fmin·2^(k/B)."""
    if n_bins < 1:
        raise ValueError(f"n_bins must be >= 1, got {n_bins}")
    if fmin <= 0:
        raise ValueError(f"fmin must be > 0, got {fmin}")
    if bins_per_octave < 1:
        raise ValueError(
            f"bins_per_octave must be >= 1, got {bins_per_octave}"
        )
    k = np.arange(n_bins, dtype=np.float64)
    return fmin * 2.0 ** (k / bins_per_octave)


def _cqt_kernel_time(
    fs: float,
    freqs: np.ndarray,
    bins_per_octave: int,
    window,
    filter_scale: float,
):
    """Host fp64 time-domain kernels: list of (length N_k, complex) arrays,
    each a symmetric window times exp(2πi·f_k·n/fs), L1-normalized (Brown's
    1/N_k convention, so a unit sinusoid at f_k yields |CQT| ~ window mean)."""
    Q = filter_scale / (2.0 ** (1.0 / bins_per_octave) - 1.0)
    kernels = []
    for f in freqs:
        n_k = max(int(round(Q * fs / f)), 1)
        w = get_window(window, n_k, np.float64, sym=True)
        n = np.arange(n_k, dtype=np.float64) - (n_k - 1) / 2.0
        # exact phase reduction: f/fs in fp64, phase mod 1 before the trig
        phase = 2.0 * np.pi * ((f / fs * n) % 1.0)
        g = w * (np.cos(phase) + 1j * np.sin(phase)) / n_k
        kernels.append(g)
    return kernels


@functools.lru_cache(maxsize=16)
def _cqt_spectral_kernel(
    fs: float,
    fmin: float,
    n_bins: int,
    bins_per_octave: int,
    window,
    filter_scale: float,
    n_fft,
):
    """Cached host build of the conjugated spectral kernel: (Khat, nf).
    Keyed on the full band-ladder spec — like the other host-constant
    builders (_dpss_host, _wigner_d_stack), an analysis loop calling cqt
    per signal must not re-run the O(Σ N_k) fp64 kernel synthesis.  Only
    hashable window specs (str/tuple) land here; array windows go through
    the uncached path."""
    freqs = cqt_frequencies(n_bins, fmin, bins_per_octave)
    kernels = _cqt_kernel_time(fs, freqs, bins_per_octave, window, filter_scale)
    max_len = max(k.size for k in kernels)
    nf = next_pow2(max_len) if n_fft is None else int(n_fft)
    if nf < max_len:
        raise ValueError(
            f"n_fft={nf} shorter than the longest kernel ({max_len}); "
            "raise n_fft or fmin"
        )
    # each time kernel centered in the frame, conjugated spectrum, 1/nf
    K = np.zeros((n_bins, nf), np.complex128)
    for i, g in enumerate(kernels):
        start = (nf - g.size) // 2
        K[i, start : start + g.size] = g
    return np.conj(np.fft.fft(K, axis=-1)) / nf, nf


def cqt(
    x,
    *,
    fs: float = 22050.0,
    fmin: float = 32.703195662574764,  # C1
    n_bins: int = 84,
    bins_per_octave: int = 12,
    hop: int = 512,
    window="hann",
    filter_scale: float = 1.0,
    center: bool = True,
    n_fft: Optional[int] = None,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Constant-Q transform of a real (or complex) signal along the last
    axis: (…, T) -> (…, n_frames, n_bins) complex coefficients.

    Band k has center frequency fmin·2^(k/bins_per_octave) and Q-matched
    length N_k = round(Q·fs/f_k), Q = filter_scale/(2^(1/B) − 1); frame t is
    centered on sample t·hop (``center=True`` zero-pads by n_fft//2, so
    every kernel window fits).  All bands must lie strictly below Nyquist.
    ``n_fft`` overrides the frame length (default: next power of two
    covering the longest kernel)."""
    x = jnp.asarray(x)
    if x.ndim < 1 or x.shape[-1] < 1:
        raise ValueError("cqt needs a non-empty signal")
    if hop < 1:
        raise ValueError(f"hop must be >= 1, got {hop}")
    if fs <= 0:
        raise ValueError(f"fs must be > 0, got {fs}")
    freqs = cqt_frequencies(n_bins, fmin, bins_per_octave)
    if freqs[-1] >= fs / 2.0:
        raise ValueError(
            f"highest band {freqs[-1]:.2f} Hz reaches Nyquist ({fs/2:.2f} "
            "Hz) — lower n_bins or raise fs"
        )
    build = (
        _cqt_spectral_kernel if isinstance(window, (str, tuple))
        else _cqt_spectral_kernel.__wrapped__  # array window: unhashable
    )
    Khat, nf = build(
        float(fs), float(fmin), int(n_bins), int(bins_per_octave), window,
        float(filter_scale), None if n_fft is None else int(n_fft),
    )

    if not jnp.issubdtype(x.dtype, jnp.inexact):
        x = x.astype(config.dtype)
    if center:
        pad = [(0, 0)] * (x.ndim - 1) + [(nf // 2, nf // 2)]
        x = jnp.pad(x, pad)
    t = x.shape[-1]
    if t < nf:
        pad = [(0, 0)] * (x.ndim - 1) + [(0, nf - t)]
        x = jnp.pad(x, pad)
        t = nf
    n_frames = 1 + (t - nf) // hop
    frames = _frame(x, nf, hop)  # (…, n_frames, nf)
    spec = fft(frames, config=config)
    # kernel matmul on planes (four real matmuls; complex constants
    # upload as planes)
    rdtype = jnp.real(spec).dtype
    Kr = jnp.asarray(Khat.real, rdtype)
    Ki = jnp.asarray(Khat.imag, rdtype)
    sr, si = jnp.real(spec), jnp.imag(spec)
    prec = config.op_precision
    out_r = jnp.einsum("...tb,kb->...tk", sr, Kr, precision=prec) - jnp.einsum(
        "...tb,kb->...tk", si, Ki, precision=prec
    )
    out_i = jnp.einsum("...tb,kb->...tk", sr, Ki, precision=prec) + jnp.einsum(
        "...tb,kb->...tk", si, Kr, precision=prec
    )
    return jax.lax.complex(out_r, out_i)


@functools.lru_cache(maxsize=16)
def _icqt_dual_kernel(
    fs: float,
    fmin: float,
    n_bins: int,
    bins_per_octave: int,
    window,
    filter_scale: float,
    n_fft,
    reg: float,
):
    """Cached host dual (synthesis) kernel P = K̂ᴴ(K̂K̂ᴴ + εI)⁻¹: the
    minimum-norm frame spectrum consistent with a CQT row.  (nf, n_bins)
    complex128 + nf."""
    Khat, nf = _cqt_spectral_kernel(
        fs, fmin, n_bins, bins_per_octave, window, filter_scale, n_fft
    )
    G = Khat @ np.conj(Khat.T)  # (n_bins, n_bins) Gram
    G = G + reg * np.eye(n_bins) * np.trace(G).real / n_bins
    P = np.conj(Khat.T) @ np.linalg.inv(G)
    return P, nf


def icqt(
    C,
    *,
    fs: float = 22050.0,
    fmin: float = 32.703195662574764,
    n_bins: Optional[int] = None,
    bins_per_octave: int = 12,
    hop: int = 512,
    window="hann",
    filter_scale: float = 1.0,
    length: Optional[int] = None,
    n_fft: Optional[int] = None,
    reg: float = 1e-6,
    n_iter: int = 0,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Approximate inverse CQT: (…, n_frames, n_bins) coefficients -> real
    signal.

    Per frame, the minimum-norm spectrum consistent with the CQT row is
    recovered through the host-precomputed dual kernel
    P = K̂ᴴ(K̂K̂ᴴ + εI)⁻¹ (one dense matmul), inverted to a time frame
    (2·Re ifft — the kernels are analytic, so the Hermitian half is
    implied), and frames are averaged by overlap-add.  Exact only on the
    subspace the Q-band kernels span (a log-frequency bandpass): energy
    outside [fmin, fmax] and the sub-frame fine structure the hop discards
    cannot return — same contract as librosa.icqt.  Pass the ``length`` of
    the original signal to crop the centered padding.  ``n_iter`` > 0 runs
    Landweber refinement y <- y + icqt(C - cqt(y)) (each iteration one
    cqt + one dual matmul; measured on a two-tone probe: waveform
    correlation 0.961 direct -> 0.978 at 5 iterations)."""
    C = jnp.asarray(C)
    if C.ndim < 2:
        raise ValueError("C must be (…, n_frames, n_bins)")
    nb = C.shape[-1] if n_bins is None else int(n_bins)
    if C.shape[-1] != nb:
        raise ValueError(f"C has {C.shape[-1]} bins, expected {nb}")
    if hop < 1:
        raise ValueError(f"hop must be >= 1, got {hop}")
    freqs = cqt_frequencies(nb, fmin, bins_per_octave)
    if freqs[-1] >= fs / 2.0:
        raise ValueError("band ladder reaches Nyquist — see cqt()")
    if not isinstance(window, (str, tuple)):
        raise ValueError("icqt needs a hashable window spec (str or tuple)")
    P, nf = _icqt_dual_kernel(
        float(fs), float(fmin), int(nb), int(bins_per_octave), window,
        float(filter_scale), None if n_fft is None else int(n_fft),
        float(reg),
    )
    n_frames = C.shape[-2]
    rdtype = jnp.real(C).dtype
    Pr = jnp.asarray(P.real, rdtype)
    Pi = jnp.asarray(P.imag, rdtype)
    cr, ci = jnp.real(C), jnp.imag(C)
    prec = config.op_precision
    xr = jnp.einsum("...tk,bk->...tb", cr, Pr, precision=prec) - jnp.einsum(
        "...tk,bk->...tb", ci, Pi, precision=prec
    )
    xi = jnp.einsum("...tk,bk->...tb", cr, Pi, precision=prec) + jnp.einsum(
        "...tk,bk->...tb", ci, Pr, precision=prec
    )
    spec = jax.lax.complex(xr, xi)  # (…, n_frames, nf) analytic spectra
    frames = 2.0 * jnp.real(ifft(spec, config=config))  # Hermitian half implied
    # rectangular overlap-add, averaged by per-sample coverage
    t_padded = nf + (n_frames - 1) * hop
    starts = np.arange(n_frames) * hop
    idx = (starts[:, None] + np.arange(nf)[None, :]).reshape(-1)
    batch = frames.shape[:-2]
    out = jnp.zeros((*batch, t_padded), rdtype)
    out = out.at[..., idx].add(frames.reshape(*batch, -1))
    cover = np.zeros(t_padded)
    for s in starts:
        cover[s : s + nf] += 1.0
    out = out * jnp.asarray(1.0 / np.maximum(cover, 1.0), rdtype)
    out = out[..., nf // 2 : t_padded - nf // 2]  # undo cqt's center pad
    if length is not None:
        out = out[..., : int(length)]
    if n_iter > 0:
        kw = dict(
            fs=fs, fmin=fmin, bins_per_octave=bins_per_octave, hop=hop,
            window=window, filter_scale=filter_scale, n_fft=n_fft,
        )

        def body(_, y):
            r = C - cqt(y, n_bins=nb, center=True, config=config, **kw)[
                ..., : C.shape[-2], :
            ]
            return y + icqt(
                r, n_bins=nb, length=out.shape[-1], reg=reg, n_iter=0,
                config=config, **kw,
            )

        out = jax.lax.fori_loop(0, n_iter, body, out)
    return out
