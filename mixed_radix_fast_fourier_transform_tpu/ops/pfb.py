"""Polyphase filterbank channelizer (weighted overlap-add spectrometer).

Capability extension (the reference C library has none): the standard
critically-sampled K-channel analysis PFB used by SDR / radio-astronomy
spectrometers — a P-tap-per-branch windowed-sinc prototype filter applied
as a polyphase weighting, then one length-K FFT per frame:

    y[m, k_out] = FFT_K( Σ_p h[p·K + k] · x[m·K + p·K + k] )

Compared with a bare FFT spectrogram the PFB's channel response is flat
in-band with far lower leakage (the prototype's stopband), at the cost of
P− 1 frames of latency.

Device shape: the signal reshapes into (frames, P, K) windows, the polyphase
weighting is one broadcast multiply + reduction over P that XLA fuses into
the frame load (elementwise), and the channel transform is the engine's batched
length-K FFT (stage matmuls).  The prototype filter is a host fp64
constant, like twiddles (CLAUDE.md conventions).
"""

from __future__ import annotations

from math import gcd
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.config import DEFAULT_CONFIG, SpectralConfig

Array = jax.Array


def pfb_prototype(n_channels: int, taps_per_branch: int = 8,
                  window: str = "hamming") -> np.ndarray:
    """Windowed-sinc prototype lowpass for a K-channel PFB, length P·K,
    cutoff at the channel half-width (1/(2K) cycles/sample), peak-normalized
    so a unit-amplitude in-band tone keeps unit channel gain."""
    from .stft import get_window

    K, P = int(n_channels), int(taps_per_branch)
    if K < 2:
        raise ValueError(f"n_channels must be >= 2, got {K}")
    if P < 1:
        raise ValueError(f"taps_per_branch must be >= 1, got {P}")
    n = np.arange(P * K, dtype=np.float64)
    t = (n - (P * K - 1) / 2.0) / K
    h = np.sinc(t) * np.asarray(get_window(window, P * K), np.float64)
    # DC gain 1: each branch carries ~1/K of the weight and the channel FFT
    # sums K branches coherently, so a unit complex tone at a channel
    # center gives |y| = 1 (a real cosine splits to 1/2 at ±k0)
    return h / h.sum()


def _check_prototype(h, K: int, P: int, window: str) -> np.ndarray:
    if h is None:
        return pfb_prototype(K, P, window)
    h = np.asarray(h, np.float64)
    if h.ndim != 1 or h.size % K:
        raise ValueError(
            f"prototype filter length {h.size} must be a multiple of "
            f"n_channels {K}"
        )
    return h


def pfb_analysis(
    x,
    n_channels: int,
    taps_per_branch: int = 8,
    window: str = "hamming",
    h: Optional[np.ndarray] = None,
    hop: Optional[int] = None,
    mode: str = "valid",
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """K-channel analysis PFB: (…, T) -> (…, frames, K) complex with
    frames = (T − P·K)//hop + 1 (``mode="valid"``: no zero-padded
    warm-up), channel k centered on frequency k/K cycles/sample (FFT bin
    order; real inputs give Hermitian channels).

    ``mode="full"`` first right-pads the signal to a multiple of K (a
    partial tail block would otherwise be truncated and its residues
    would wrap in the synthesis deconvolution), then zero-pads (P−1)·K
    samples at both ends so every window position overlapping the data
    is kept — per polyphase residue the frames then hold the COMPLETE
    linear convolution with the branch filter, which is what makes
    :func:`pfb_synthesis` an exact inverse (of the padded length
    ⌈T/K⌉·K; the trailing pad reconstructs as ~0).

    ``hop`` defaults to K (critically sampled).  ``hop < K`` gives the
    oversampled WOLA channelizer (e.g. ``hop=3*K//4`` for the 4/3-
    oversampled banks radio astronomy uses); each channel is then a true
    baseband (derotated) sequence at rate fs/hop, so critically-sampled
    and oversampled outputs agree on coincident frames.

    Pass ``h`` (length P·K) to override the :func:`pfb_prototype` filter.
    """
    from .fft import fft as _fft

    x = jnp.asarray(x)
    K, P = int(n_channels), int(taps_per_branch)
    h = _check_prototype(h, K, P, window)
    P = h.size // K
    M = K if hop is None else int(hop)
    if not 1 <= M <= P * K:
        raise ValueError(f"hop must be in [1, {P * K}], got {M}")
    if mode not in ("valid", "full"):
        raise ValueError(f"mode must be 'valid' or 'full', got {mode!r}")
    if mode == "full":
        tail = (-x.shape[-1]) % K  # complete the last block (ADVICE r4)
        pad = [(0, 0)] * (x.ndim - 1) + [((P - 1) * K, (P - 1) * K + tail)]
        x = jnp.pad(x, pad)
    if x.shape[-1] < P * K + M:
        raise ValueError(
            f"signal length {x.shape[-1]} too short for {P} taps of "
            f"{K} channels at hop {M} (need >= {P * K + M})"
        )
    n_frames = (x.shape[-1] - P * K) // M + 1
    rdt = jnp.result_type(x.dtype, jnp.float32)
    cdt = jnp.result_type(rdt, jnp.complex64)
    # frame m, tap p, branch k reads x[m·hop + p·K + k]: an overlapping
    # view — reshape into blocks of g = gcd(hop, K) and take P·(K/g)
    # static strided slices (no gather)
    g = gcd(M, K)
    Mg, Kg = M // g, K // g
    nb = (n_frames - 1) * Mg + P * Kg
    xv = x[..., : nb * g].astype(
        cdt if jnp.issubdtype(x.dtype, jnp.complexfloating) else rdt
    )
    blocks = xv.reshape(xv.shape[:-1] + (nb, g))
    span = (n_frames - 1) * Mg + 1
    frames = jnp.stack(
        [
            jnp.concatenate(
                [
                    blocks[..., p * Kg + j : p * Kg + j + span : Mg, :]
                    for j in range(Kg)
                ],
                axis=-1,
            )
            for p in range(P)
        ],
        axis=-2,
    )  # (…, frames, P, K)
    hw = jnp.asarray(h.reshape(P, K), rdt)
    v = jnp.sum(frames * hw, axis=-2)  # (…, frames, K)
    y = _fft(v.astype(cdt), config=config)
    if M != K:
        # the FFT phase-references each frame to its own start m·hop; a
        # baseband channel sequence needs e^{-2πi k (m·hop mod K)/K}.  The
        # ramp cycles with period K/g along m, so only the (period, K)
        # table ships to device; full frame blocks broadcast against it
        # and a remainder slice covers the tail (never a frames-length
        # host constant — 1M frames × 64 ch would bake a 1 GB literal).
        period = K // g
        mM = (np.arange(period, dtype=np.int64) * M) % K
        tab = jnp.asarray(
            np.exp(-2j * np.pi * np.outer(mM, np.arange(K)) / K), y.dtype
        )  # (period, K)
        q, r = divmod(n_frames, period)
        parts = []
        if q:
            head = y[..., : q * period, :].reshape(
                y.shape[:-2] + (q, period, K)
            ) * tab
            parts.append(head.reshape(y.shape[:-2] + (q * period, K)))
        if r:
            parts.append(y[..., q * period :, :] * tab[:r])
        y = parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=-2)
    return y


def pfb_synthesis(
    y,
    taps_per_branch: int = 8,
    window: str = "hamming",
    h: Optional[np.ndarray] = None,
    eps: float = 1e-8,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Inverse of the critically-sampled ``pfb_analysis(..., mode="full")``:
    (…, frames, K) channels -> (…, (frames−P+1)·K) time samples.

    Per residue r = n mod K the analysis is a linear convolution of the
    polyphase component x_r[q] = x[qK+r] with the flipped branch filter
    h̃_r[p] = h[(P−1−p)K+r]; full-mode frames hold that convolution
    COMPLETELY (length F = Q+P−1 for Q signal blocks), so a circular
    length-F deconvolution inverts it exactly.  The synthesis undoes the
    channel FFT (one batched engine IFFT), then divides by the branch
    spectra along the FRAME axis with Tikhonov floor ``eps``
    (H̄/(|H|²+eps·max|H|²)) — all K branch deconvolutions ride ONE batched
    engine FFT pair (stage matmuls); branch spectra are host fp64
    plan constants.

    The fractional-delay branches dip to ~0.04 of peak gain at block-
    Nyquist (the channel-edge frequencies a critically-sampled bank
    attenuates), so reconstruction amplifies round-off there ~25×:
    measured round-trip error is ~1e-4 in fp32.  Valid-mode frames lack
    the P−1 warm-up/tail frames and deconvolve with a boundary transient
    the dip-amplified inverse smears — always analyze with
    ``mode="full"`` when inversion is the goal.  Oversampled (hop < K)
    analyses are not invertible by this routine — decimate the frames
    back to hop K first.
    """
    from .fft import fft as _fft, ifft as _ifft

    y = jnp.asarray(y)
    if y.ndim < 2:
        raise ValueError("pfb_synthesis needs (…, frames, K) channels")
    K = y.shape[-1]
    P = int(taps_per_branch)
    h = _check_prototype(h, K, P, window)
    P = h.size // K
    F = y.shape[-2]
    if F < P:
        raise ValueError(f"need at least P={P} frames, got {F}")
    v = _ifft(y, config=config)  # (…, F, K) branch outputs
    hb = h.reshape(P, K)[::-1]  # h̃_r[p] = h_r[P−1−p]
    Hf = np.fft.fft(np.concatenate([hb, np.zeros((F - P, K))]), axis=0)
    mag2 = np.abs(Hf) ** 2
    Hinv = np.conj(Hf) / (mag2 + eps * mag2.max(axis=0, keepdims=True))
    Vf = _fft(v, axis=-2, config=config)
    xr = _ifft(Vf * jnp.asarray(Hinv, Vf.dtype), axis=-2, config=config)
    # x_r occupies blocks 0..F−P; the last P−1 blocks are the pad tail
    xr = xr[..., : F - P + 1, :]
    return xr.reshape(xr.shape[:-2] + ((F - P + 1) * K,))


def pfb_frequencies(n_channels: int, fs: float = 1.0) -> np.ndarray:
    """Center frequency of each PFB channel (FFT bin order)."""
    return np.fft.fftfreq(int(n_channels)) * fs
