"""Radar signal processing: pulse compression, range–Doppler maps, CFAR.

Capability extension (the reference C library has none): the standard
pulse-Doppler processing chain.  Every stage is engine work matrix units love —
pulse compression is one batched frequency-domain matched filter (two
engine FFTs), the Doppler dimension is one more batched FFT, and CFAR
training-cell means are box sums computed by cumulative sums (static
footprints, no data-dependent control flow), so the whole chain jits into
a single XLA program.

Conventions: a matched-filter output sample at delay d is
Σ_n rx[n+d]·conj(tx[n]) — peak value 1 for a unit-amplitude exact echo
when ``normalize=True`` (the sidelobe window is folded into the
normalization).  CFAR threshold factors assume square-law (exponential)
noise, the textbook Pfa calibration.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.config import DEFAULT_CONFIG, SpectralConfig
from ..utils.factorize import next_fast_len

Array = jax.Array


def _matched_spectrum(tx, window, L, config):
    """FFT of the windowed, conjugated, time-reversed transmit pulse,
    padded to L — i.e. the correlation kernel's spectrum — plus the
    unit-echo peak gain for normalization."""
    from .fft import fft as _fft
    from .stft import get_window

    tx = jnp.asarray(tx)
    if tx.ndim != 1:
        raise ValueError(f"tx pulse must be 1-D, got shape {tx.shape}")
    nt = tx.shape[0]
    cdt = jnp.result_type(tx.dtype, jnp.complex64)
    txc = tx.astype(cdt)
    if window is not None:
        w = jnp.asarray(
            np.asarray(get_window(window, nt), np.float64), jnp.real(txc).dtype
        )
        txw = txc * w
    else:
        txw = txc
    gain = jnp.sum(txw * jnp.conj(txc))  # unit-echo peak Σ w·|tx|²
    pad = jnp.zeros((L - nt,), cdt)
    # conj of the replica spectrum: ifft(R·conj(T))[d] is the circular
    # cross-correlation Σ_n rx[n+d]·conj(tx[n]) directly at lag d
    Tf = jnp.conj(_fft(jnp.concatenate([txw, pad]), config=config))
    return Tf, gain, nt, cdt


def pulse_compression(
    rx,
    tx,
    window: Optional[str] = None,
    mode: str = "valid",
    normalize: bool = True,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Matched-filter pulse compression of (…, N) receive data against a
    length-Nt transmit pulse: one frequency-domain correlation
    (two batched engine FFTs at a 2357-smooth padded length).

    ``mode="valid"`` returns the N−Nt+1 fully-overlapped delays (delay 0 =
    echo aligned with the start of ``rx``); ``mode="full"`` returns all
    N+Nt−1 lags starting at delay −(Nt−1).  ``window`` names a sidelobe
    taper applied to the transmit replica (e.g. "hamming", "hann" — any
    :func:`get_window` name); ``normalize=True`` scales so a unit-amplitude
    exact echo peaks at 1 regardless of taper.
    """
    from .fft import fft as _fft, ifft as _ifft

    rx = jnp.asarray(rx)
    if mode not in ("valid", "full"):
        raise ValueError(f"mode must be 'valid' or 'full', got {mode!r}")
    n = rx.shape[-1]
    nt = jnp.asarray(tx).shape[-1]
    if nt > n:
        raise ValueError(f"tx pulse ({nt}) longer than rx window ({n})")
    L = next_fast_len(n + nt - 1)
    Tf, gain, nt, cdt = _matched_spectrum(tx, window, L, config)
    pad = [(0, 0)] * (rx.ndim - 1) + [(0, L - n)]
    Rf = _fft(jnp.pad(rx.astype(cdt), pad), config=config)
    # circular correlation: lag d at index d, negative lags wrap to the end
    y = _ifft(Rf * Tf, config=config)
    if mode == "valid":
        y = y[..., : n - nt + 1]
    else:
        y = jnp.roll(y, nt - 1, axis=-1)[..., : n + nt - 1]
    if normalize:
        y = y / gain
    return y


def range_doppler(
    rx,
    tx,
    window: Optional[str] = None,
    doppler_window: Optional[str] = "hann",
    normalize: bool = True,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Range–Doppler map of a coherent pulse train (…, n_pulses, N):
    pulse compression along fast time, then a tapered, fftshifted FFT
    along slow time.  Output (…, n_pulses, N−Nt+1) with Doppler bin 0
    (zero radial velocity) at row n_pulses//2 and delay 0 at column 0.

    ``doppler_window`` tapers slow time (coherent-gain normalized so a
    steady unit echo keeps unit peak); ``window``/``normalize`` pass to
    :func:`pulse_compression`.
    """
    from .fft import fft as _fft, fftshift as _fftshift
    from .stft import get_window

    rx = jnp.asarray(rx)
    if rx.ndim < 2:
        raise ValueError("range_doppler needs (…, n_pulses, n_samples)")
    y = pulse_compression(
        rx, tx, window=window, normalize=normalize, config=config
    )
    m = y.shape[-2]
    if doppler_window is not None:
        w = np.asarray(get_window(doppler_window, m), np.float64)
        w = w / w.sum()  # coherent gain 1 for a DC (zero-Doppler) echo
    else:
        w = np.full(m, 1.0 / m)
    y = y * jnp.asarray(w, jnp.real(y).dtype)[:, None]
    Y = _fft(y, axis=-2, config=config)
    return _fftshift(Y, axes=-2)


def _win_sum(v, axis: int, half: int):
    """Centered (2·half+1)-wide sliding sum along ``axis``, zeros beyond
    the edges — zero-pad, cumulative sum, two static slices (no gathers)."""
    w = 2 * half + 1
    pad = [(0, 0)] * v.ndim
    pad[axis] = (half, half)
    vp = jnp.pad(v, pad)
    c = jnp.cumsum(vp, axis=axis)
    zshape = list(vp.shape)
    zshape[axis] = 1
    c0 = jnp.concatenate([jnp.zeros(zshape, v.dtype), c], axis=axis)
    hi = jax.lax.slice_in_dim(c0, w, w + v.shape[axis], axis=axis)
    lo = jax.lax.slice_in_dim(c0, 0, v.shape[axis], axis=axis)
    return hi - lo


def _box_sum(p, half: int, axes):
    """Sum of p over a centered (2·half+1)-wide box along each axis in
    ``axes`` plus the (broadcastable, host-derived) count of in-bounds
    cells at each position."""
    s = p
    cnt = jnp.ones((), p.dtype)
    for a in axes:
        a = a % p.ndim
        s = _win_sum(s, a, half)
        n = p.shape[a]
        i = np.arange(n)
        c1 = np.minimum(i + half, n - 1) - np.maximum(i - half, 0) + 1
        shape = [1] * p.ndim
        shape[a] = n
        cnt = cnt * jnp.asarray(c1.reshape(shape), p.dtype)
    return s, cnt


def _os_alpha(n: int, k: int, pfa: float) -> float:
    """OS-CFAR threshold factor: the root of
    ∏_{i=0}^{k−1} (n−i)/(n−i+α) = pfa (square-law noise, Rohling 1983) —
    host-side bisection, plan-time scalar."""
    idx = np.arange(k, dtype=np.float64)

    def f(a):
        return np.sum(np.log(n - idx) - np.log(n - idx + a)) - np.log(pfa)

    lo, hi = 0.0, 4.0
    while f(hi) > 0:
        hi *= 2.0
        if hi > 1e12:  # pragma: no cover - pfa astronomically small
            break
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if f(mid) > 0:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def _pfa_go_so(T: float, n: int, method: str) -> float:
    """Exact square-law false-alarm probability of GO/SO-CFAR with two
    half-windows of ``n`` exponential cells and threshold T·Z on the half
    SUMS (Hansen 1980 / Trunk 1978):
        Pfa_SO = 2 Σ_{k=0}^{n−1} C(n−1+k, k) (2+T)^{−(n+k)}
        Pfa_GO = 2 (1+T)^{−n} − Pfa_SO
    (their sum is the identity 2·Pfa_CA,half).  Log-space binomials keep
    n up to thousands finite."""
    k = np.arange(n, dtype=np.float64)
    logc = np.zeros(n)
    if n > 1:
        logc[1:] = np.cumsum(np.log(n - 1 + k[1:]) - np.log(k[1:]))
    so = 2.0 * float(np.sum(np.exp(logc - (n + k) * np.log(2.0 + T))))
    if method == "so":
        return so
    return 2.0 * (1.0 + T) ** (-n) - so


def _goso_alpha(n: int, pfa: float, method: str) -> float:
    """GO/SO threshold factor on the half-window MEAN: the root T of
    Pfa(T) = pfa (see :func:`_pfa_go_so`; monotone decreasing), scaled by
    n — host-side bisection, plan-time scalar (same pattern as
    :func:`_os_alpha`)."""
    lo, hi = 0.0, 4.0
    while _pfa_go_so(hi, n, method) > pfa:
        hi *= 2.0
        if hi > 1e12:  # pragma: no cover - pfa astronomically small
            break
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if _pfa_go_so(mid, n, method) > pfa:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi) * n


def cfar(
    power,
    num_train: int = 8,
    num_guard: int = 2,
    pfa: float = 1e-4,
    method: str = "ca",
    axes: Optional[Tuple[int, ...]] = None,
    rank: Optional[int] = None,
) -> Tuple[Array, Array]:
    """Constant-false-alarm-rate detection on a square-law ``power`` map.

    Training cells are the ``num_train`` cells per side beyond
    ``num_guard`` guard cells around each cell under test, along the last
    axis (1-D) or the last two axes (pass ``axes=(-2, -1)`` for
    range–Doppler maps; the training region is then the box ring).
    Near edges the out-of-bounds cells are dropped and the estimate
    renormalizes over the cells that exist.

    ``method``: "ca" cell-averaging, "go" greatest-of, "so" smallest-of
    (leading/lagging split — 1-D only), or "os" order-statistic (1-D:
    the ``rank``-th smallest of the 2·num_train training cells, default
    rank = ⌈3N/4⌉ — robust at clutter edges and in multi-target
    neighborhoods; edges are reflect-padded so every cell sees a full
    window, and the device work is one static-slice stack + sort).  The
    threshold factor is the exact square-law calibration per method —
    α = Nt·(pfa^(−1/Nt)−1) for "ca", the Hansen/Trunk GO/SO equations
    solved by host bisection for "go"/"so" (so the ``pfa`` argument is
    the ACTUAL false-alarm rate, not the CA approximation), Rohling's
    product equation for "os".  Edge cells renormalize over the in-bounds
    training cells, which keeps "ca" exact there but is approximate for
    "go"/"so" (calibrated for the full ``num_train``-per-side window).
    Returns ``(detections, threshold)`` — a boolean map and the per-cell
    threshold.
    """
    p = jnp.asarray(power)
    if jnp.issubdtype(p.dtype, jnp.complexfloating):
        raise ValueError("cfar expects a real power map (|x|²), got complex")
    p = p.astype(jnp.result_type(p.dtype, jnp.float32))
    t, g = int(num_train), int(num_guard)
    if t < 1:
        raise ValueError(f"num_train must be >= 1, got {t}")
    if g < 0:
        raise ValueError(f"num_guard must be >= 0, got {g}")
    if not 0.0 < pfa < 1.0:
        raise ValueError(f"pfa must be in (0, 1), got {pfa}")
    if method not in ("ca", "go", "so", "os"):
        raise ValueError(
            f"method must be 'ca', 'go', 'so' or 'os', got {method!r}"
        )
    axes = (-1,) if axes is None else tuple(int(a) for a in axes)
    if len(axes) not in (1, 2):
        raise ValueError("cfar supports 1-D or 2-D training regions")
    if len(axes) == 2 and method != "ca":
        raise ValueError("go/so/os CFAR is 1-D only")
    for a in axes:
        if p.shape[a] < 2 * (t + g) + 1:
            raise ValueError(
                f"axis {a} ({p.shape[a]} cells) shorter than the CFAR "
                f"window {2 * (t + g) + 1}"
            )

    if method == "os":
        ax = axes[0] % p.ndim
        n_cells = 2 * t
        k = int(rank) if rank is not None else max(
            1, int(np.ceil(0.75 * n_cells))
        )
        if not 1 <= k <= n_cells:
            raise ValueError(
                f"rank must be in [1, {n_cells}], got {k}"
            )
        padw = [(0, 0)] * p.ndim
        padw[ax] = (t + g, t + g)
        pp = jnp.pad(p, padw, mode="reflect")
        offs = list(range(0, t)) + list(range(t + 2 * g + 1, 2 * t + 2 * g + 1))
        n = p.shape[ax]
        win = jnp.stack(
            [jax.lax.slice_in_dim(pp, o, o + n, axis=ax) for o in offs],
            axis=-1,
        )  # (…, 2t) training cells per CUT
        noise = jnp.sort(win, axis=-1)[..., k - 1]
        thresh = float(_os_alpha(n_cells, k, pfa)) * noise
        return p > thresh, thresh

    if len(axes) == 1 and method in ("go", "so"):
        ax = axes[0] % p.ndim
        # leading / lagging training sums via shifted cumsums: the
        # window offsets are host-static, so the segment sums are two
        # static slices of a zero-padded cumulative sum each
        n = p.shape[ax]
        i = np.arange(n)
        shp = [1] * p.ndim
        shp[ax] = n
        c = jnp.cumsum(p, axis=ax)
        zshape = list(p.shape)
        zshape[ax] = t + g + 1  # left zero block covers the deepest reach
        c0 = jnp.concatenate(
            [jnp.zeros(zshape, p.dtype), c], axis=ax
        )  # c0[j + t + g + 1] = Σ p[:j+1]
        pad_hi = [(0, 0)] * p.ndim
        pad_hi[ax] = (0, t + g)
        c0 = jnp.pad(c0, pad_hi, mode="edge")  # right reach saturates

        def seg(lo_off: int, hi_off: int):
            # Σ p[i+lo_off : i+hi_off+1] for every i, edges clipped
            base = t + g  # c0 index of Σ p[:i] at i=0
            s_hi = jax.lax.slice_in_dim(
                c0, base + hi_off + 1, base + hi_off + 1 + n, axis=ax
            )
            s_lo = jax.lax.slice_in_dim(
                c0, base + lo_off, base + lo_off + n, axis=ax
            )
            cnt = (
                np.minimum(i + hi_off, n - 1) - np.maximum(i + lo_off, 0) + 1
            ).clip(min=0)
            return s_hi - s_lo, jnp.asarray(
                cnt.reshape(shp).astype(np.float64), p.dtype
            )

        s_lead, c_lead = seg(-g - t, -g - 1)
        s_lag, c_lag = seg(g + 1, g + t)
        m_lead = s_lead / jnp.maximum(c_lead, 1.0)
        m_lag = s_lag / jnp.maximum(c_lag, 1.0)
        # a side with no in-bounds cells defers to the other side
        m_lead = jnp.where(c_lead > 0, m_lead, m_lag)
        m_lag = jnp.where(c_lag > 0, m_lag, m_lead)
        noise = (
            jnp.maximum(m_lead, m_lag) if method == "go"
            else jnp.minimum(m_lead, m_lag)
        )
        thresh = float(_goso_alpha(t, pfa, method)) * noise
        return p > thresh, thresh
    else:
        # CA: full (train+guard) box sum minus the guard box sum
        outer_s, outer_c = _box_sum(p, t + g, axes)
        if g > 0:
            inner_s, inner_c = _box_sum(p, g, axes)
        else:
            inner_s, inner_c = p, jnp.ones_like(p)
        ring_s = outer_s - inner_s
        ring_c = (outer_c - inner_c).astype(p.dtype)
        ring_c = jnp.broadcast_to(ring_c, p.shape)
        noise = ring_s / jnp.maximum(ring_c, 1.0)
        n_train = ring_c
    # square-law CFAR calibration with the per-cell true training count
    alpha = n_train * (pfa ** (-1.0 / n_train) - 1.0)
    thresh = alpha * noise
    return p > thresh, thresh
