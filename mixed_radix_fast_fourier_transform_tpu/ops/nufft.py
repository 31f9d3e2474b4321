"""Non-uniform FFTs (NUFFT types 1, 2, 3).

Capability extension beyond the reference C library (uniform grids only):
transforms between non-equispaced sample points and regular Fourier modes,
the workhorse of MRI reconstruction, radio astronomy and particle codes.

Conventions (FINUFFT-style, centered modes k = -N//2 … (N-1)//2):

    type 1 (nonuniform -> modes):   f[k] = sum_j c[j] e^{isign·i·k·x[j]}
    type 2 (modes -> nonuniform):   c[j] = sum_k f[k] e^{isign·i·k·x[j]}
    type 3 (nonuniform -> arbitrary frequencies):
                                    f[i] = sum_j c[j] e^{isign·i·s[i]·x[j]}

defaults isign=-1 for type 1 / type 3 (forward-like, matching this library's
FFT sign) and isign=+1 for type 2 (synthesis-like).  For equispaced
x[j] = 2*pi*j/N, type 1 with isign=-1 reduces to fftshift(fft(c)).

Two execution strategies, selected by ``method``:

* ``"dense"`` — the exact NUDFT as one complex matmul.  O(N·M)
  flops, but that is precisely the shape a matrix unit wants: for the small /
  medium problems where the matrix fits comfortably (the ``"auto"``
  threshold), the dense matmul is both exact and fastest.  Phases are
  computed with an error-free fp32 reduction (Veltkamp-split head+tail of
  x/2pi, then an exact int32 k·round(u·4096) mod split — see _unit_frac /
  _phase_trig) so phase-factor error stays ~2.6e-6 even at k ~ 32768 — the
  runtime-point analogue of the library's exact integer twiddle phase
  reduction (CLAUDE.md conventions).
* ``"grid"`` — Gaussian gridding (Dutt-Rokhlin; Greengard & Lee, SIAM Rev
  2004): spread each point onto 2·msp neighbouring cells of a sigma=2
  oversampled grid, run the library's uniform FFT, and deconvolve by the
  kernel's transform sqrt(4·pi·tau)·e^{-k^2·tau}.  Spreading is
  **scatter-free**: per-point local tap images contract against a
  (point -> grid block) one-hot matrix as matmuls and overlapping block
  halos fold back with static rolls (:func:`_block_local` /
  :func:`_halo_to_grid`), replacing a scatter-add.  O(M·msp + sigma·N·log N)
  — the large-scale path.  tau = pi·msp/(N^2·sigma·(sigma-0.5)); measured
  accuracy (fp64 prototype): msp 4 -> 7e-5, 6 -> 1.5e-6, 8 -> 1.4e-8
  relative.

Everything is jittable, batched over leading axes of the strengths/modes,
and differentiable (both paths are jnp compositions; the scatter/gather
pair is the linear adjoint pair).
"""

from __future__ import annotations

import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.config import DEFAULT_CONFIG, SpectralConfig
from ..utils.factorize import next_pow2
from .fft import fft, fft2, ifft, ifft2

Array = jax.Array

_TWO_PI = 2.0 * math.pi
# dense phase split: u = x/2pi rounded to 1/_SPLIT; k*_SPLIT*u exact in int32
_SPLIT = 4096
# auto method thresholds: dense matmul up to this many matrix entries
# (1-D 2^20, 2-D 2^27, 3-D 2^24).  Inherited crossovers from the library's
# first accelerator, not measured on the H100 (ROADMAP S7).
_DENSE_MAX_ENTRIES = 1 << 20
_DENSE_MAX_ENTRIES_2D = 1 << 27
_DENSE_MAX_ENTRIES_3D = 1 << 24


def _centered_modes(n: int) -> np.ndarray:
    return np.arange(-(n // 2), (n + 1) // 2)


# 1/(2*pi) as three fp32 pieces (8-9 significant bits each + residual) so the
# runtime products below stay exact in fp32 — prepared host-side in fp64.
_INV2PI = 1.0 / _TWO_PI
_C_HI = np.float32(int(_INV2PI * 2**11) / 2**11)
_C_MID = np.float32(int((_INV2PI - float(_C_HI)) * 2**19) / 2**19)
_C_LO = np.float32(_INV2PI - float(_C_HI) - float(_C_MID))


# Error-free transforms (Veltkamp split, Knuth two-sum) from the canonical
# shared set in utils/numerics.
from ..utils.numerics import two_sum as _twosum, veltkamp as _veltkamp


def _unit_frac(x: Array):
    """frac(x / 2pi) as a head+tail fp32 pair accurate to ~2^-40.

    fp32 cannot hold x/2pi accurately enough for mode numbers k ~ 2^15 (the
    single rounding costs k·2pi·2^-24 ~ 1e-2 radians of phase).  Splitting x
    (Veltkamp, twice) and 1/2pi (host constants) into 8-bit-mantissa pieces
    makes every significant product exact; a TwoSum chain keeps the head+tail
    sum error-free.  Measured: |u - x/2pi| < 1e-12, phase-factor error
    2.6e-6 at N = 65536 (vs ~1e-2 naive fp32)."""
    x = jnp.asarray(x)
    xh, r1 = _veltkamp(x)
    xm, xl = _veltkamp(r1)
    ch = jnp.asarray(_C_HI, x.dtype)
    cm = jnp.asarray(_C_MID, x.dtype)
    cl = jnp.asarray(_C_LO, x.dtype)
    small = (xh * cl + xm * cm) + (xm * cl + xl * jnp.asarray(_INV2PI, x.dtype))
    s, e1 = _twosum(xh * ch, xh * cm)
    s, e2 = _twosum(s, xm * ch)
    u_hi, u_lo = s, (e1 + e2) + small
    # drop the integer part (k is integer, frac(k·u) == frac(k·frac(u)))
    w = jnp.floor(u_hi + u_lo)
    return u_hi - w, u_lo  # u_hi now in [-eps, 1+eps]; subtraction exact


def _phase_trig(k: np.ndarray, x: Array, isign: int):
    """(cos, sin) of isign·k·x via exact integer phase reduction.

    ``k`` is a host integer array (modes); ``x`` is a traced point array.
    u = frac(x/2pi) is carried as a head+tail pair (_unit_frac); the head is
    split at 1/4096 so k·round(u·4096) reduces exactly in int32 and only the
    small residual k·lo is floating — the runtime-point analogue of the
    library's exact twiddle phase reduction.  |k| must stay below 2^16
    (n_modes <= 131071; the auto dispatchers route larger sizes to the grid
    path).  Returns arrays of shape (len(k),) + x.shape."""
    if np.abs(k).max(initial=0) >= 1 << 16:
        raise ValueError("dense NUFFT phase reduction supports |k| < 65536")
    u_hi, u_lo = _unit_frac(x)
    m = jnp.round(u_hi * _SPLIT)
    lo = (u_hi - m / _SPLIT) + u_lo  # |.| <= 2^-13 (+tail), exact subtract
    mi = m.astype(jnp.int32)
    kj = jnp.asarray(k.astype(np.int32))
    kshape = (-1,) + (1,) * u_hi.ndim
    km = jnp.mod(kj.reshape(kshape) * mi[None], _SPLIT)  # exact in int32
    theta = _TWO_PI * (
        km.astype(u_hi.dtype) / _SPLIT
        + kj.reshape(kshape).astype(u_hi.dtype) * lo
    )
    if isign < 0:
        theta = -theta
    return jnp.cos(theta), jnp.sin(theta)


def nudft1(
    x,
    c,
    n_modes: int,
    *,
    isign: int = -1,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Exact type-1 NUDFT as a dense matmul: (…, M) -> (…, n_modes)."""
    x = jnp.asarray(x)
    c = jnp.asarray(c)
    if x.ndim != 1 or x.shape[0] < 1:
        raise ValueError("x must be a non-empty 1-D point array")
    if c.shape[-1] != x.shape[0]:
        raise ValueError(
            f"strengths last axis {c.shape[-1]} != number of points {x.shape[0]}"
        )
    if n_modes < 1:
        raise ValueError(f"n_modes must be >= 1, got {n_modes}")
    k = _centered_modes(n_modes)
    cos, sin = _phase_trig(k, x, isign)  # (N, M)
    cr = jnp.real(c).astype(cos.dtype)
    ci = jnp.imag(c).astype(cos.dtype)
    p = config.op_precision
    fr = jnp.einsum("km,...m->...k", cos, cr, precision=p) - jnp.einsum(
        "km,...m->...k", sin, ci, precision=p
    )
    fi = jnp.einsum("km,...m->...k", sin, cr, precision=p) + jnp.einsum(
        "km,...m->...k", cos, ci, precision=p
    )
    return jax.lax.complex(fr, fi)


def nudft2(
    x,
    f,
    *,
    isign: int = +1,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Exact type-2 NUDFT as a dense matmul: (…, n_modes) -> (…, M)."""
    x = jnp.asarray(x)
    f = jnp.asarray(f)
    if x.ndim != 1 or x.shape[0] < 1:
        raise ValueError("x must be a non-empty 1-D point array")
    if f.shape[-1] < 1:
        raise ValueError("f must be non-empty along the mode axis")
    k = _centered_modes(f.shape[-1])
    cos, sin = _phase_trig(k, x, isign)  # (N, M)
    fr = jnp.real(f).astype(cos.dtype)
    fi = jnp.imag(f).astype(cos.dtype)
    p = config.op_precision
    cr = jnp.einsum("km,...k->...m", cos, fr, precision=p) - jnp.einsum(
        "km,...k->...m", sin, fi, precision=p
    )
    ci = jnp.einsum("km,...k->...m", sin, fr, precision=p) + jnp.einsum(
        "km,...k->...m", cos, fi, precision=p
    )
    return jax.lax.complex(cr, ci)


def _msp(eps: float) -> int:
    """Taps per side from the measured accuracy ladder (module docstring):
    err ~ 10^-(0.91*msp + 0.5) — the single source for every Gaussian path."""
    return int(min(16, max(4, math.ceil((-math.log10(eps) - 0.5) / 0.91) + 1)))


def _grid_params(n_modes: int, eps: float):
    # Power-of-two oversampled grid (>= 2x): u_hi * mr is then EXACT in fp32
    # (pure exponent shift), so the head+tail point representation survives
    # the map to grid coordinates — without this, fp32 cell-position error
    # (~x·2^-24 / h) rounds results at the k_max·2pi·2^-24 ~ 1e-4 level for
    # n_modes ~ 4096 (seen before the fix).  Pow2 is also the
    # engine's best-planned FFT length.
    mr = 1 << (2 * n_modes - 1).bit_length()
    sigma = mr / n_modes
    msp = _msp(eps)
    tau = math.pi * msp / (n_modes * n_modes * sigma * (sigma - 0.5))
    return mr, tau, msp


def _anchor_weights(x: Array, mr: int, tau: float, msp: int):
    """Anchor cells i0 (M,, unwrapped) and Gaussian tap weights (M, 2msp) —
    the shared geometry core of the scatter/block/sorted spreading paths.

    Grid coordinates ride the _unit_frac head+tail pair: xi_hi = u_hi·mr is
    exact (mr is a power of two), the nearby-integer subtraction against the
    tap index is exact (Sterbenz), and only the ~2^-40 tail is approximate —
    so tap distances carry no fp32 position-quantization error."""
    u_hi, u_lo = _unit_frac(x)
    xi_hi = u_hi * mr  # exact: mr is a power of two
    xi_lo = u_lo * mr
    i0 = jnp.floor(xi_hi + xi_lo).astype(jnp.int32)
    taps = np.arange(-msp + 1, msp + 1, dtype=np.int32)
    idx = i0[:, None] + taps[None, :]
    h = _TWO_PI / mr
    dist_cells = (xi_hi[:, None] - idx.astype(xi_hi.dtype)) + xi_lo[:, None]
    dist = dist_cells * jnp.asarray(h, xi_hi.dtype)
    w = jnp.exp(-(dist * dist) / (4.0 * tau))
    return i0, w


def _spread_geometry(x: Array, mr: int, tau: float, msp: int):
    """Common spreading/interpolation geometry: indices (M, 2msp) into the
    oversampled grid (wrapped) and Gaussian weights exp(-d^2/(4 tau))."""
    i0, w = _anchor_weights(x, mr, tau, msp)
    taps = np.arange(-msp + 1, msp + 1, dtype=np.int32)
    return jnp.mod(i0[:, None] + taps[None, :], mr), w


def _use_dense(
    method: str, n_entries: int, max_modes: int,
    limit: int = _DENSE_MAX_ENTRIES,
) -> bool:
    """Dense-vs-grid dispatch: dense needs the matrix to fit the measured
    crossover budget AND the phase reduction's |k| < 2^16 bound
    (n_modes <= 131071).  Explicit method='dense' is always honored
    (``_phase_trig`` raises a clear error past the |k| bound)."""
    if method == "dense":
        return True
    return (
        method == "auto"
        and n_entries <= limit
        and max_modes // 2 < (1 << 16)
    )


def _use_dense_2d(method: str, n1: int, n2: int, m: int) -> bool:
    """2-D variant: the chained-contraction dense path touches
    O(max(n1,n2)·M) intermediates and O(n1·n2·M) flops."""
    if method == "dense":
        return True
    return (
        method == "auto"
        and n1 * n2 * m <= _DENSE_MAX_ENTRIES_2D
        and max(n1, n2) * m <= _DENSE_MAX_ENTRIES_2D // 8
        and max(n1, n2) // 2 < (1 << 16)
    )


def _infer_axis(pts):
    """(half-width, center) of a CONCRETE point set, or None under jit.
    The ONE copy of the type-3 span inference — the auto dispatch
    (:func:`_type3_extent`) and the fast paths' ``_axis_setup`` both
    resolve extents through here, so the cost model always sizes the same
    grid the fast path builds."""
    try:
        ph = np.asarray(pts)
    except Exception:  # traced under jit without a static extent
        return None
    return (
        max(float((ph.max() - ph.min()) / 2.0), 1e-9),
        float((ph.max() + ph.min()) / 2.0),
    )


def _type3_extent(pts, ext):
    """Resolve one half-width for the type-3 auto dispatch: the given
    static extent, the concrete points' span, or None under jit (the
    caller then falls back to dense — same information the 'fast' method
    would have demanded anyway)."""
    if ext is not None:
        return float(ext)
    inf = _infer_axis(pts)
    return None if inf is None else inf[0]


def _fast_axis_setup(pts, ext, ctr, label):
    """Per-axis (half-width, center) for a type-3 fast path: the static
    values when given, else the concrete span (raises under jit — the
    fast grids need static sizes)."""
    if ext is None:
        inf = _infer_axis(pts)
        if inf is None:
            raise ValueError(
                f"{label} under jit needs static extent half-widths "
                "(about centers)"
            )
        return inf
    return float(ext), float(ctr)


def _type3_fast_wins(eps: float, d: int, m: int, k: int, sx) -> bool:
    """Cost-model dispatch for the type-3 family's method='auto'.

    The Lee-Greengard fast path's work is set by the SPACE-BANDWIDTH
    products S·X per axis (inner mode counts n_i ≈ 2σ·S·X/π), NOT by M or
    K — so at large S·X it loses to the dense (K, M) phase matmul by
    orders of magnitude (at M=K=4096 with S·X = 1024π per axis the inner
    grid is ~16384²), while at large M·K with modest S·X the dense matrix does not
    even fit (M=K=65536 → 4.3e9 entries) and fast runs in ms.  Model:
      dense ≈ 30·K·M   (two trig sweeps + 8 matmul flops per entry)
      fast  ≈ 10·G·log2 G + 100·(M+K)·(2·msp)^d
    with G the pow2-padded 2x-oversampled inner grid cells.  The regimes
    this chooses between differ by 10-100x, so constant-level modeling
    error cannot flip a sane choice."""
    sigma = 2.0
    msp = _msp(eps)
    g = 1.0
    for p in sx:  # per-axis product S_i · X_i
        n_i = 2 * (int(math.ceil(sigma * p / math.pi)) + msp + 3) + 1
        g *= float(next_pow2(2 * n_i))
    fast = 10.0 * g * math.log2(max(g, 2.0)) + 100.0 * (m + k) * float(
        (2 * msp) ** d
    )
    dense = 30.0 * float(m) * float(k)
    return fast < dense


def _deconv(n_modes: int, mr: int, tau: float) -> np.ndarray:
    """Gaussian-kernel deconvolution diagonal: h/(2·sqrt(pi·tau))·e^{k²tau}
    for the centered modes (host fp64 — the single source of truth shared by
    the local and sharded grid paths)."""
    k = _centered_modes(n_modes).astype(np.float64)
    return (_TWO_PI / mr / (2.0 * math.sqrt(math.pi * tau))) * np.exp(
        k * k * tau
    )


# Grid cells per block in the matmul spreading path.  Each point's 2·msp
# taps land in a window of Ls = block + 2·msp − 1 cells anchored at its
# block, so spreading becomes (point → block) one-hot matmuls instead of
# a scatter-add, whose cost grows with M.
_SPREAD_BLOCK = 32
# Point-chunk of the scanned one-hot contractions: bounds the live
# (chunk, nb) one-hot and (chunk, ΠLs) local-image footprint at large M.
# The actual chunk adapts to the local-image volume (_chunk_for) so a 3-D
# Ls^3 image gets proportionally smaller chunks than a 1-D Ls image.
_POINT_CHUNK = 4096


def _chunk_for(lflat: int) -> int:
    """Points per scan chunk: targets ~4M live local-image elements."""
    return max(256, min(_POINT_CHUNK, (1 << 22) // max(1, lflat)))
# Per-axis block-count caps: bound the one-hot width (nb = Π mr_i/s_i) and
# the halo overhead (Π((s_i+2msp-1)/s_i) x grid) for very large grids.
_MAX_BLOCKS = {1: 512, 2: 128, 3: 8}


def _block_size(mr: int, base: int, ndim: int) -> int:
    """Power-of-two block size: at least ``base`` cells per block, at most
    ``_MAX_BLOCKS[ndim]`` blocks per axis."""
    return min(mr, max(base, next_pow2(-(-mr // _MAX_BLOCKS[ndim]))))


def _chunk_outer(factors, cc):
    """Per-point separable local image: cc[…, m] · Π_k factors[k][m, l_k],
    flattened over the local axes -> (…, m, ΠLs)."""
    ab = factors[0]
    for fk in factors[1:]:
        fk_exp = fk.reshape((fk.shape[0],) + (1,) * (ab.ndim - 1) + (fk.shape[-1],))
        ab = ab[..., None] * fk_exp
    ab = ab.reshape(ab.shape[0], -1)
    return cc[..., :, None] * ab.astype(cc.real.dtype)


def _spread_blocks(factors, c, bc, nb: int):
    """halo[…, b, L] = Σ_m c[…, m] · Π_k factors[k][m, ·] · [bc[m] == b],
    with the local axes flattened to L = ΠLs_k.  Chunked over points under
    ``lax.scan`` when M > _POINT_CHUNK — the (chunk, nb) one-hot is built
    per chunk from the int block ids ``bc``, so neither it nor the local
    images ever materialize at full M.  All contractions run HIGHEST (see
    :func:`_block_local`)."""
    m = bc.shape[0]
    dt = c.real.dtype
    blocks = np.arange(nb)
    lflat = int(np.prod([f.shape[-1] for f in factors]))
    chunk = _chunk_for(lflat)

    def onehot(ids):
        return (ids[:, None] == blocks[None, :]).astype(dt)

    if m <= chunk:
        ab = _chunk_outer(factors, c)
        return jnp.einsum(
            "...ml,mb->...bl", ab, onehot(bc), precision="highest"
        )
    pad = (-m) % chunk
    if pad:
        factors = [jnp.pad(f, [(0, pad), (0, 0)]) for f in factors]
        bc = jnp.pad(bc, [(0, pad)])
        c = jnp.pad(c, [(0, 0)] * (c.ndim - 1) + [(0, pad)])
    nc = (m + pad) // chunk

    def resh(v):
        return v.reshape((nc, chunk) + v.shape[1:])

    cs = jnp.moveaxis(c.reshape(c.shape[:-1] + (nc, chunk)), -2, 0)
    acc0 = jnp.zeros(c.shape[:-1] + (nb, lflat), c.dtype)

    def body(acc, args):
        ids = args[0]
        cc = args[1]
        fs = args[2:]
        ab = _chunk_outer(list(fs), cc)
        return acc + jnp.einsum(
            "...ml,mb->...bl", ab, onehot(ids), precision="highest"
        ), None

    halo, _ = jax.lax.scan(
        body, acc0, (resh(bc), cs) + tuple(resh(f) for f in factors)
    )
    return halo


def _interp_blocks(factors, halo_flat, bc, nb: int):
    """out[…, m] = Σ_L halo[…, bc[m], L] · Π_k factors[k][m, ·] — the
    adjoint of :func:`_spread_blocks`, chunked the same way (per-chunk
    one-hots from the int block ids)."""
    m = bc.shape[0]
    blocks = np.arange(nb)
    dt = halo_flat.real.dtype
    lflat = halo_flat.shape[-1]
    chunk = _chunk_for(lflat)

    def one(ids, fs):
        ohc = (ids[:, None] == blocks[None, :]).astype(dt)
        vals = jnp.einsum(
            "...bl,mb->...ml", halo_flat, ohc, precision="highest"
        )
        vals = vals.reshape(vals.shape[:-1] + tuple(f.shape[-1] for f in fs))
        # contract local axes innermost-first: (…, m, L1..Lk) x (m, Lk)
        for k in range(len(fs), 0, -1):
            f = fs[k - 1].astype(dt)
            f_exp = f.reshape((f.shape[0],) + (1,) * (k - 1) + (f.shape[-1],))
            vals = (vals * f_exp).sum(axis=-1)
        return vals

    if m <= chunk:
        return one(bc, factors)
    pad = (-m) % chunk
    bcp = jnp.pad(bc, [(0, pad)]) if pad else bc
    fps = [
        jnp.pad(f, [(0, pad), (0, 0)]) if pad else f for f in factors
    ]
    nc = (m + pad) // chunk

    def resh(v):
        return v.reshape((nc, chunk) + v.shape[1:])

    def body(carry, args):
        return carry, one(args[0], args[1:])

    _, ys = jax.lax.scan(
        body, 0, (resh(bcp),) + tuple(resh(f) for f in fps)
    )  # ys: (nc, …, C)
    vals = jnp.moveaxis(ys, 0, -2)
    vals = vals.reshape(vals.shape[:-2] + (nc * chunk,))
    return vals[..., :m]


def _block_local(x: Array, mr: int, tau: float, msp: int, s: int):
    """Per-point block id and dense local tap image for matmul spreading.

    Splits the length-``mr`` circular grid into ``mr // s`` blocks.  Point j
    with anchor cell i0_j (mod mr) belongs to block b_j = i0m_j // s; its
    2·msp Gaussian taps live at local offsets l = (i0m_j − b_j·s) + t + msp−1
    ∈ [0, Ls) with Ls = s + 2·msp − 1.  Returns (b, A): b (M,) int32 block
    ids and A (M, Ls) local tap images (the Gaussian weights placed by a
    one-hot contraction — run at precision HIGHEST: a one-hot operand makes
    the products trivially exact, but anything below HIGHEST still
    truncates the DATA operand's bf16 chunks — XLA's HIGH drops its third
    chunk, a measured ~1e-5-class error, so HIGHEST is required for the
    fp32-exact contraction).

    Tap distances use the unwrapped head+tail geometry of
    :func:`_anchor_weights` (exact Sterbenz subtraction against the
    integer tap index; only the ~2^-40 tail is approximate)."""
    i0, w = _anchor_weights(x, mr, tau, msp)
    taps = np.arange(-msp + 1, msp + 1, dtype=np.int32)
    i0m = jnp.mod(i0, mr)
    b = i0m // s
    off = i0m - b * s
    ls = s + 2 * msp - 1
    oh = (
        off[:, None, None] + (taps[None, :, None] + (msp - 1))
        == np.arange(ls)[None, None, :]
    )
    a = jnp.einsum("mt,mtl->ml", w, oh.astype(w.dtype), precision="highest")
    return b, a


def _halo_to_grid(halo: Array, s: int, msp: int, mr: int) -> Array:
    """Fold (…, nb, Ls) overlapping halo blocks into the circular length-mr
    grid over the last axis pair.  Block b's local cell l is grid cell
    b·s + l − (msp−1) (mod mr): the central s cells reshape straight into
    the grid, the msp−1 cells on each side spill into the neighbouring
    blocks via static pad+roll — no scatter anywhere."""
    main = halo[..., :, msp - 1 : msp - 1 + s]
    flat = main.shape[:-2] + (mr,)
    grid = main.reshape(flat)
    pad = [(0, 0)] * (halo.ndim - 1)
    if msp > 1:  # backward spill: local l < msp−1, grid cells b·s−msp+1…b·s−1
        back = jnp.pad(halo[..., :, : msp - 1], pad + [(s - msp + 1, 0)])
        grid = grid + jnp.roll(back.reshape(flat), -s, axis=-1)
    # forward spill: local l >= msp−1+s (width msp), grid cells (b+1)·s…+msp−1
    fwd = jnp.pad(halo[..., :, msp - 1 + s :], pad + [(0, s - msp)])
    return grid + jnp.roll(fwd.reshape(flat), s, axis=-1)


def _spread_scatter_small(x, c, mr, tau, msp) -> Array:
    """Scatter-add fallback for grids too small for the block-matmul path
    (mr < msp would spill past one neighbouring block); only reachable for
    toy n_modes where the cost is irrelevant."""
    idx, w = _spread_geometry(x, mr, tau, msp)
    vals = w.astype(c.real.dtype) * c[..., :, None]
    grid = jnp.zeros(c.shape[:-1] + (mr,), dtype=vals.dtype)
    return grid.at[..., idx.reshape(-1)].add(
        vals.reshape(vals.shape[:-2] + (-1,)), mode="promise_in_bounds"
    )


# ---------------------------------------------------------------------------
# Sorted-segment spreading: an alternative O(M·log M + msp·(M + mr)) engine.
# Points are sorted by anchor cell once; for each of the 2·msp tap offsets
# the per-cell sums are segment sums over the sorted strengths — a
# double-word prefix sum plus an error-free boundary difference.  The cost
# is independent of the grid/block geometry, vs the block-matmul path's
# O(M·nb·Ls^d) matmul flops which grow with the block count at large grids.
#
# Auto-dispatch is DISABLED (thresholds below are "never"): on the
# library's first accelerator the block path won by ~20x; the sorted
# spreader has not been measured on the H100 (ROADMAP S7).  It stays as an
# opt-in (set _SORTED_MIN_M yourself) bounded-memory fallback and as the
# reference implementation the block path is tested against.
#
# fp32 NOTE: a plain cumsum-difference would lose ~M·eps relative accuracy
# (prefix magnitude ~M·mean vs O(segment) results); the (hi, lo) carry
# keeps prefixes ~eps² so the subtraction cancellation never reaches the
# result (measured: sorted == block path to ~5e-7 end-to-end at M=4·10^4).
# ---------------------------------------------------------------------------

_SORTED_NEVER = 1 << 62  # auto-dispatch disabled
_SORTED_MIN_M = _SORTED_NEVER
_SORTED_MIN_M_2D = _SORTED_NEVER


def _seg_sum_sorted(v: Array, si: Array, ei: Array) -> Array:
    """Segment sums Σ v[…, si[g]:ei[g]] along the last axis of real ``v``
    via a double-word (compensated) inclusive prefix scan: combine keeps a
    (hi, lo) pair per prefix, boundary differences TwoSum the hi words
    (error-free) so the O(prefix) magnitudes cancel exactly."""

    def comb(a, b):
        sh, se = _twosum(a[0], b[0])
        lo = se + a[1] + b[1]
        s = sh + lo
        return s, lo - (s - sh)

    z = jnp.zeros(v.shape[:-1] + (1,), v.dtype)
    vp = jnp.concatenate([z, v], axis=-1)
    hi, lo = jax.lax.associative_scan(comb, (vp, jnp.zeros_like(vp)), axis=-1)
    dh, de = _twosum(jnp.take(hi, ei, axis=-1), -jnp.take(hi, si, axis=-1))
    return dh + (de + (jnp.take(lo, ei, axis=-1) - jnp.take(lo, si, axis=-1)))


def _seg_sum_sorted_c(v: Array, si: Array, ei: Array) -> Array:
    if jnp.iscomplexobj(v):
        return jax.lax.complex(
            _seg_sum_sorted(jnp.real(v), si, ei),
            _seg_sum_sorted(jnp.imag(v), si, ei),
        )
    return _seg_sum_sorted(v, si, ei)


def _sorted_cells(cells_raw: Array, ncell: int):
    """Sort permutation over the int anchor cells plus the (ncell+1,)
    run-boundary array bnd (cell g occupies sorted slots bnd[g]:bnd[g+1])."""
    perm = jnp.argsort(cells_raw)
    cells = jnp.take(cells_raw, perm)
    bnd = jnp.searchsorted(
        cells, jnp.arange(ncell + 1, dtype=cells.dtype)
    ).astype(jnp.int32)
    return perm, bnd


def _spread_sorted(x: Array, c: Array, mr: int, tau: float, msp: int) -> Array:
    """1-D Gaussian spreading via sorted-cell segment sums (see the section
    comment): grid[g] = Σ_t segsum over points anchored at (g − t) mod mr of
    w_t·c — the boundary arrays for offset t are static rolls of bnd."""
    i0, w = _anchor_weights(x, mr, tau, msp)
    perm, bnd = _sorted_cells(jnp.mod(i0, mr), mr)
    ws = jnp.take(w, perm, axis=0)
    cs = jnp.take(c, perm, axis=-1).astype(
        c.dtype if jnp.iscomplexobj(c) else w.dtype
    )
    taps = np.arange(-msp + 1, msp + 1, dtype=np.int32)
    s0, e0 = bnd[:-1], bnd[1:]
    si = jnp.stack([jnp.roll(s0, int(t)) for t in taps])
    ei = jnp.stack([jnp.roll(e0, int(t)) for t in taps])

    def body(grid, xs):
        wt, sit, eit = xs
        return grid + _seg_sum_sorted_c(cs * wt.astype(cs.real.dtype), sit, eit), None

    grid0 = jnp.zeros(c.shape[:-1] + (mr,), cs.dtype)
    grid, _ = jax.lax.scan(body, grid0, (ws.T, si, ei))
    return grid


def _spread_sorted_2d(x, y, c, mrs, taus, msp: int) -> Array:
    """2-D sorted-segment spreading over the linearized anchor cell: one
    sort, then a scan over the (2msp)² tap-offset pairs; per pair the
    boundary arrays are the 2-D roll of bnd by the offset (traced shifts)."""
    mr1, mr2 = mrs
    i1, w1 = _anchor_weights(x, mr1, taus[0], msp)
    i2, w2 = _anchor_weights(y, mr2, taus[1], msp)
    lin = jnp.mod(i1, mr1) * mr2 + jnp.mod(i2, mr2)
    perm, bnd = _sorted_cells(lin, mr1 * mr2)
    w1s = jnp.take(w1, perm, axis=0)
    w2s = jnp.take(w2, perm, axis=0)
    cs = jnp.take(c, perm, axis=-1)
    taps = np.arange(-msp + 1, msp + 1, dtype=np.int32)
    t1, t2 = (a.reshape(-1) for a in np.meshgrid(taps, taps, indexing="ij"))
    k1, k2 = (
        a.reshape(-1)
        for a in np.meshgrid(
            np.arange(2 * msp), np.arange(2 * msp), indexing="ij"
        )
    )
    s0 = bnd[:-1].reshape(mr1, mr2)
    e0 = bnd[1:].reshape(mr1, mr2)

    def body(grid, xs):
        t1s, t2s, k1s, k2s = xs
        wt = jnp.take(w1s, k1s, axis=1) * jnp.take(w2s, k2s, axis=1)
        sit = jnp.roll(s0, (t1s, t2s), axis=(0, 1)).reshape(-1)
        eit = jnp.roll(e0, (t1s, t2s), axis=(0, 1)).reshape(-1)
        v = cs * wt.astype(cs.real.dtype)
        return grid + _seg_sum_sorted_c(v, sit, eit), None

    grid0 = jnp.zeros(c.shape[:-1] + (mr1 * mr2,), cs.dtype)
    grid, _ = jax.lax.scan(
        body, grid0,
        tuple(jnp.asarray(a, jnp.int32) for a in (t1, t2, k1, k2)),
    )
    return grid.reshape(c.shape[:-1] + (mr1, mr2))


def _spread(x: Array, c: Array, mr: int, tau: float, msp: int) -> Array:
    """Gaussian spreading of strengths ``c`` (…, M) onto the length-mr
    oversampled grid: block one-hot matmuls (see :func:`_block_local`), or
    sorted-segment sums past the measured point-count crossover."""
    s = _block_size(mr, _SPREAD_BLOCK, 1)
    if s < msp:  # spill would cross >1 block — tiny grid, scatter is fine
        return _spread_scatter_small(x, c, mr, tau, msp)
    if x.shape[0] >= _SORTED_MIN_M and mr >= 2 * msp:
        return _spread_sorted(x, c, mr, tau, msp)
    b, a = _block_local(x, mr, tau, msp, s)
    halo = _spread_blocks([a], c, b, mr // s)
    return _halo_to_grid(halo, s, msp, mr)


def _spread_2d(x, y, c, mrs, taus, msp: int) -> Array:
    """2-D Gaussian spreading as one block one-hot matmul: the separable
    per-point local images A1 ⊗ A2 (strengths folded in) contract against a
    combined (b1·nb2 + b2) block one-hot — O(M·nb·Ls²) work replacing
    the 4·msp²-taps-per-point scatter."""
    mr1, mr2 = mrs
    tau1, tau2 = taus
    s1 = _block_size(mr1, _SPREAD_BLOCK, 2)
    s2 = _block_size(mr2, _SPREAD_BLOCK, 2)
    if min(s1, s2) < msp:  # tiny grid: fall back to per-axis scatter
        idx1, w1 = _spread_geometry(x, mr1, tau1, msp)
        idx2, w2 = _spread_geometry(y, mr2, tau2, msp)
        vals = (
            (w1[:, :, None] * w2[:, None, :]).astype(c.real.dtype)
            * c[..., :, None, None]
        )
        flat = (idx1[:, :, None] * mr2 + idx2[:, None, :]).reshape(-1)
        grid = jnp.zeros(c.shape[:-1] + (mr1 * mr2,), dtype=vals.dtype)
        grid = grid.at[..., flat].add(
            vals.reshape(vals.shape[:-3] + (-1,)), mode="promise_in_bounds"
        )
        return grid.reshape(c.shape[:-1] + (mr1, mr2))
    if (
        x.shape[0] >= _SORTED_MIN_M_2D
        and min(mr1, mr2) >= 2 * msp
        and mr1 * mr2 < 1 << 31  # linearized cell ids must fit int32
    ):
        return _spread_sorted_2d(x, y, c, mrs, taus, msp)
    b1, a1 = _block_local(x, mr1, tau1, msp, s1)
    b2, a2 = _block_local(y, mr2, tau2, msp, s2)
    nb1, nb2 = mr1 // s1, mr2 // s2
    ls1, ls2 = a1.shape[-1], a2.shape[-1]
    halo = _spread_blocks([a1, a2], c, b1 * nb2 + b2, nb1 * nb2)
    halo = halo.reshape(halo.shape[:-2] + (nb1, nb2, ls1, ls2))
    # fold (nb1, Ls1) -> mr1, then (nb2, Ls2) -> mr2
    halo = jnp.moveaxis(halo, (-4, -2), (-2, -1))  # (…, nb2, Ls2, nb1, Ls1)
    part = _halo_to_grid(halo, s1, msp, mr1)  # (…, nb2, Ls2, mr1)
    part = jnp.moveaxis(part, -1, -3)  # (…, mr1, nb2, Ls2)
    return _halo_to_grid(part, s2, msp, mr2)  # (…, mr1, mr2)


def _spread_3d(x, y, z, c, mrs, taus, msp: int):
    """3-D Gaussian spreading as chunked block one-hot matmuls.

    Same scheme as :func:`_spread_2d` with a third axis and a smaller block
    base (s >= 8 per axis — the local image is Ls³ per point, so block size
    trades one-hot width against local-image volume; the per-axis block
    count is capped at _MAX_BLOCKS[3] so the halo stays a small multiple of
    the grid).  Structurally this does ~Π(1+2msp/s_i)-fold more arithmetic
    than the dense NUDFT, so it is the past-the-wall path; the auto dispatch keeps dense
    to 2^24 entries.  Returns None when the grid is too small for the
    block scheme (caller falls back to scatter)."""
    mr1, mr2, mr3 = mrs
    tau1, tau2, tau3 = taus
    base = max(8, next_pow2(msp))
    s1, s2, s3 = (_block_size(m, base, 3) for m in mrs)
    if min(s1, s2, s3) < msp:
        return None
    b1, a1 = _block_local(x, mr1, tau1, msp, s1)
    b2, a2 = _block_local(y, mr2, tau2, msp, s2)
    b3, a3 = _block_local(z, mr3, tau3, msp, s3)
    nb1, nb2, nb3 = mr1 // s1, mr2 // s2, mr3 // s3
    bc = (b1 * nb2 + b2) * nb3 + b3  # (M,)
    ls1, ls2, ls3 = a1.shape[-1], a2.shape[-1], a3.shape[-1]
    halo = _spread_blocks([a1, a2, a3], c, bc, nb1 * nb2 * nb3)
    halo = halo.reshape(
        halo.shape[:-2] + (nb1, nb2, nb3, ls1, ls2, ls3)
    )
    # fold (nb_i, Ls_i) -> mr_i, innermost first
    halo = jnp.moveaxis(halo, (-6, -3), (-2, -1))  # (…, nb2, nb3, l2, l3, nb1, l1)
    part = _halo_to_grid(halo, s1, msp, mr1)       # (…, nb2, nb3, l2, l3, mr1)
    part = jnp.moveaxis(part, (-5, -3), (-2, -1))  # (…, nb3, l3, mr1, nb2, l2)
    part = _halo_to_grid(part, s2, msp, mr2)       # (…, nb3, l3, mr1, mr2)
    part = jnp.moveaxis(part, (-4, -3), (-2, -1))  # (…, mr1, mr2, nb3, l3)
    return _halo_to_grid(part, s3, msp, mr3)       # (…, mr1, mr2, mr3)


_SPREAD_CHUNK_3D = 512


def _grid_halo(u: Array, s: int, msp: int, mr: int) -> Array:
    """Adjoint of :func:`_halo_to_grid`: view the circular grid ``u``
    (…, mr) as overlapping (nb, Ls) blocks via a static host-index gather
    (wrap-padded, so XLA lowers it to slices — no dynamic gather)."""
    nb = mr // s
    ls = s + 2 * msp - 1
    ue = jnp.concatenate([u[..., -(msp - 1):] if msp > 1 else u[..., :0],
                          u, u[..., : s + msp]], axis=-1)
    idx = (s * np.arange(nb)[:, None] + np.arange(ls)[None, :])
    return ue[..., idx]  # (…, nb, Ls); idx offset already includes -(msp-1)


def _interp(u: Array, x: Array, mr: int, tau: float, msp: int) -> Array:
    """Gaussian interpolation of grid values ``u`` (…, mr) at the points —
    the linear adjoint of :func:`_spread`, computed the same way: block
    halos of the grid contract against the point->block one-hot as matmuls,
    then the per-point local tap image reduces elementwise.  Replaces a
    dynamic gather of the taps."""
    s = _block_size(mr, _SPREAD_BLOCK, 1)
    if s < msp:  # tiny grid: dynamic gather is fine
        idx, w = _spread_geometry(x, mr, tau, msp)
        return jnp.sum(u[..., idx] * w.astype(u.real.dtype), axis=-1)
    b, a = _block_local(x, mr, tau, msp, s)
    halo = _grid_halo(u, s, msp, mr)  # (…, nb, Ls)
    return _interp_blocks([a], halo, b, mr // s)


def _center(spec: Array, mr: int, n: int, axis: int = -1) -> Array:
    """Extract the centered modes k = -n//2 … (n-1)//2 from a length-mr DFT
    along ``axis`` (wrap-around slice)."""
    spec = jnp.moveaxis(spec, axis, -1)
    half = n // 2
    out = jnp.concatenate(
        [spec[..., mr - half :], spec[..., : n - half]], axis=-1
    )
    return jnp.moveaxis(out, -1, axis)


def _wrap(fd: Array, mr: int, axis: int = -1) -> Array:
    """Inverse of :func:`_center`: place centered modes onto a length-mr
    grid along ``axis``, zero-filling the unused band."""
    fd = jnp.moveaxis(fd, axis, -1)
    n = fd.shape[-1]
    half = n // 2
    z = jnp.zeros(fd.shape[:-1] + (mr - n,), fd.dtype)
    out = jnp.concatenate([fd[..., half:], z, fd[..., :half]], axis=-1)
    return jnp.moveaxis(out, -1, axis)


def nufft1(
    x,
    c,
    n_modes: int,
    *,
    isign: int = -1,
    eps: float = 1e-6,
    method: str = "auto",
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Type-1 NUFFT: strengths at points -> centered Fourier modes.

    method "dense" (exact matmul), "grid" (Gaussian gridding + uniform FFT)
    or "auto" (dense while n_modes·M fits device memory comfortably).
    """
    x = jnp.asarray(x)
    c = jnp.asarray(c)
    if method not in ("auto", "dense", "grid"):
        raise ValueError(f"method must be auto|dense|grid, got {method!r}")
    if x.ndim != 1 or x.shape[0] < 1:
        raise ValueError("x must be a non-empty 1-D point array")
    if c.shape[-1] != x.shape[0]:
        raise ValueError(
            f"strengths last axis {c.shape[-1]} != number of points {x.shape[0]}"
        )
    if n_modes < 1:
        raise ValueError(f"n_modes must be >= 1, got {n_modes}")
    if _use_dense(method, n_modes * x.shape[0], n_modes):
        return nudft1(x, c, n_modes, isign=isign, config=config)
    if isign > 0:  # e^{+ikx} = e^{-ik(-x)}
        x = -x
    mr, tau, msp = _grid_params(n_modes, eps)
    grid = _spread(x, c, mr, tau, msp)
    spec = fft(grid, config=config)  # sum_m g[m] e^{-i k m h}
    centered = _center(spec, mr, n_modes)
    return centered * jnp.asarray(
        _deconv(n_modes, mr, tau), dtype=centered.real.dtype
    )


def nufft2(
    x,
    f,
    *,
    isign: int = +1,
    eps: float = 1e-6,
    method: str = "auto",
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Type-2 NUFFT: centered Fourier modes -> values at points."""
    x = jnp.asarray(x)
    f = jnp.asarray(f)
    if method not in ("auto", "dense", "grid"):
        raise ValueError(f"method must be auto|dense|grid, got {method!r}")
    if x.ndim != 1 or x.shape[0] < 1:
        raise ValueError("x must be a non-empty 1-D point array")
    n_modes = f.shape[-1]
    if n_modes < 1:
        raise ValueError("f must be non-empty along the mode axis")
    if _use_dense(method, n_modes * x.shape[0], n_modes):
        return nudft2(x, f, isign=isign, config=config)
    if isign < 0:
        x = -x
    mr, tau, msp = _grid_params(n_modes, eps)
    fd = f * jnp.asarray(_deconv(n_modes, mr, tau), dtype=f.real.dtype)
    u = ifft(_wrap(fd, mr), config=config) * mr  # sum_k fd[k] e^{+i k m h}
    return _interp(u, x, mr, tau, msp)


def nufft3(
    x,
    c,
    s,
    *,
    isign: int = -1,
    eps: float = 1e-6,
    method: str = "dense",
    x_extent=None,
    s_extent=None,
    x_center: float = 0.0,
    s_center: float = 0.0,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Type-3 NUFFT (arbitrary frequencies): f[i] = sum_j c[j]
    e^{isign·i·s[i]·x[j]}.

    method "dense" (default): the exact matmul — O(M·K) flops, the right
    shape for matmuls up to the memory wall (~10^4 x 10^4 points); phases
    are fp32 products of arbitrary reals, so accuracy degrades once
    |s·x| >> 1e4.  method "fast": the two-Gaussian Lee-Greengard
    composition — pre-deconvolve strengths by e^{rho·x^2}, evaluate the
    smeared spectrum on a uniform s-grid via an inner type-1 NUFFT
    (points h_s·x, anti-aliased by h_s = pi/(2·X)), then Gaussian-
    interpolate at the targets; O((S·X) + M + K) work (measured fp64
    ladder: msp 6 -> 3.7e-6, 8 -> 4e-8 relative).  "fast" needs the
    coordinate half-widths: pass ``x_extent``/``s_extent`` (static floats,
    required under jit) or leave None to infer from concrete inputs.
    """
    x = jnp.asarray(x)
    c = jnp.asarray(c)
    s = jnp.asarray(s)
    if method not in ("auto", "dense", "fast"):
        raise ValueError(f"method must be auto|dense|fast, got {method!r}")
    if isign not in (-1, 1):
        raise ValueError(f"isign must be +1 or -1, got {isign}")
    if method == "auto" and x.ndim == 1 and s.ndim == 1:
        ex = _type3_extent(x, x_extent)
        es = _type3_extent(s, s_extent)
        if ex is None or es is None:  # jit without extents: dense only
            method = "dense"
        else:
            method = "fast" if _type3_fast_wins(
                eps, 1, x.shape[0], s.shape[0], (es * ex,)
            ) else "dense"
    elif method == "auto":
        method = "dense"  # shape errors surface in the dense validation
    if method == "fast":
        return _nufft3_fast(
            x, c, s, isign=isign, eps=eps, x_extent=x_extent,
            s_extent=s_extent, x_center=x_center, s_center=s_center,
            config=config,
        )
    if x.ndim != 1 or s.ndim != 1 or x.shape[0] < 1 or s.shape[0] < 1:
        raise ValueError("x and s must be non-empty 1-D arrays")
    if c.shape[-1] != x.shape[0]:
        raise ValueError(
            f"strengths last axis {c.shape[-1]} != number of points {x.shape[0]}"
        )
    theta = s[:, None] * x[None, :]
    if isign < 0:
        theta = -theta
    cos, sin = jnp.cos(theta), jnp.sin(theta)
    cr = jnp.real(c).astype(cos.dtype)
    ci = jnp.imag(c).astype(cos.dtype)
    p = config.op_precision
    fr = jnp.einsum("km,...m->...k", cos, cr, precision=p) - jnp.einsum(
        "km,...m->...k", sin, ci, precision=p
    )
    fi = jnp.einsum("km,...m->...k", sin, cr, precision=p) + jnp.einsum(
        "km,...m->...k", cos, ci, precision=p
    )
    return jax.lax.complex(fr, fi)


# ---------------------------------------------------------------------------
# 2-D NUFFT (types 1 and 2) — the MRI / imaging shape.  Same two strategies:
# dense runs as a pair of chained contractions (never materializing the
# (n1·n2, M) matrix), grid spreads separable Gaussian taps into a pow2
# oversampled 2-D grid and runs the engine's fft2.
# ---------------------------------------------------------------------------


def _check_points_2d(x, y, c):
    if x.ndim != 1 or y.ndim != 1 or x.shape[0] < 1 or x.shape != y.shape:
        raise ValueError("x and y must be equal-length non-empty 1-D arrays")
    if c is not None and c.shape[-1] != x.shape[0]:
        raise ValueError(
            f"strengths last axis {c.shape[-1]} != number of points {x.shape[0]}"
        )


def nudft1_2d(
    x,
    y,
    c,
    n_modes,
    *,
    isign: int = -1,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Exact 2-D type-1 NUDFT: f[k1,k2] = sum_j c[j] e^{isign·i(k1·x_j+k2·y_j)}.

    (…, M) strengths -> (…, n1, n2) centered modes.  Evaluated as two chained
    contractions (phase factors per axis from the error-free reduction), so
    peak memory is O((n1+n2)·M), not O(n1·n2·M)."""
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    c = jnp.asarray(c)
    _check_points_2d(x, y, c)
    n1, n2 = int(n_modes[0]), int(n_modes[1])
    if n1 < 1 or n2 < 1:
        raise ValueError(f"n_modes must be positive, got {n_modes}")
    cos1, sin1 = _phase_trig(_centered_modes(n1), x, isign)  # (n1, M)
    cos2, sin2 = _phase_trig(_centered_modes(n2), y, isign)  # (n2, M)
    cr = jnp.real(c).astype(cos1.dtype)
    ci = jnp.imag(c).astype(cos1.dtype)
    # t = e^{isign·i·k2·y} * c, per mode row: (…, n2, M) planes
    tr = cos2 * cr[..., None, :] - sin2 * ci[..., None, :]
    ti = sin2 * cr[..., None, :] + cos2 * ci[..., None, :]
    p = config.op_precision
    fr = jnp.einsum("am,...bm->...ab", cos1, tr, precision=p) - jnp.einsum(
        "am,...bm->...ab", sin1, ti, precision=p
    )
    fi = jnp.einsum("am,...bm->...ab", sin1, tr, precision=p) + jnp.einsum(
        "am,...bm->...ab", cos1, ti, precision=p
    )
    return jax.lax.complex(fr, fi)


def nudft2_2d(
    x,
    y,
    f,
    *,
    isign: int = +1,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Exact 2-D type-2 NUDFT: (…, n1, n2) centered modes -> (…, M) values."""
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    f = jnp.asarray(f)
    _check_points_2d(x, y, None)
    if f.ndim < 2 or f.shape[-1] < 1 or f.shape[-2] < 1:
        raise ValueError("f must be (…, n1, n2) with non-empty mode axes")
    n1, n2 = f.shape[-2], f.shape[-1]
    cos1, sin1 = _phase_trig(_centered_modes(n1), x, isign)  # (n1, M)
    cos2, sin2 = _phase_trig(_centered_modes(n2), y, isign)  # (n2, M)
    fr = jnp.real(f).astype(cos1.dtype)
    fi = jnp.imag(f).astype(cos1.dtype)
    p = config.op_precision
    # contract k1 first: t[…, k2, m] = sum_k1 f[…, k1, k2] e^{isign·i·k1·x_m}
    tr = jnp.einsum("am,...ab->...bm", cos1, fr, precision=p) - jnp.einsum(
        "am,...ab->...bm", sin1, fi, precision=p
    )
    ti = jnp.einsum("am,...ab->...bm", sin1, fr, precision=p) + jnp.einsum(
        "am,...ab->...bm", cos1, fi, precision=p
    )
    # then k2 with per-point phases: c[…, m] = sum_k2 t[…, k2, m] e^{isign·i·k2·y_m}
    cr = jnp.einsum("bm,...bm->...m", cos2, tr, precision=p) - jnp.einsum(
        "bm,...bm->...m", sin2, ti, precision=p
    )
    ci = jnp.einsum("bm,...bm->...m", sin2, tr, precision=p) + jnp.einsum(
        "bm,...bm->...m", cos2, ti, precision=p
    )
    return jax.lax.complex(cr, ci)


def nufft1_2d(
    x,
    y,
    c,
    n_modes,
    *,
    isign: int = -1,
    eps: float = 1e-6,
    method: str = "auto",
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """2-D type-1 NUFFT: strengths at points -> (…, n1, n2) centered modes."""
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    c = jnp.asarray(c)
    if method not in ("auto", "dense", "grid"):
        raise ValueError(f"method must be auto|dense|grid, got {method!r}")
    _check_points_2d(x, y, c)
    n1, n2 = int(n_modes[0]), int(n_modes[1])
    if n1 < 1 or n2 < 1:
        raise ValueError(f"n_modes must be positive, got {n_modes}")
    if _use_dense_2d(method, n1, n2, x.shape[0]):
        return nudft1_2d(x, y, c, (n1, n2), isign=isign, config=config)
    if isign > 0:
        x, y = -x, -y
    mr1, tau1, msp = _grid_params(n1, eps)
    mr2, tau2, _ = _grid_params(n2, eps)
    grid = _spread_2d(x, y, c, (mr1, mr2), (tau1, tau2), msp)
    spec = fft2(grid, config=config)
    centered = _center(_center(spec, mr1, n1, axis=-2), mr2, n2)
    deconv = np.outer(_deconv(n1, mr1, tau1), _deconv(n2, mr2, tau2))
    return centered * jnp.asarray(deconv, dtype=centered.real.dtype)


def nufft2_2d(
    x,
    y,
    f,
    *,
    isign: int = +1,
    eps: float = 1e-6,
    method: str = "auto",
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """2-D type-2 NUFFT: (…, n1, n2) centered modes -> values at points."""
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    f = jnp.asarray(f)
    if method not in ("auto", "dense", "grid"):
        raise ValueError(f"method must be auto|dense|grid, got {method!r}")
    _check_points_2d(x, y, None)
    if f.ndim < 2 or f.shape[-1] < 1 or f.shape[-2] < 1:
        raise ValueError("f must be (…, n1, n2) with non-empty mode axes")
    n1, n2 = f.shape[-2], f.shape[-1]
    if _use_dense_2d(method, n1, n2, x.shape[0]):
        return nudft2_2d(x, y, f, isign=isign, config=config)
    if isign < 0:
        x, y = -x, -y
    mr1, tau1, msp = _grid_params(n1, eps)
    mr2, tau2, _ = _grid_params(n2, eps)
    deconv = np.outer(_deconv(n1, mr1, tau1), _deconv(n2, mr2, tau2))
    fd = f * jnp.asarray(deconv, dtype=f.real.dtype)
    wrapped = _wrap(_wrap(fd, mr1, axis=-2), mr2)
    u = ifft2(wrapped, config=config) * (mr1 * mr2)
    return _interp_2d(u, x, y, (mr1, mr2), (tau1, tau2), msp)


def _interp_2d(u: Array, x, y, mrs, taus, msp: int) -> Array:
    """2-D Gaussian interpolation of grid values ``u`` (…, mr1, mr2) at the
    points — the block-matmul adjoint of :func:`_spread_2d` (dynamic gather
    only for tiny grids)."""
    mr1, mr2 = mrs
    tau1, tau2 = taus
    s1 = _block_size(mr1, _SPREAD_BLOCK, 2)
    s2 = _block_size(mr2, _SPREAD_BLOCK, 2)
    if min(s1, s2) < msp:  # tiny grid: dynamic gather
        idx1, w1 = _spread_geometry(x, mr1, tau1, msp)
        idx2, w2 = _spread_geometry(y, mr2, tau2, msp)
        flat = (idx1[:, :, None] * mr2 + idx2[:, None, :]).reshape(-1)
        uf = u.reshape(u.shape[:-2] + (mr1 * mr2,))
        taps = uf[..., flat].reshape(
            u.shape[:-2] + (x.shape[0], 2 * msp, 2 * msp)
        )
        w = (w1[:, :, None] * w2[:, None, :]).astype(u.real.dtype)
        return jnp.sum(taps * w, axis=(-2, -1))
    # block-matmul adjoint interpolation (see _interp)
    b1, a1 = _block_local(x, mr1, tau1, msp, s1)
    b2, a2 = _block_local(y, mr2, tau2, msp, s2)
    nb1, nb2 = mr1 // s1, mr2 // s2
    halo = _grid_halo(u, s2, msp, mr2)              # (…, mr1, nb2, Ls2)
    halo = jnp.moveaxis(halo, -3, -1)               # (…, nb2, Ls2, mr1)
    halo = _grid_halo(halo, s1, msp, mr1)           # (…, nb2, Ls2, nb1, Ls1)
    halo = jnp.moveaxis(halo, (-2, -1), (-4, -2))   # (…, nb1, nb2, Ls1, Ls2)
    halo = halo.reshape(
        halo.shape[:-4] + (nb1 * nb2, halo.shape[-2] * halo.shape[-1])
    )
    return _interp_blocks([a1, a2], halo, b1 * nb2 + b2, nb1 * nb2)


def _cg(apply_normal, rhs: Array, iters: int, mode_axes: int) -> Array:
    """Fixed-iteration conjugate gradient under ``lax.scan`` for the
    (Hermitian positive-semidefinite) NUFFT normal equations.  Inner
    products reduce over the trailing ``mode_axes`` axes so the solve is
    batched over any leading axes of ``rhs``."""
    axes = tuple(range(-mode_axes, 0))

    def vdot(a, b):
        return jnp.sum(
            jnp.real(jnp.conj(a) * b), axis=axes, keepdims=True
        )

    def step(carry, _):
        f, r, p, rs = carry
        ap = apply_normal(p)
        denom = vdot(p, ap)
        alpha = rs / jnp.where(denom == 0, 1.0, denom)
        f = f + alpha * p
        r = r - alpha * ap
        rs_new = vdot(r, r)
        beta = rs_new / jnp.where(rs == 0, 1.0, rs)
        p = r + beta * p
        return (f, r, p, rs_new), None

    init = (jnp.zeros_like(rhs), rhs, rhs, vdot(rhs, rhs))
    (f, _, _, _), _ = jax.lax.scan(step, init, None, length=iters)
    return f


def nufft_lsq(
    x,
    b,
    n_modes: int,
    *,
    weights=None,
    damp: float = 0.0,
    iters: int = 30,
    isign: int = +1,
    eps: float = 1e-6,
    method: str = "auto",
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Least-squares inverse NUFFT: Fourier modes from non-uniform samples.

    Solves min_f sum_j w_j |sum_k f_k e^{isign·i·k·x_j} - b_j|^2 (+ damp·|f|^2)
    — the inverse problem of :func:`nufft2`, the core of MRI reconstruction
    and spectral estimation from scattered data.

    Device shape: the normal-equations operator A^H W A is TOEPLITZ
    (entry (k,l) depends only on k-l), so it embeds in a circulant of length
    2·n_modes and applying it is one padded forward+inverse engine FFT.
    Conjugate gradient then runs a fixed ``iters`` sweep under ``lax.scan``
    (static trip count, batched over leading axes of ``b``); the setup costs
    two NUFFTs (A^H W b and the 2n-1 Toeplitz entries, both type 1).

    ``weights`` (M,) are optional density-compensation weights; ``damp``
    adds Tikhonov regularization for ill-conditioned samplings (gaps larger
    than the Nyquist spacing of n_modes).  Exact recovery when M >= n_modes
    and the sampling is well-conditioned (verified 2e-15-class in fp64
    prototype; fp32 reaches the engine's ~1e-6 floor).
    """
    x = jnp.asarray(x)
    b = jnp.asarray(b)
    if x.ndim != 1 or x.shape[0] < 1:
        raise ValueError("x must be a non-empty 1-D point array")
    if b.shape[-1] != x.shape[0]:
        raise ValueError(
            f"samples last axis {b.shape[-1]} != number of points {x.shape[0]}"
        )
    if n_modes < 1:
        raise ValueError(f"n_modes must be >= 1, got {n_modes}")
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    if weights is not None:
        w = jnp.asarray(weights)
        if w.shape != (x.shape[0],):
            raise ValueError("weights must have shape (len(x),)")
        wb = b * w
        wl = w.astype(b.real.dtype)
    else:
        wb = b
        wl = jnp.ones((x.shape[0],), b.real.dtype)
    # A^H W b and the Toeplitz generating sequence t_m = sum_j w_j e^{-isign·i·m·x_j}
    rhs = nufft1(x, wb, n_modes, isign=-isign, eps=eps, method=method,
                 config=config)
    t = nufft1(x, wl.astype(rhs.dtype), 2 * n_modes - 1, isign=-isign,
               eps=eps, method=method, config=config)
    n = n_modes
    L = 2 * n
    # circulant embedding: c[m] = t_m for 0<=m<n, c[L-m] = t_{-m}
    c = jnp.concatenate(
        [t[..., n - 1 :], jnp.zeros(t.shape[:-1] + (1,), t.dtype),
         t[..., : n - 1]],
        axis=-1,
    )
    C = fft(c, config=config)

    def apply_normal(v):
        vp = jnp.concatenate(
            [v, jnp.zeros(v.shape[:-1] + (L - n,), v.dtype)], axis=-1
        )
        out = ifft(C * fft(vp, config=config), config=config)[..., :n]
        if damp:
            out = out + jnp.asarray(damp, v.real.dtype) * v
        return out

    return _cg(apply_normal, rhs, iters, mode_axes=1)


def nufft_lsq_2d(
    x,
    y,
    b,
    n_modes,
    *,
    weights=None,
    damp: float = 0.0,
    iters: int = 30,
    isign: int = +1,
    eps: float = 1e-6,
    method: str = "auto",
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """2-D least-squares inverse NUFFT — the MRI-reconstruction core.

    Recovers (…, n1, n2) Fourier modes from samples ``b`` (…, M) taken at
    scattered k-space points (x, y), minimizing the weighted residual of the
    2-D type-2 model (+ optional Tikhonov ``damp``).  The normal operator is
    block-Toeplitz-Toeplitz-block, so it embeds in a (2·n1, 2·n2) circulant:
    each CG iteration is one padded forward+inverse engine fft2; setup is
    two 2-D type-1 NUFFTs (A^H W b and the (2n1-1)x(2n2-1) Toeplitz map).
    """
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    b = jnp.asarray(b)
    _check_points_2d(x, y, b)
    n1, n2 = int(n_modes[0]), int(n_modes[1])
    if n1 < 1 or n2 < 1:
        raise ValueError(f"n_modes must be positive, got {n_modes}")
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    if weights is not None:
        w = jnp.asarray(weights)
        if w.shape != (x.shape[0],):
            raise ValueError("weights must have shape (len(x),)")
        wb = b * w
        wl = w.astype(b.real.dtype)
    else:
        wb = b
        wl = jnp.ones((x.shape[0],), b.real.dtype)
    rhs = nufft1_2d(x, y, wb, (n1, n2), isign=-isign, eps=eps, method=method,
                    config=config)
    t = nufft1_2d(x, y, wl.astype(rhs.dtype), (2 * n1 - 1, 2 * n2 - 1),
                  isign=-isign, eps=eps, method=method, config=config)

    def embed(tt, n, axis):
        tt = jnp.moveaxis(tt, axis, -1)
        out = jnp.concatenate(
            [tt[..., n - 1 :], jnp.zeros(tt.shape[:-1] + (1,), tt.dtype),
             tt[..., : n - 1]],
            axis=-1,
        )
        return jnp.moveaxis(out, -1, axis)

    C = fft2(embed(embed(t, n1, -2), n2, -1), config=config)
    L1, L2 = 2 * n1, 2 * n2

    def apply_normal(v):
        widths = [(0, 0)] * (v.ndim - 2) + [(0, L1 - n1), (0, L2 - n2)]
        vp = jnp.pad(v, widths)
        out = ifft2(C * fft2(vp, config=config), config=config)[..., :n1, :n2]
        if damp:
            out = out + jnp.asarray(damp, v.real.dtype) * v
        return out

    return _cg(apply_normal, rhs, iters, mode_axes=2)


def nufft_lsq_3d(
    x,
    y,
    z,
    b,
    n_modes,
    *,
    weights=None,
    damp: float = 0.0,
    iters: int = 30,
    isign: int = +1,
    eps: float = 1e-6,
    method: str = "auto",
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """3-D least-squares inverse NUFFT — the volumetric MRI shape.

    Recovers (…, n1, n2, n3) Fourier modes from samples ``b`` (…, M) at
    scattered k-space points (x, y, z): the normal operator is level-3
    block-Toeplitz, embedding in a (2n1, 2n2, 2n3) circulant — each CG
    iteration is one padded forward+inverse engine fftn; setup is two 3-D
    type-1 NUFFTs (same scheme as :func:`nufft_lsq_2d`)."""
    x, y, z, b = map(jnp.asarray, (x, y, z, b))
    _check_points_3d(x, y, z, b)
    n1, n2, n3 = (int(v) for v in n_modes)
    if min(n1, n2, n3) < 1:
        raise ValueError(f"n_modes must be positive, got {n_modes}")
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    if weights is not None:
        w = jnp.asarray(weights)
        if w.shape != (x.shape[0],):
            raise ValueError("weights must have shape (len(x),)")
        wb = b * w
        wl = w.astype(b.real.dtype)
    else:
        wb = b
        wl = jnp.ones((x.shape[0],), b.real.dtype)
    rhs = nufft1_3d(x, y, z, wb, (n1, n2, n3), isign=-isign, eps=eps,
                    method=method, config=config)
    t = nufft1_3d(x, y, z, wl.astype(rhs.dtype),
                  (2 * n1 - 1, 2 * n2 - 1, 2 * n3 - 1), isign=-isign,
                  eps=eps, method=method, config=config)

    def embed(tt, n, axis):
        tt = jnp.moveaxis(tt, axis, -1)
        out = jnp.concatenate(
            [tt[..., n - 1 :], jnp.zeros(tt.shape[:-1] + (1,), tt.dtype),
             tt[..., : n - 1]],
            axis=-1,
        )
        return jnp.moveaxis(out, -1, axis)

    from .fft import fftn as _fftn, ifftn as _ifftn

    C = _fftn(
        embed(embed(embed(t, n1, -3), n2, -2), n3, -1),
        axes=(-3, -2, -1), config=config,
    )
    L1, L2, L3 = 2 * n1, 2 * n2, 2 * n3

    def apply_normal(v):
        widths = [(0, 0)] * (v.ndim - 3) + [
            (0, L1 - n1), (0, L2 - n2), (0, L3 - n3)
        ]
        vp = jnp.pad(v, widths)
        # axes pinned: numpy-style fftn defaults transform EVERY axis,
        # which silently corrupts batched inputs (leading axes are batch)
        out = _ifftn(
            C * _fftn(vp, axes=(-3, -2, -1), config=config),
            axes=(-3, -2, -1), config=config,
        )[..., :n1, :n2, :n3]
        if damp:
            out = out + jnp.asarray(damp, v.real.dtype) * v
        return out

    return _cg(apply_normal, rhs, iters, mode_axes=3)


# ---------------------------------------------------------------------------
# 3-D NUFFT (types 1 and 2) — volumetric MRI / particle-mesh shape.  Grid
# path only beyond tiny sizes: separable Gaussian taps into a pow2^3
# oversampled volume + the engine's fftn.  Dense path (tiny problems /
# test oracle) materializes the (n1, n2, n3, M) complex phase tensor.
# ---------------------------------------------------------------------------


def _check_points_3d(x, y, z, c):
    if (
        x.ndim != 1
        or x.shape[0] < 1
        or x.shape != y.shape
        or x.shape != z.shape
    ):
        raise ValueError("x, y, z must be equal-length non-empty 1-D arrays")
    if c is not None and c.shape[-1] != x.shape[0]:
        raise ValueError(
            f"strengths last axis {c.shape[-1]} != number of points {x.shape[0]}"
        )


def _phase_matrix(n: int, x: Array, isign: int) -> Array:
    cos, sin = _phase_trig(_centered_modes(n), x, isign)
    return jax.lax.complex(cos, sin)


def nudft1_3d(
    x, y, z, c, n_modes, *, isign: int = -1,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Exact 3-D type-1 NUDFT (tiny sizes / oracle): (…, M) -> (…, n1, n2, n3)."""
    x, y, z, c = map(jnp.asarray, (x, y, z, c))
    _check_points_3d(x, y, z, c)
    n1, n2, n3 = (int(v) for v in n_modes)
    if min(n1, n2, n3) < 1:
        raise ValueError(f"n_modes must be positive, got {n_modes}")
    E = (
        _phase_matrix(n1, x, isign)[:, None, None, :]
        * _phase_matrix(n2, y, isign)[None, :, None, :]
        * _phase_matrix(n3, z, isign)[None, None, :, :]
    )
    return jnp.einsum(
        "abcj,...j->...abc", E, c.astype(E.dtype),
        precision=config.op_precision,
    )


def nudft2_3d(
    x, y, z, f, *, isign: int = +1,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Exact 3-D type-2 NUDFT (tiny sizes / oracle): (…, n1, n2, n3) -> (…, M)."""
    x, y, z, f = map(jnp.asarray, (x, y, z, f))
    _check_points_3d(x, y, z, None)
    if f.ndim < 3 or min(f.shape[-3:]) < 1:
        raise ValueError("f must be (…, n1, n2, n3) with non-empty mode axes")
    n1, n2, n3 = f.shape[-3:]
    E = (
        _phase_matrix(n1, x, isign)[:, None, None, :]
        * _phase_matrix(n2, y, isign)[None, :, None, :]
        * _phase_matrix(n3, z, isign)[None, None, :, :]
    )
    return jnp.einsum(
        "abcj,...abc->...j", E, f.astype(E.dtype),
        precision=config.op_precision,
    )


def nufft1_3d(
    x, y, z, c, n_modes, *, isign: int = -1, eps: float = 1e-6,
    method: str = "auto", config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """3-D type-1 NUFFT: strengths at points -> (…, n1, n2, n3) modes."""
    x, y, z, c = map(jnp.asarray, (x, y, z, c))
    if method not in ("auto", "dense", "grid"):
        raise ValueError(f"method must be auto|dense|grid, got {method!r}")
    _check_points_3d(x, y, z, c)
    n1, n2, n3 = (int(v) for v in n_modes)
    if min(n1, n2, n3) < 1:
        raise ValueError(f"n_modes must be positive, got {n_modes}")
    if _use_dense(method, n1 * n2 * n3 * x.shape[0], max(n1, n2, n3),
                  limit=_DENSE_MAX_ENTRIES_3D):
        return nudft1_3d(x, y, z, c, (n1, n2, n3), isign=isign, config=config)
    if isign > 0:
        x, y, z = -x, -y, -z
    from .fft import fftn as _fftn

    mr1, tau1, msp = _grid_params(n1, eps)
    mr2, tau2, _ = _grid_params(n2, eps)
    mr3, tau3, _ = _grid_params(n3, eps)
    grid = _spread_3d(
        x, y, z, c, (mr1, mr2, mr3), (tau1, tau2, tau3), msp
    )
    if grid is None:  # grid too small for the block scheme: scatter
        idx1, w1 = _spread_geometry(x, mr1, tau1, msp)
        idx2, w2 = _spread_geometry(y, mr2, tau2, msp)
        idx3, w3 = _spread_geometry(z, mr3, tau3, msp)
        taps = (
            w1[:, :, None, None] * w2[:, None, :, None] * w3[:, None, None, :]
        ).astype(c.real.dtype)
        vals = taps * c[..., :, None, None, None]
        flat = (
            (idx1[:, :, None, None] * mr2 + idx2[:, None, :, None]) * mr3
            + idx3[:, None, None, :]
        ).reshape(-1)
        grid = jnp.zeros(c.shape[:-1] + (mr1 * mr2 * mr3,), dtype=vals.dtype)
        grid = grid.at[..., flat].add(
            vals.reshape(vals.shape[:-4] + (-1,)), mode="promise_in_bounds"
        )
        grid = grid.reshape(c.shape[:-1] + (mr1, mr2, mr3))
    spec = _fftn(grid, axes=(-3, -2, -1), config=config)
    centered = _center(
        _center(_center(spec, mr1, n1, axis=-3), mr2, n2, axis=-2), mr3, n3
    )
    deconv = (
        _deconv(n1, mr1, tau1)[:, None, None]
        * _deconv(n2, mr2, tau2)[None, :, None]
        * _deconv(n3, mr3, tau3)[None, None, :]
    )
    return centered * jnp.asarray(deconv, dtype=centered.real.dtype)


def nufft2_3d(
    x, y, z, f, *, isign: int = +1, eps: float = 1e-6,
    method: str = "auto", config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """3-D type-2 NUFFT: (…, n1, n2, n3) modes -> values at points."""
    x, y, z, f = map(jnp.asarray, (x, y, z, f))
    if method not in ("auto", "dense", "grid"):
        raise ValueError(f"method must be auto|dense|grid, got {method!r}")
    _check_points_3d(x, y, z, None)
    if f.ndim < 3 or min(f.shape[-3:]) < 1:
        raise ValueError("f must be (…, n1, n2, n3) with non-empty mode axes")
    n1, n2, n3 = f.shape[-3:]
    if _use_dense(method, n1 * n2 * n3 * x.shape[0], max(n1, n2, n3),
                  limit=_DENSE_MAX_ENTRIES_3D):
        return nudft2_3d(x, y, z, f, isign=isign, config=config)
    if isign < 0:
        x, y, z = -x, -y, -z
    from .fft import ifftn as _ifftn

    mr1, tau1, msp = _grid_params(n1, eps)
    mr2, tau2, _ = _grid_params(n2, eps)
    mr3, tau3, _ = _grid_params(n3, eps)
    deconv = (
        _deconv(n1, mr1, tau1)[:, None, None]
        * _deconv(n2, mr2, tau2)[None, :, None]
        * _deconv(n3, mr3, tau3)[None, None, :]
    )
    fd = f * jnp.asarray(deconv, dtype=f.real.dtype)
    wrapped = _wrap(_wrap(_wrap(fd, mr1, axis=-3), mr2, axis=-2), mr3)
    u = _ifftn(wrapped, axes=(-3, -2, -1), config=config) * (mr1 * mr2 * mr3)
    idx1, w1 = _spread_geometry(x, mr1, tau1, msp)
    idx2, w2 = _spread_geometry(y, mr2, tau2, msp)
    idx3, w3 = _spread_geometry(z, mr3, tau3, msp)
    flat = (
        (idx1[:, :, None, None] * mr2 + idx2[:, None, :, None]) * mr3
        + idx3[:, None, None, :]
    ).reshape(-1)
    uf = u.reshape(u.shape[:-3] + (mr1 * mr2 * mr3,))
    m = x.shape[0]
    taps = uf[..., flat].reshape(u.shape[:-3] + (m, 2 * msp, 2 * msp, 2 * msp))
    w = (
        w1[:, :, None, None] * w2[:, None, :, None] * w3[:, None, None, :]
    ).astype(u.real.dtype)
    return jnp.sum(taps * w, axis=(-3, -2, -1))


def _nufft3_fast(
    x, c, s, *, isign, eps, x_extent, s_extent, x_center, s_center, config
) -> Array:
    """Lee-Greengard type 3: centre both coordinate sets, pre-deconvolve by
    the frequency-side Gaussian, inner type-1 onto a uniform s-grid,
    Gaussian interpolation at the targets (constants validated against the
    dense oracle — module docstring)."""
    if x.ndim != 1 or x.shape[0] < 1:
        raise ValueError("x must be a non-empty 1-D point array")
    if c.shape[-1] != x.shape[0]:
        raise ValueError(
            f"strengths last axis {c.shape[-1]} != number of points {x.shape[0]}"
        )
    if s.ndim != 1 or s.shape[0] < 1:
        raise ValueError("s must be a non-empty 1-D frequency array")
    if x_extent is None or s_extent is None:
        try:
            xh = np.asarray(x)
            sh = np.asarray(s)
        except Exception as exc:  # traced under jit
            raise ValueError(
                "nufft3(method='fast') under jit needs static x_extent and "
                "s_extent (half-widths about x_center/s_center)"
            ) from exc
        x0 = float((xh.max() + xh.min()) / 2.0)
        s0 = float((sh.max() + sh.min()) / 2.0)
        X = max(float((xh.max() - xh.min()) / 2.0), 1e-9)
        S = max(float((sh.max() - sh.min()) / 2.0), 1e-9)
    else:
        x0 = float(x_center)
        s0 = float(s_center)
        X = float(x_extent)
        S = float(s_extent)
    xc = x - x0 if x0 != 0.0 else x
    sc = s - s0 if s0 != 0.0 else s
    sigma = 2.0
    h_s = math.pi / (sigma * X)
    msp = _msp(eps)
    rho = msp * h_s * h_s / (3.0 * math.pi)
    k2 = int(math.ceil((S + msp * h_s) / h_s)) + 2
    n_grid = 2 * k2 + 1
    # strengths: centre-shift phase e^{isign·i·s0·xc} and Gaussian pre-deconv
    beta = c * (jnp.exp(rho * xc * xc) / (2.0 * math.sqrt(math.pi * rho)))
    if s0 != 0.0:  # static skip: zero-phase passes cost two trig sweeps
        phase0 = float(isign) * s0 * xc
        beta = beta * jax.lax.complex(jnp.cos(phase0), jnp.sin(phase0))
    # inner type-1: B[k] = sum_j beta_j e^{isign·i·k·(h_s·xc_j)}
    B = nufft1(h_s * xc, beta, n_grid, isign=isign, eps=eps, config=config)
    # Gaussian interpolation at the target frequencies
    i0 = jnp.round(sc / h_s).astype(jnp.int32)
    taps = np.arange(-msp + 1, msp + 1, dtype=np.int32)
    idx = i0[:, None] + taps[None, :]
    dist = sc[:, None] - idx.astype(sc.dtype) * h_s
    w = jnp.exp(-(dist * dist) / (4.0 * rho)) * h_s
    vals = jnp.take(B, jnp.clip(idx + k2, 0, n_grid - 1), axis=-1)
    f = jnp.sum(vals * w.astype(B.real.dtype), axis=-1)
    if x0 != 0.0:  # undo the s-centre shift: multiply by e^{isign·i·s·x0}
        phase1 = float(isign) * s * x0
        f = f * jax.lax.complex(jnp.cos(phase1), jnp.sin(phase1))
    return f


def nufft3_2d(
    x,
    y,
    c,
    s,
    t,
    *,
    isign: int = -1,
    eps: float = 1e-6,
    method: str = "dense",
    x_extent=None,
    y_extent=None,
    s_extent=None,
    t_extent=None,
    centers=(0.0, 0.0, 0.0, 0.0),
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """2-D type-3 NUFFT: f[i] = sum_j c[j] e^{isign·i·(s_i·x_j + t_i·y_j)}
    for arbitrary source points (x, y) and arbitrary target frequencies
    (s, t).

    method "dense" (default): the exact (K, M) phase matmul — matmul-shaped to
    ~10^4 x 10^4.  method "fast": the separable Lee-Greengard composition
    (the 2-D analogue of :func:`nufft3`'s fast path): centre both coordinate
    pairs, pre-deconvolve strengths by the product Gaussian
    e^{rho1·x² + rho2·y²}, evaluate the smeared spectrum on a uniform
    (s, t)-grid with an inner 2-D type-1 NUFFT, then separable-Gaussian
    interpolate at the K targets — O(S1·X1·S2·X2 + M + K).  "fast" under
    jit needs the static per-axis half-widths ``x_extent``/``y_extent``/
    ``s_extent``/``t_extent`` (about ``centers`` = (x0, y0, s0, t0))."""
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    c = jnp.asarray(c)
    s = jnp.asarray(s)
    t = jnp.asarray(t)
    if method not in ("auto", "dense", "fast"):
        raise ValueError(f"method must be auto|dense|fast, got {method!r}")
    if isign not in (-1, 1):
        raise ValueError(f"isign must be +1 or -1, got {isign}")
    _check_points_2d(x, y, c)
    if s.ndim != 1 or s.shape != t.shape or s.shape[0] < 1:
        raise ValueError("s and t must be equal-length non-empty 1-D arrays")
    if method == "auto":
        spans = [
            _type3_extent(p, e)
            for p, e in ((x, x_extent), (y, y_extent),
                         (s, s_extent), (t, t_extent))
        ]
        if any(e is None for e in spans):  # jit without extents: dense only
            method = "dense"
        else:
            x1, x2, s1, s2 = spans
            method = "fast" if _type3_fast_wins(
                eps, 2, x.shape[0], s.shape[0], (s1 * x1, s2 * x2)
            ) else "dense"
    if method == "dense":
        theta = s[:, None] * x[None, :] + t[:, None] * y[None, :]
        if isign < 0:
            theta = -theta
        cos, sin = jnp.cos(theta), jnp.sin(theta)
        cr = jnp.real(c).astype(cos.dtype)
        ci = jnp.imag(c).astype(cos.dtype)
        p = config.op_precision
        fr = jnp.einsum("km,...m->...k", cos, cr, precision=p) - jnp.einsum(
            "km,...m->...k", sin, ci, precision=p
        )
        fi = jnp.einsum("km,...m->...k", sin, cr, precision=p) + jnp.einsum(
            "km,...m->...k", cos, ci, precision=p
        )
        return jax.lax.complex(fr, fi)

    # ---- fast: separable two-Gaussian composition --------------------------
    _lbl = "nufft3_2d(method='fast')"
    X1, x0 = _fast_axis_setup(x, x_extent, centers[0], _lbl)
    X2, y0 = _fast_axis_setup(y, y_extent, centers[1], _lbl)
    S1, s0 = _fast_axis_setup(s, s_extent, centers[2], _lbl)
    S2, t0 = _fast_axis_setup(t, t_extent, centers[3], _lbl)
    xc = x - x0 if x0 != 0.0 else x
    yc = y - y0 if y0 != 0.0 else y
    sc = s - s0 if s0 != 0.0 else s
    tc = t - t0 if t0 != 0.0 else t
    sigma = 2.0
    msp = _msp(eps)
    h1 = math.pi / (sigma * X1)
    h2 = math.pi / (sigma * X2)
    rho1 = msp * h1 * h1 / (3.0 * math.pi)
    rho2 = msp * h2 * h2 / (3.0 * math.pi)
    k1 = int(math.ceil((S1 + msp * h1) / h1)) + 2
    k2 = int(math.ceil((S2 + msp * h2) / h2)) + 2
    n1, n2 = 2 * k1 + 1, 2 * k2 + 1
    beta = c * (
        jnp.exp(rho1 * xc * xc + rho2 * yc * yc)
        / (4.0 * math.pi * math.sqrt(rho1 * rho2))
    )
    if s0 != 0.0 or t0 != 0.0:  # centre-shift phase on the sources
        phase0 = float(isign) * (s0 * xc + t0 * yc)
        beta = beta * jax.lax.complex(jnp.cos(phase0), jnp.sin(phase0))
    B = nufft1_2d(
        h1 * xc, h2 * yc, beta, (n1, n2), isign=isign, eps=eps, config=config
    )  # (n1, n2) centered modes
    # Separable Gaussian interpolation at the K targets: dynamic tap GATHER,
    # not the _interp_2d block-matmul adjoint.  Type 3's target stage has K
    # sparse targets on a LARGE pow2-padded mode grid (m=4096 -> ~8192^2
    # after padding): the one-hot matmul's cost scales with the grid while
    # the gather's scales with K*P^2.
    taps = np.arange(-msp + 1, msp + 1, dtype=np.int32)
    i1 = jnp.round(sc / h1).astype(jnp.int32)
    i2 = jnp.round(tc / h2).astype(jnp.int32)
    idx1 = i1[:, None] + taps[None, :]
    idx2 = i2[:, None] + taps[None, :]
    d1 = sc[:, None] - idx1.astype(sc.dtype) * h1
    d2 = tc[:, None] - idx2.astype(tc.dtype) * h2
    w1 = jnp.exp(-(d1 * d1) / (4.0 * rho1)) * h1  # (K, P)
    w2 = jnp.exp(-(d2 * d2) / (4.0 * rho2)) * h2  # (K, P)
    g1 = jnp.clip(idx1 + k1, 0, n1 - 1)
    g2 = jnp.clip(idx2 + k2, 0, n2 - 1)
    flat = B.reshape(B.shape[:-2] + (-1,))  # (…, n1*n2): keep batch axes
    lin = g1[:, :, None] * n2 + g2[:, None, :]  # (K, P, P)
    vals = jnp.take(flat, lin.reshape(-1), axis=-1).reshape(
        B.shape[:-2] + lin.shape
    )  # (…, K, P, P)
    # planes (see nufft3_3d: complex x real multi-operand einsum is a
    # compiler hazard)
    wdt = jnp.real(vals).dtype
    w1, w2 = w1.astype(wdt), w2.astype(wdt)
    prec = config.op_precision
    fr = jnp.einsum("...kpq,kp,kq->...k", jnp.real(vals), w1, w2, precision=prec)
    fi = jnp.einsum("...kpq,kp,kq->...k", jnp.imag(vals), w1, w2, precision=prec)
    f = jax.lax.complex(fr, fi)
    if x0 != 0.0 or y0 != 0.0:  # undo the source-centre shift at the targets
        phase1 = float(isign) * (s * x0 + t * y0)
        f = f * jax.lax.complex(jnp.cos(phase1), jnp.sin(phase1))
    return f


def nufft3_3d(
    x,
    y,
    z,
    c,
    s,
    t,
    u,
    *,
    isign: int = -1,
    eps: float = 1e-6,
    method: str = "dense",
    extents=None,
    centers=(0.0,) * 6,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """3-D type-3 NUFFT:
    f[i] = sum_j c[j] e^{isign·i·(s_i·x_j + t_i·y_j + u_i·z_j)}.

    Completes the type-3 family (1-D :func:`nufft3`, 2-D
    :func:`nufft3_2d`).  method "dense": one exact (K, M) phase matmul.
    method "fast": the separable Lee-Greengard composition over an inner
    3-D type-1 NUFFT with per-axis product-Gaussian deconvolution and
    separable tap interpolation.  ``extents`` is the 6-tuple of static
    half-widths (X1, X2, X3, S1, S2, S3) about ``centers`` (x0, y0, z0,
    s0, t0, u0) — required under jit, inferred from concrete inputs
    otherwise."""
    x, y, z, c, s, t, u = map(jnp.asarray, (x, y, z, c, s, t, u))
    if method not in ("auto", "dense", "fast"):
        raise ValueError(f"method must be auto|dense|fast, got {method!r}")
    if isign not in (-1, 1):
        raise ValueError(f"isign must be +1 or -1, got {isign}")
    _check_points_3d(x, y, z, c)
    if s.ndim != 1 or s.shape != t.shape or s.shape != u.shape or s.shape[0] < 1:
        raise ValueError("s, t, u must be equal-length non-empty 1-D arrays")
    if method == "auto":
        exts0 = (None,) * 6 if extents is None else tuple(extents)
        if len(exts0) != 6:
            raise ValueError("extents must be a 6-tuple")
        spans = [
            _type3_extent(p, e)
            for p, e in zip((x, y, z, s, t, u), exts0)
        ]
        if any(e is None for e in spans):  # jit without extents: dense only
            method = "dense"
        else:
            x1, x2, x3, s1, s2, s3 = spans
            method = "fast" if _type3_fast_wins(
                eps, 3, x.shape[0], s.shape[0],
                (s1 * x1, s2 * x2, s3 * x3),
            ) else "dense"
    if method == "dense":
        theta = (
            s[:, None] * x[None, :]
            + t[:, None] * y[None, :]
            + u[:, None] * z[None, :]
        )
        if isign < 0:
            theta = -theta
        cos, sin = jnp.cos(theta), jnp.sin(theta)
        cr = jnp.real(c).astype(cos.dtype)
        ci = jnp.imag(c).astype(cos.dtype)
        p = config.op_precision
        fr = jnp.einsum("km,...m->...k", cos, cr, precision=p) - jnp.einsum(
            "km,...m->...k", sin, ci, precision=p
        )
        fi = jnp.einsum("km,...m->...k", sin, cr, precision=p) + jnp.einsum(
            "km,...m->...k", cos, ci, precision=p
        )
        return jax.lax.complex(fr, fi)

    exts = (None,) * 6 if extents is None else tuple(extents)
    if len(exts) != 6 or len(centers) != 6:
        raise ValueError("extents and centers must be 6-tuples")
    pts_all = (x, y, z, s, t, u)
    X, C0 = [], []
    for pts, ext, ctr in zip(pts_all, exts, centers):
        e, c0 = _fast_axis_setup(
            pts, ext, ctr,
            "nufft3_3d(method='fast') (static 6-tuple `extents`)")
        X.append(e)
        C0.append(c0)
    (X1, X2, X3, S1, S2, S3) = X
    (x0, y0, z0, s0, t0, u0) = C0
    xc = x - x0 if x0 != 0.0 else x
    yc = y - y0 if y0 != 0.0 else y
    zc = z - z0 if z0 != 0.0 else z
    sc = s - s0 if s0 != 0.0 else s
    tc = t - t0 if t0 != 0.0 else t
    uc = u - u0 if u0 != 0.0 else u
    sigma = 2.0
    msp = _msp(eps)
    hs = [math.pi / (sigma * Xi) for Xi in (X1, X2, X3)]
    rhos = [msp * h * h / (3.0 * math.pi) for h in hs]
    ks = [
        int(math.ceil((Si + msp * h) / h)) + 2
        for Si, h in zip((S1, S2, S3), hs)
    ]
    ns = [2 * k + 1 for k in ks]
    norm = 8.0 * math.pi ** 1.5 * math.sqrt(rhos[0] * rhos[1] * rhos[2])
    beta = c * (
        jnp.exp(rhos[0] * xc * xc + rhos[1] * yc * yc + rhos[2] * zc * zc)
        / norm
    )
    if s0 != 0.0 or t0 != 0.0 or u0 != 0.0:
        phase0 = float(isign) * (s0 * xc + t0 * yc + u0 * zc)
        beta = beta * jax.lax.complex(jnp.cos(phase0), jnp.sin(phase0))
    B = nufft1_3d(
        hs[0] * xc, hs[1] * yc, hs[2] * zc, beta, tuple(ns),
        isign=isign, eps=eps, config=config,
    )
    taps = np.arange(-msp + 1, msp + 1, dtype=np.int32)

    def _axis_interp(freq, h, rho, k, n):
        i0 = jnp.round(freq / h).astype(jnp.int32)
        idx = i0[:, None] + taps[None, :]
        d = freq[:, None] - idx.astype(freq.dtype) * h
        w = jnp.exp(-(d * d) / (4.0 * rho)) * h
        return jnp.clip(idx + k, 0, n - 1), w

    g1, w1 = _axis_interp(sc, hs[0], rhos[0], ks[0], ns[0])
    g2, w2 = _axis_interp(tc, hs[1], rhos[1], ks[1], ns[1])
    g3, w3 = _axis_interp(uc, hs[2], rhos[2], ks[2], ns[2])
    flat = B.reshape(B.shape[:-3] + (-1,))  # (…, n1*n2*n3): keep batch axes
    lin = (
        g1[:, :, None, None] * (ns[1] * ns[2])
        + g2[:, None, :, None] * ns[2]
        + g3[:, None, None, :]
    )  # (K, P, P, P)
    vals = jnp.take(flat, lin.reshape(-1), axis=-1).reshape(
        B.shape[:-3] + lin.shape
    )  # (…, K, P, P, P)
    # planes: a >2-operand complex x real einsum has crashed XLA compilers
    # (X64Rewriter ElementIsComplex check) — run the real contraction twice
    wdt = jnp.real(vals).dtype
    w1, w2, w3 = (w.astype(wdt) for w in (w1, w2, w3))
    prec = config.op_precision
    fr = jnp.einsum("...kpqr,kp,kq,kr->...k", jnp.real(vals), w1, w2, w3,
                    precision=prec)
    fi = jnp.einsum("...kpqr,kp,kq,kr->...k", jnp.imag(vals), w1, w2, w3,
                    precision=prec)
    f = jax.lax.complex(fr, fi)
    if x0 != 0.0 or y0 != 0.0 or z0 != 0.0:
        phase1 = float(isign) * (s * x0 + t * y0 + u * z0)
        f = f * jax.lax.complex(jnp.cos(phase1), jnp.sin(phase1))
    return f
