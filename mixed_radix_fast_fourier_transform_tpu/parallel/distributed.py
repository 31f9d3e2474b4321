"""Distributed transforms: four-step decomposition + batch sharding.

The reference is single-core C with no parallel subsystem (SURVEY.md §2.3), so
this is a new component.  Two orthogonal mechanisms:

* **Batch sharding** (:func:`fft_batch_sharded`): independent transforms laid
  out over a mesh axis with `NamedSharding`; XLA partitions the whole matmul
  pipeline with zero collectives.  This is how large batches of small/medium
  FFTs scale.

* **Transform sharding** (:func:`fft_four_step`): one transform of length
  N = N1·N2 too large (or too latency-critical) for a single chip, split by
  the Bailey four-step algorithm:

      A = x.reshape(N1, N2)                    (row-major)
      1. FFT_N1 along columns (axis -2)
      2. A *= W_N^(±k1·n2)                     (split twiddle)
      3. FFT_N2 along rows (axis -1)
      4. X[k2·N1 + k1] = A[k1, k2]             (global transpose)

  Sharded over a mesh axis P, each column/row FFT is local and each layout
  change is one `jax.lax.all_to_all` over the interconnect: reshard n1→n2
  before step 1, n2→n1 before step 3, and one final resharding transpose for natural-order
  output — three all-to-alls total, each moving N/P complex elements per chip.

The per-chip FFTs reuse the single-chip mixed-radix matmul engine
(:mod:`..ops.stockham`); the split twiddle is precomputed on host in fp64 with
exact integer phase reduction (the same accuracy discipline as the plan
twiddles — reference's dynamic formula, src/highSpeedFFT.c:2275-2288).
"""

from __future__ import annotations

import functools
import math
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.stockham import exec_complex
from ..plan import get_plan
from ..utils.config import DEFAULT_CONFIG, SpectralConfig
from ..utils.factorize import is_smooth, next_splittable_len
from .mesh import DATA_AXIS, SEQ_AXIS

Array = jax.Array


def choose_split(
    n: int, parts: int, max_stage: int = DEFAULT_CONFIG.max_stage
) -> Tuple[int, int]:
    """Pick N = n1·n2 with P | n1, P | n2, both smooth, as square as possible.

    Both factors must divide by the mesh size so the all-to-alls tile evenly,
    and both must be smooth so each local FFT takes the mixed-radix path.
    """
    best = None
    for n1 in range(1, int(math.isqrt(n)) + 1):
        if n % n1:
            continue
        n2 = n // n1
        for a, b in ((n1, n2), (n2, n1)):
            if a % parts or b % parts:
                continue
            if not (is_smooth(a, max_stage) and is_smooth(b, max_stage)):
                continue
            key = abs(a - b)
            if best is None or key < best[0]:
                best = (key, a, b)
    if best is None:
        raise ValueError(
            f"cannot split N={n} as n1*n2 with both factors divisible by "
            f"{parts} and {max_stage}-smooth; pad the transform length"
        )
    return best[1], best[2]


@functools.lru_cache(maxsize=256)
def _split_twiddle_matrix(n1: int, n2: int, sign: int) -> Tuple[np.ndarray, np.ndarray]:
    """W[k1, n2] = e^(sign·2πi·k1·n2/N), fp64 with exact integer phase mod N."""
    n = n1 * n2
    k1 = np.arange(n1, dtype=np.int64)[:, None]
    j2 = np.arange(n2, dtype=np.int64)[None, :]
    phase = (k1 * j2) % n
    ang = (sign * 2.0 * np.pi / n) * phase.astype(np.float64)
    return np.cos(ang), np.sin(ang)


def _local_fft_last(plan, xr: Array, xi: Array) -> Tuple[Array, Array]:
    return exec_complex(plan, xr, xi)


def _local_fft_axis2(plan, xr: Array, xi: Array) -> Tuple[Array, Array]:
    xr = jnp.swapaxes(xr, -1, -2)
    xi = jnp.swapaxes(xi, -1, -2)
    zr, zi = exec_complex(plan, xr, xi)
    return jnp.swapaxes(zr, -1, -2), jnp.swapaxes(zi, -1, -2)


def fft_four_step(
    x,
    mesh: Mesh,
    *,
    seq_axis: str = SEQ_AXIS,
    data_axis: Optional[str] = None,
    inverse: bool = False,
    norm: Optional[str] = "backward",
    n1: Optional[int] = None,
    overlap_chunks: int = 1,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Distributed 1-D FFT along the last axis, natural order in and out.

    ``x``: (..., N) complex or real, N = n1·n2 with mesh[seq_axis] dividing
    both factors.  Input/output are sharded contiguously along the last axis
    over ``seq_axis``; leading batch axes optionally shard over ``data_axis``.

    Three all-to-alls.  For convolution-style pipelines that don't need
    natural-order spectra, see :func:`fft_four_step_scrambled` /
    :func:`ifft_four_step_scrambled` (two all-to-alls each).

    ``overlap_chunks > 1`` splits the leading batch axis into that many
    independent chunk pipelines inside one shard_map, so XLA's latency-hiding
    scheduler can overlap chunk i's all-to-all with chunk j's local FFT
    compute (SURVEY §7 hard part (d)).  Requires a leading batch axis whose
    local size divides by the chunk count; numerics are identical.
    """
    x = jnp.asarray(x)
    n = x.shape[-1]
    p = mesh.shape[seq_axis]
    if n1 is None:
        n1, n2 = choose_split(n, p, config.max_stage)
    else:
        n2 = n // n1
        if n1 * n2 != n or n1 % p or n2 % p:
            raise ValueError(f"invalid split {n1}x{n2} of N={n} over {p} devices")

    sign = 1 if inverse else -1
    plan1 = get_plan(n1, sign, "complex", config)
    plan2 = get_plan(n2, sign, "complex", config)
    twr, twi = _split_twiddle_matrix(n1, n2, sign)
    twr = jnp.asarray(twr, dtype=config.dtype)
    twi = jnp.asarray(twi, dtype=config.dtype)

    nbatch = x.ndim - 1
    if overlap_chunks < 1:
        raise ValueError(f"overlap_chunks must be >= 1, got {overlap_chunks}")
    if overlap_chunks > 1 and nbatch == 0:
        raise ValueError(
            "overlap_chunks needs a leading batch axis to chunk; "
            "reshape the input to (batch, N) or pass overlap_chunks=1"
        )
    bspec = [None] * nbatch
    if data_axis is not None and nbatch:
        bspec[0] = data_axis
    spec_in = P(*bspec, seq_axis)  # contiguous shard of the signal axis
    spec_rows = P(*bspec, seq_axis, None)  # (n1, n2) matrix, rows sharded
    spec_cols = P(*bspec, None, seq_axis)  # columns sharded
    spec_tw = P(None, seq_axis)

    def pipeline(xr, xi, twr, twi):
        # entry: local (..., n1/P, n2) — rows sharded; reshard to columns
        a2a = partial(jax.lax.all_to_all, axis_name=seq_axis, tiled=True)
        xr = a2a(xr, split_axis=xr.ndim - 1, concat_axis=xr.ndim - 2)
        xi = a2a(xi, split_axis=xi.ndim - 1, concat_axis=xi.ndim - 2)
        # step 1: column FFTs (length n1) on local column block
        xr, xi = _local_fft_axis2(plan1, xr, xi)
        # step 2: split twiddle (local column block of W)
        xr, xi = xr * twr - xi * twi, xr * twi + xi * twr
        # reshard back to rows
        xr = a2a(xr, split_axis=xr.ndim - 2, concat_axis=xr.ndim - 1)
        xi = a2a(xi, split_axis=xi.ndim - 2, concat_axis=xi.ndim - 1)
        # step 3: row FFTs (length n2)
        xr, xi = _local_fft_last(plan2, xr, xi)
        # step 4: natural-order transpose X[k2·n1+k1] = A[k1,k2]
        xr = a2a(xr, split_axis=xr.ndim - 1, concat_axis=xr.ndim - 2)
        xi = a2a(xi, split_axis=xi.ndim - 1, concat_axis=xi.ndim - 2)
        xr = jnp.swapaxes(xr, -1, -2)
        xi = jnp.swapaxes(xi, -1, -2)
        shp = xr.shape[:-2] + (xr.shape[-2] * xr.shape[-1],)
        return xr.reshape(shp), xi.reshape(shp)

    sharded = jax.shard_map(
        _chunked(pipeline, overlap_chunks),
        mesh=mesh,
        in_specs=(spec_rows, spec_rows, spec_tw, spec_tw),
        out_specs=(spec_in, spec_in),
    )

    dtype = config.dtype
    if jnp.issubdtype(x.dtype, jnp.complexfloating):
        xr, xi = jnp.real(x).astype(dtype), jnp.imag(x).astype(dtype)
    else:
        xr = x.astype(dtype)
        xi = jnp.zeros_like(xr)
    mat = x.shape[:-1] + (n1, n2)
    zr, zi = sharded(xr.reshape(mat), xi.reshape(mat), twr, twi)

    from ..ops.fft import _norm_scale  # local import to avoid cycle

    scale = _norm_scale(n, sign, norm)
    if scale != 1.0:
        s = jnp.asarray(scale, dtype=zr.dtype)
        zr, zi = zr * s, zi * s
    return jax.lax.complex(zr, zi)


def ifft_four_step(x, mesh: Mesh, **kw) -> Array:
    """Inverse of :func:`fft_four_step` (same sharding contract)."""
    return fft_four_step(x, mesh, inverse=True, **kw)


# ---------------------------------------------------------------------------
# Scrambled-order four-step + distributed convolution.
#
# For spectral pipelines (convolution, filtering) the intermediate spectrum
# never needs natural order: leave it in the four-step's matrix layout
# Y[k1, k2] (k1 rows sharded), do the pointwise work there, and fold the
# ordering back in the inverse.  Saves one all-to-all per transform — a
# distributed convolution costs 4 all-to-alls instead of 6.
# ---------------------------------------------------------------------------

def _chunked(pipeline, chunks: int):
    """Wrap a per-shard (xr, xi, *consts) -> (yr, yi) pipeline with leading-
    batch-axis chunking: ``chunks`` independent sub-pipelines inside one
    shard_map give XLA's latency-hiding scheduler the freedom to overlap one
    chunk's collectives with another's local FFT compute."""
    if chunks == 1:
        return pipeline

    def body(xr, xi, *consts):
        if xr.ndim < 3:
            raise ValueError(
                "overlap_chunks needs a leading batch axis to chunk; "
                "reshape the input to (batch, N) or pass overlap_chunks=1"
            )
        if xr.shape[0] % chunks:
            raise ValueError(
                f"local batch {xr.shape[0]} must divide by overlap_chunks={chunks}"
            )
        outs = [
            pipeline(cr, ci, *consts)
            for cr, ci in zip(
                jnp.split(xr, chunks, axis=0), jnp.split(xi, chunks, axis=0)
            )
        ]
        return (
            jnp.concatenate([o[0] for o in outs], axis=0),
            jnp.concatenate([o[1] for o in outs], axis=0),
        )

    return body


def _prep_planes(x, config):
    x = jnp.asarray(x)
    if jnp.issubdtype(x.dtype, jnp.complexfloating):
        return jnp.real(x).astype(config.dtype), jnp.imag(x).astype(config.dtype)
    xr = x.astype(config.dtype)
    return xr, jnp.zeros_like(xr)


def _specs(nbatch: int, seq_axis: str, data_axis: Optional[str]):
    bspec = [None] * nbatch
    if data_axis is not None and nbatch:
        bspec[0] = data_axis
    return (
        P(*bspec, seq_axis, None),  # (n1, n2) rows sharded
        P(*bspec, None, seq_axis),  # cols sharded
    )


def fft_four_step_scrambled(
    x,
    mesh: Mesh,
    *,
    seq_axis: str = SEQ_AXIS,
    data_axis: Optional[str] = None,
    n1: Optional[int] = None,
    overlap_chunks: int = 1,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Forward FFT, output left in four-step matrix order: returns (..., n1, n2)
    with Y[k1, k2] = X[k2·n1 + k1], rows (k1) sharded over ``seq_axis``.
    Two all-to-alls.  ``overlap_chunks``: see :func:`fft_four_step`."""
    x = jnp.asarray(x)
    n = x.shape[-1]
    p = mesh.shape[seq_axis]
    if n1 is None:
        n1, n2 = choose_split(n, p, config.max_stage)
    else:
        n2 = n // n1
        if n1 * n2 != n or n1 % p or n2 % p:
            raise ValueError(f"invalid split {n1}x{n2} of N={n} over {p} devices")
    plan1 = get_plan(n1, -1, "complex", config)
    plan2 = get_plan(n2, -1, "complex", config)
    twr, twi = _split_twiddle_matrix(n1, n2, -1)
    twr = jnp.asarray(twr, dtype=config.dtype)
    twi = jnp.asarray(twi, dtype=config.dtype)

    nbatch = x.ndim - 1
    spec_rows, spec_cols = _specs(nbatch, seq_axis, data_axis)
    spec_tw = P(None, seq_axis)

    def body(xr, xi, twr, twi):
        a2a = partial(jax.lax.all_to_all, axis_name=seq_axis, tiled=True)
        xr = a2a(xr, split_axis=xr.ndim - 1, concat_axis=xr.ndim - 2)
        xi = a2a(xi, split_axis=xi.ndim - 1, concat_axis=xi.ndim - 2)
        xr, xi = _local_fft_axis2(plan1, xr, xi)
        xr, xi = xr * twr - xi * twi, xr * twi + xi * twr
        xr = a2a(xr, split_axis=xr.ndim - 2, concat_axis=xr.ndim - 1)
        xi = a2a(xi, split_axis=xi.ndim - 2, concat_axis=xi.ndim - 1)
        return _local_fft_last(plan2, xr, xi)

    sharded = jax.shard_map(
        _chunked(body, overlap_chunks),
        mesh=mesh,
        in_specs=(spec_rows, spec_rows, spec_tw, spec_tw),
        out_specs=(spec_rows, spec_rows),
    )
    xr, xi = _prep_planes(x, config)
    mat = x.shape[:-1] + (n1, n2)
    zr, zi = sharded(xr.reshape(mat), xi.reshape(mat), twr, twi)
    return jax.lax.complex(zr, zi)


def ifft_four_step_scrambled(
    y,
    mesh: Mesh,
    *,
    seq_axis: str = SEQ_AXIS,
    data_axis: Optional[str] = None,
    overlap_chunks: int = 1,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Inverse of :func:`fft_four_step_scrambled`: input (..., n1, n2) in
    Y[k1, k2] layout (rows sharded), output (..., N) natural order with the
    1/N normalization.  Two all-to-alls.

    Derivation: x[j1·n2 + j2] = 1/N Σ_{k1} W_{n1}^{+j1k1} W_N^{+j2k1}
    Σ_{k2} W_{n2}^{+j2k2} Y[k1, k2] — inverse row FFTs, transpose-reshard,
    twiddle, inverse column FFTs.
    """
    y = jnp.asarray(y)
    n1, n2 = y.shape[-2], y.shape[-1]
    n = n1 * n2
    p = mesh.shape[seq_axis]
    if n1 % p or n2 % p:
        raise ValueError(f"matrix {n1}x{n2} not divisible by mesh size {p}")
    plan1 = get_plan(n1, 1, "complex", config)
    plan2 = get_plan(n2, 1, "complex", config)
    twr, twi = _split_twiddle_matrix(n1, n2, 1)  # W_N^{+k1·j2}, shape (n1, n2)
    twr = jnp.asarray(twr, dtype=config.dtype)
    twi = jnp.asarray(twi, dtype=config.dtype)

    nbatch = y.ndim - 2
    spec_rows, spec_cols = _specs(nbatch, seq_axis, data_axis)
    bspec = [None] * nbatch
    if data_axis is not None and nbatch:
        bspec[0] = data_axis
    spec_flat = P(*bspec, seq_axis)
    spec_tw = P(None, seq_axis)

    def body(yr, yi, twr, twi):
        a2a = partial(jax.lax.all_to_all, axis_name=seq_axis, tiled=True)
        # inverse row FFTs (length n2) on k1-sharded rows
        yr, yi = _local_fft_last(plan2, yr, yi)
        # reshard so each device holds all k1 for its j2 block
        yr = a2a(yr, split_axis=yr.ndim - 1, concat_axis=yr.ndim - 2)
        yi = a2a(yi, split_axis=yi.ndim - 1, concat_axis=yi.ndim - 2)
        # twiddle W_N^{+j2·k1} (local j2 block of the (n1, n2) matrix)
        yr, yi = yr * twr - yi * twi, yr * twi + yi * twr
        # inverse column FFTs (length n1)
        yr, yi = _local_fft_axis2(plan1, yr, yi)
        # back to rows sharded: x[j1, j2], j1 rows — natural order flattened
        yr = a2a(yr, split_axis=yr.ndim - 2, concat_axis=yr.ndim - 1)
        yi = a2a(yi, split_axis=yi.ndim - 2, concat_axis=yi.ndim - 1)
        s = jnp.asarray(1.0 / n, dtype=yr.dtype)
        shp = yr.shape[:-2] + (yr.shape[-2] * yr.shape[-1],)
        return (yr * s).reshape(shp), (yi * s).reshape(shp)

    sharded = jax.shard_map(
        _chunked(body, overlap_chunks),
        mesh=mesh,
        in_specs=(spec_rows, spec_rows, spec_tw, spec_tw),
        out_specs=(spec_flat, spec_flat),
    )
    yr, yi = _prep_planes(y, config)
    zr, zi = sharded(yr, yi, twr, twi)
    return jax.lax.complex(zr, zi)


def fft_convolve_sharded(
    x,
    kernel: np.ndarray,
    mesh: Mesh,
    *,
    seq_axis: str = SEQ_AXIS,
    data_axis: Optional[str] = None,
    mode: str = "circular",
    overlap_chunks: int = 1,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Distributed FFT convolution of (..., N) signals with a fixed host-side
    kernel (filter taps).  BASELINE config 5's shape: long transforms, large
    batch, sharded over the mesh.  ``overlap_chunks``: see
    :func:`fft_four_step` (batch-chunked comm/compute overlap).

    ``mode='circular'``: circular convolution of length N (kernel zero-padded
    or wrapped to N).  ``mode='same'``: linear convolution truncated to N —
    implemented by zero-padding the signal axis to the next splittable
    length >= N + len(kernel) - 1 at the caller's layout cost.

    The kernel spectrum is computed at plan time on host (fp64) and consumed
    in the scrambled four-step layout, so the whole op costs 4 all-to-alls.
    """
    x = jnp.asarray(x)
    kernel = np.asarray(kernel)
    if kernel.ndim != 1:
        raise ValueError("kernel must be 1-D filter taps")
    n = x.shape[-1]
    p = mesh.shape[seq_axis]
    if mode == "same":
        m = next_splittable_len(n + len(kernel) - 1, p, config.max_stage)
        pad = [(0, 0)] * (x.ndim - 1) + [(0, m - n)]
        x = jnp.pad(x, pad)
    elif mode != "circular":
        raise ValueError(f"mode must be 'circular' or 'same', got {mode!r}")
    m = x.shape[-1]
    n1, n2 = choose_split(m, p, config.max_stage)

    # host-side kernel spectrum in the scrambled Y[k1, k2] layout
    kpad = np.zeros(m, dtype=np.float64)
    if len(kernel) > m:
        raise ValueError("kernel longer than transform length")
    kpad[: len(kernel)] = kernel
    kspec = np.fft.fft(kpad)  # natural order X[k], k = k2*n1 + k1
    kmat = kspec.reshape(n2, n1).T  # Y[k1, k2]
    kr = jnp.asarray(kmat.real, dtype=config.dtype)
    ki = jnp.asarray(kmat.imag, dtype=config.dtype)

    spec = fft_four_step_scrambled(
        x, mesh, seq_axis=seq_axis, data_axis=data_axis, n1=n1,
        overlap_chunks=overlap_chunks, config=config,
    )
    gain = jax.lax.complex(kr, ki)
    out = ifft_four_step_scrambled(
        spec * gain, mesh, seq_axis=seq_axis, data_axis=data_axis,
        overlap_chunks=overlap_chunks, config=config,
    )
    if mode == "same":
        start = (len(kernel) - 1) // 2
        out = out[..., start : start + n]
    return out


# ---------------------------------------------------------------------------
# Distributed real transforms: packed rfft/irfft over the four-step engine.
# ---------------------------------------------------------------------------

def rfft_four_step(
    x,
    mesh: Mesh,
    *,
    seq_axis: str = SEQ_AXIS,
    data_axis: Optional[str] = None,
    n1: Optional[int] = None,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Distributed real-input FFT: (..., N) real, N even, -> (..., N/2+1)
    complex bins.

    Packed scheme (ops/rfft.py's algebra) on top of the sharded complex
    four-step: the even/odd interleave is shard-local (a contiguous shard of
    the signal covers a contiguous range of the packed index), the half-length
    transform runs the four-step with its all-to-alls, and the split
    epilogue X = P⊙Z + Q⊙conj(reflect(Z)) runs at jit level on the sharded
    spectrum — the partitioner inserts the mirror's collective-permute.
    """
    x = jnp.asarray(x)
    if jnp.issubdtype(x.dtype, jnp.complexfloating):
        raise ValueError("rfft_four_step requires real input")
    n = x.shape[-1]
    if n % 2:
        raise ValueError(f"distributed rfft requires even length, got {n}")
    h = n // 2
    x = x.astype(config.dtype)
    z = jax.lax.complex(x[..., 0::2], x[..., 1::2])
    zc = fft_four_step(
        z, mesh, seq_axis=seq_axis, data_axis=data_axis, n1=n1, config=config
    )
    a = jnp.concatenate([zc, zc[..., :1]], axis=-1)  # Z[k mod h]
    b = jnp.conj(
        jnp.concatenate([zc[..., :1], jnp.flip(zc[..., 1:], -1), zc[..., :1]], -1)
    )  # conj(Z[(h-k) mod h])
    rp = get_plan(n, -1, "real", config)
    p = jax.lax.complex(jnp.asarray(rp.p_re), jnp.asarray(rp.p_im))
    q = jax.lax.complex(jnp.asarray(rp.q_re), jnp.asarray(rp.q_im))
    return p * a + q * b


def irfft_four_step(
    spec,
    mesh: Mesh,
    n: Optional[int] = None,
    *,
    seq_axis: str = SEQ_AXIS,
    data_axis: Optional[str] = None,
    n1: Optional[int] = None,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Inverse of :func:`rfft_four_step`: (..., N/2+1) Hermitian bins ->
    (..., N) real, with the 1/N normalization."""
    spec = jnp.asarray(spec)
    if n is None:
        n = 2 * (spec.shape[-1] - 1)
    if n % 2 or spec.shape[-1] != n // 2 + 1:
        raise ValueError(f"need n even and {n//2 + 1} bins, got {spec.shape[-1]}")
    h = n // 2
    a = spec[..., :h]
    b = jnp.conj(jnp.flip(spec[..., 1:], -1))  # conj(X[h-k]), k = 0..h-1
    rp = get_plan(n, 1, "real", config)
    p = jax.lax.complex(jnp.asarray(rp.p_re[:h]), jnp.asarray(rp.p_im[:h]))
    q = jax.lax.complex(jnp.asarray(rp.q_re[:h]), jnp.asarray(rp.q_im[:h]))
    z = p * a + q * b
    g = ifft_four_step(
        z, mesh, seq_axis=seq_axis, data_axis=data_axis, n1=n1, config=config
    )
    out = jnp.stack([jnp.real(g), jnp.imag(g)], axis=-1)
    return out.reshape(*g.shape[:-1], n)


# ---------------------------------------------------------------------------
# 2-D pencil decomposition: distributed fft2 over the last two axes.
# ---------------------------------------------------------------------------

def fft2_pencil(
    x,
    mesh: Mesh,
    *,
    seq_axis: str = SEQ_AXIS,
    data_axis: Optional[str] = None,
    inverse: bool = False,
    norm: Optional[str] = "backward",
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Distributed 2-D FFT of (..., H, W) with rows (H) sharded over
    ``seq_axis`` — the classic pencil scheme: local row FFTs (length W), one
    all-to-all transpose, local column FFTs (length H), transpose back.
    Two all-to-alls; both transform lengths must be smooth and H divisible by
    the mesh size (W too, for the tiled transpose).
    """
    x = jnp.asarray(x)
    h, w = x.shape[-2], x.shape[-1]
    p = mesh.shape[seq_axis]
    if h % p or w % p:
        raise ValueError(f"H={h} and W={w} must divide by mesh size {p}")
    sign = 1 if inverse else -1
    plan_w = get_plan(w, sign, "complex", config)
    plan_h = get_plan(h, sign, "complex", config)

    nbatch = x.ndim - 2
    bspec = [None] * nbatch
    if data_axis is not None and nbatch:
        bspec[0] = data_axis
    spec_rows = P(*bspec, seq_axis, None)

    def body(xr, xi):
        a2a = partial(jax.lax.all_to_all, axis_name=seq_axis, tiled=True)
        # local row FFTs along W
        xr, xi = _local_fft_last(plan_w, xr, xi)
        # transpose-reshard: (H/P, W) -> (H, W/P)
        xr = a2a(xr, split_axis=xr.ndim - 1, concat_axis=xr.ndim - 2)
        xi = a2a(xi, split_axis=xi.ndim - 1, concat_axis=xi.ndim - 2)
        # local column FFTs along H
        xr, xi = _local_fft_axis2(plan_h, xr, xi)
        # back to row sharding
        xr = a2a(xr, split_axis=xr.ndim - 2, concat_axis=xr.ndim - 1)
        xi = a2a(xi, split_axis=xi.ndim - 2, concat_axis=xi.ndim - 1)
        return xr, xi

    sharded = jax.shard_map(
        body, mesh=mesh, in_specs=(spec_rows, spec_rows),
        out_specs=(spec_rows, spec_rows),
    )
    xr, xi = _prep_planes(x, config)
    zr, zi = sharded(xr, xi)

    from ..ops.fft import _norm_scale

    scale = _norm_scale(h, sign, norm) * _norm_scale(w, sign, norm)
    if scale != 1.0:
        s = jnp.asarray(scale, dtype=zr.dtype)
        zr, zi = zr * s, zi * s
    return jax.lax.complex(zr, zi)


def ifft2_pencil(x, mesh: Mesh, **kw) -> Array:
    """Inverse of :func:`fft2_pencil`."""
    return fft2_pencil(x, mesh, inverse=True, **kw)


def fft_convolve2_sharded(
    x,
    kernel: np.ndarray,
    mesh: Mesh,
    *,
    seq_axis: str = SEQ_AXIS,
    data_axis: Optional[str] = None,
    mode: str = "circular",
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Distributed 2-D convolution of (..., H, W) images with a fixed host
    kernel, rows sharded over the mesh: fft2_pencil → pointwise gain →
    ifft2_pencil = 4 all-to-alls total.

    ``mode='circular'`` wraps at (H, W); ``mode='same'`` zero-pads to the next
    mesh-divisible size >= (H+kh-1, W+kw-1) and crops the centered window.
    """
    x = jnp.asarray(x)
    kernel = np.asarray(kernel)
    if kernel.ndim != 2:
        raise ValueError("kernel must be 2-D")
    h, w = x.shape[-2], x.shape[-1]
    p = mesh.shape[seq_axis]
    kh, kw = kernel.shape
    if mode == "same":
        th = -(-(h + kh - 1) // p) * p
        tw = -(-(w + kw - 1) // p) * p
        pad = [(0, 0)] * (x.ndim - 2) + [(0, th - h), (0, tw - w)]
        x = jnp.pad(x, pad)
    elif mode != "circular":
        raise ValueError(f"mode must be 'circular' or 'same', got {mode!r}")
    hh, ww = x.shape[-2], x.shape[-1]
    if hh % p or ww % p:
        raise ValueError(f"image {hh}x{ww} must divide by mesh size {p}")
    if kh > hh or kw > ww:
        raise ValueError("kernel larger than (padded) image")

    kpad = np.zeros((hh, ww), dtype=np.float64)
    kpad[:kh, :kw] = kernel
    kspec = np.fft.fft2(kpad)
    gr = jnp.asarray(kspec.real, dtype=config.dtype)
    gi = jnp.asarray(kspec.imag, dtype=config.dtype)

    spec = fft2_pencil(
        x, mesh, seq_axis=seq_axis, data_axis=data_axis, config=config
    )
    out = ifft2_pencil(
        spec * jax.lax.complex(gr, gi), mesh,
        seq_axis=seq_axis, data_axis=data_axis, config=config,
    )
    if mode == "same":
        si, sj = (kh - 1) // 2, (kw - 1) // 2
        out = out[..., si : si + h, sj : sj + w]
    return out


def fftn_pencil(
    x,
    mesh: Mesh,
    axes: Optional[Tuple[int, ...]] = None,
    *,
    seq_axis: str = SEQ_AXIS,
    data_axis: Optional[str] = None,
    shard_dim: int = -2,
    inverse: bool = False,
    norm: Optional[str] = "backward",
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Distributed N-D FFT over ``axes`` with one array dimension
    (``shard_dim``) sharded over ``seq_axis`` — the generalized pencil scheme.

    All transform axes other than ``shard_dim`` are local batched transforms;
    ``shard_dim`` (if it is a transform axis) is handled by one all-to-all
    transpose against the last axis, a local transform, and the transpose
    back.  For 3-D data over a mesh of devices this is the standard slab/pencil
    decomposition with 2 collectives total.
    """
    x = jnp.asarray(x)
    ndim = x.ndim
    if axes is None:
        axes = tuple(range(ndim))
    axes = tuple(a % ndim for a in axes)
    shard_dim = shard_dim % ndim
    if shard_dim == ndim - 1:
        raise ValueError("shard_dim must not be the last axis (the transpose partner)")
    p = mesh.shape[seq_axis]
    if x.shape[shard_dim] % p or x.shape[-1] % p:
        raise ValueError(
            f"shape[{shard_dim}]={x.shape[shard_dim]} and last axis "
            f"{x.shape[-1]} must divide by mesh size {p}"
        )
    sign = 1 if inverse else -1

    local_axes = [a for a in axes if a != shard_dim]
    plans = {a: get_plan(x.shape[a], sign, "complex", config) for a in axes}

    bspec = [None] * ndim
    if data_axis is not None:
        if shard_dim == 0 or 0 in axes:
            raise ValueError(
                "data_axis shards array axis 0 as a batch axis, so axis 0 "
                "must be neither shard_dim nor a transform axis (pass axes "
                "that exclude 0, e.g. axes=(1, 2) for batched 2-D transforms)"
            )
        bspec[0] = data_axis
    bspec[shard_dim] = seq_axis
    spec = P(*bspec)

    def _fft_axis(xr, xi, axis, plan):
        xr = jnp.moveaxis(xr, axis, -1)
        xi = jnp.moveaxis(xi, axis, -1)
        zr, zi = exec_complex(plan, xr, xi)
        return jnp.moveaxis(zr, -1, axis), jnp.moveaxis(zi, -1, axis)

    def body(xr, xi):
        for a in local_axes:
            xr, xi = _fft_axis(xr, xi, a, plans[a])
        if shard_dim in axes:
            a2a = partial(jax.lax.all_to_all, axis_name=seq_axis, tiled=True)
            xr = a2a(xr, split_axis=ndim - 1, concat_axis=shard_dim)
            xi = a2a(xi, split_axis=ndim - 1, concat_axis=shard_dim)
            xr, xi = _fft_axis(xr, xi, shard_dim, plans[shard_dim])
            xr = a2a(xr, split_axis=shard_dim, concat_axis=ndim - 1)
            xi = a2a(xi, split_axis=shard_dim, concat_axis=ndim - 1)
        return xr, xi

    sharded = jax.shard_map(body, mesh=mesh, in_specs=(spec, spec), out_specs=(spec, spec))
    xr, xi = _prep_planes(x, config)
    zr, zi = sharded(xr, xi)

    from ..ops.fft import _norm_scale

    scale = 1.0
    for a in axes:
        scale *= _norm_scale(x.shape[a], sign, norm)
    if scale != 1.0:
        s = jnp.asarray(scale, dtype=zr.dtype)
        zr, zi = zr * s, zi * s
    return jax.lax.complex(zr, zi)


def ifftn_pencil(x, mesh: Mesh, axes=None, **kw) -> Array:
    """Inverse of :func:`fftn_pencil`."""
    return fftn_pencil(x, mesh, axes, inverse=True, **kw)


# ---------------------------------------------------------------------------
# Batch sharding — many independent transforms over the mesh.
# ---------------------------------------------------------------------------

def shard_batch(x, mesh: Mesh, axis_name: str = DATA_AXIS) -> Array:
    """Place ``x`` with its leading axis sharded over ``axis_name``."""
    x = jnp.asarray(x)
    spec = P(axis_name, *([None] * (x.ndim - 1)))
    return jax.device_put(x, NamedSharding(mesh, spec))


def fft_batch_sharded(
    x,
    mesh: Mesh,
    axis_name: str = DATA_AXIS,
    *,
    inverse: bool = False,
    norm: Optional[str] = "backward",
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Batched FFT along the last axis with the batch sharded over the mesh.

    Zero collectives: every chip runs the same matmul pipeline on its batch
    shard.  The constraint system keeps the output on the same sharding.
    """
    from ..ops.fft import fft as _fft, ifft as _ifft

    x = shard_batch(x, mesh, axis_name)
    fn = _ifft if inverse else _fft
    out = fn(x, norm=norm, config=config)
    spec = P(axis_name, *([None] * (x.ndim - 1)))
    return jax.lax.with_sharding_constraint(out, NamedSharding(mesh, spec))


def fftn_pencil2(
    x,
    mesh: Mesh,
    *,
    data_axis: str = DATA_AXIS,
    seq_axis: str = SEQ_AXIS,
    inverse: bool = False,
    norm: Optional[str] = "backward",
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """3-D FFT with a TRUE 2-D pencil decomposition: BOTH mesh axes shard the
    volume (axis 0 over ``data_axis``, axis 1 over ``seq_axis``; axis 2 is the
    local pencil) — the P3DFFT layout for volumes too large for one chip in
    two dimensions.

    Four all-to-alls total: each axis FFT is a fully local transform after a
    resharding transpose, and two more collectives restore the input layout,
    so output sharding equals input sharding (natural order).  This is the
    2-D-mesh generalization of :func:`fftn_pencil` (which shards one array
    dim over one mesh axis).

    Constraints: n0 % P0 == 0, n1 % P1 == 0, n2 % (P0·P1) == 0 with
    P0 = mesh[data_axis], P1 = mesh[seq_axis].
    """
    x = jnp.asarray(x)
    if x.ndim != 3:
        raise ValueError(f"fftn_pencil2 expects a 3-D volume, got ndim={x.ndim}")
    n0, n1, n2 = x.shape
    p0 = mesh.shape[data_axis]
    p1 = mesh.shape[seq_axis]
    if n0 % p0 or n1 % p1 or n2 % (p0 * p1):
        raise ValueError(
            f"shape {x.shape} must satisfy n0 % {p0} == 0, n1 % {p1} == 0, "
            f"n2 % {p0 * p1} == 0 for the ({p0}, {p1}) pencil decomposition"
        )
    sign = 1 if inverse else -1
    plans = [get_plan(n, sign, "complex", config) for n in (n0, n1, n2)]
    spec = P(data_axis, seq_axis, None)

    def body(xr, xi):
        a2a_seq = partial(jax.lax.all_to_all, axis_name=seq_axis, tiled=True)
        a2a_dat = partial(jax.lax.all_to_all, axis_name=data_axis, tiled=True)
        # local (n0/P0, n1/P1, n2): FFT the full local axis 2
        xr, xi = _local_fft_last(plans[2], xr, xi)
        # gather axis 1 (scatter axis 2 over seq): FFT axis 1
        xr = a2a_seq(xr, split_axis=2, concat_axis=1)
        xi = a2a_seq(xi, split_axis=2, concat_axis=1)
        xr, xi = _local_fft_axis2(plans[1], xr, xi)
        # gather axis 0 (scatter axis 2 further over data): FFT axis 0
        xr = a2a_dat(xr, split_axis=2, concat_axis=0)
        xi = a2a_dat(xi, split_axis=2, concat_axis=0)
        xr = jnp.moveaxis(xr, 0, -1)
        xi = jnp.moveaxis(xi, 0, -1)
        xr, xi = _local_fft_last(plans[0], xr, xi)
        xr = jnp.moveaxis(xr, -1, 0)
        xi = jnp.moveaxis(xi, -1, 0)
        # restore the input layout: reverse the two resharding transposes
        xr = a2a_dat(xr, split_axis=0, concat_axis=2)
        xi = a2a_dat(xi, split_axis=0, concat_axis=2)
        xr = a2a_seq(xr, split_axis=1, concat_axis=2)
        xi = a2a_seq(xi, split_axis=1, concat_axis=2)
        return xr, xi

    sharded = jax.shard_map(body, mesh=mesh, in_specs=(spec, spec), out_specs=(spec, spec))
    xr, xi = _prep_planes(x, config)
    zr, zi = sharded(xr, xi)

    from ..ops.fft import _norm_scale

    scale = 1.0
    for n in (n0, n1, n2):
        scale *= _norm_scale(n, sign, norm)
    if scale != 1.0:
        s = jnp.asarray(scale, dtype=zr.dtype)
        zr, zi = zr * s, zi * s
    return jax.lax.complex(zr, zi)


def ifftn_pencil2(x, mesh: Mesh, **kw) -> Array:
    """Inverse of :func:`fftn_pencil2`."""
    return fftn_pencil2(x, mesh, inverse=True, **kw)


def rfftn_pencil2(
    x,
    mesh: Mesh,
    *,
    data_axis: str = DATA_AXIS,
    seq_axis: str = SEQ_AXIS,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Real-input 3-D FFT on the 2-D pencil decomposition: (n0, n1, n2) real,
    axis 0 sharded over ``data_axis``, axis 1 over ``seq_axis`` →
    (n0, n1, n2//2+1) complex, same sharding.

    The rfft runs on the local pencil axis; the half-spectrum bin count
    (n2//2+1) rarely divides the mesh, so bins are zero-padded to the next
    multiple of P0·P1 for the resharding transposes and sliced back at the
    end.  Four all-to-alls, like :func:`fftn_pencil2`.
    """
    x = jnp.asarray(x)
    if x.ndim != 3:
        raise ValueError(f"rfftn_pencil2 expects a 3-D volume, got ndim={x.ndim}")
    if jnp.issubdtype(x.dtype, jnp.complexfloating):
        raise ValueError("rfftn_pencil2 requires real input")
    n0, n1, n2 = x.shape
    p0 = mesh.shape[data_axis]
    p1 = mesh.shape[seq_axis]
    if n0 % p0 or n1 % p1 or n2 % 2:
        raise ValueError(
            f"shape {x.shape} needs n0 % {p0} == 0, n1 % {p1} == 0, even n2"
        )
    h = n2 // 2 + 1
    pp = p0 * p1
    hp = -(-h // pp) * pp
    plan0 = get_plan(n0, -1, "complex", config)
    plan1 = get_plan(n1, -1, "complex", config)
    spec = P(data_axis, seq_axis, None)

    from ..ops.rfft import rfft as _rfft

    def body(xs):
        a2a_seq = partial(jax.lax.all_to_all, axis_name=seq_axis, tiled=True)
        a2a_dat = partial(jax.lax.all_to_all, axis_name=data_axis, tiled=True)
        z = _rfft(xs, config=config)  # local pencil: (n0/P0, n1/P1, h) complex
        xr = jnp.real(z).astype(config.dtype)
        xi = jnp.imag(z).astype(config.dtype)
        pad = [(0, 0), (0, 0), (0, hp - h)]
        xr, xi = jnp.pad(xr, pad), jnp.pad(xi, pad)
        # gather axes 1 then 0 (scatter the padded bins over both mesh axes)
        xr = a2a_seq(xr, split_axis=2, concat_axis=1)
        xi = a2a_seq(xi, split_axis=2, concat_axis=1)
        xr = a2a_dat(xr, split_axis=2, concat_axis=0)
        xi = a2a_dat(xi, split_axis=2, concat_axis=0)
        # both leading axes full locally: transform them
        xr, xi = _local_fft_axis2(plan1, xr, xi)
        xr = jnp.moveaxis(xr, 0, -1)
        xi = jnp.moveaxis(xi, 0, -1)
        xr, xi = _local_fft_last(plan0, xr, xi)
        xr = jnp.moveaxis(xr, -1, 0)
        xi = jnp.moveaxis(xi, -1, 0)
        # restore the input layout
        xr = a2a_dat(xr, split_axis=0, concat_axis=2)
        xi = a2a_dat(xi, split_axis=0, concat_axis=2)
        xr = a2a_seq(xr, split_axis=1, concat_axis=2)
        xi = a2a_seq(xi, split_axis=1, concat_axis=2)
        return xr[..., :h], xi[..., :h]

    sharded = jax.shard_map(body, mesh=mesh, in_specs=(spec,), out_specs=(spec, spec))
    zr, zi = sharded(x.astype(config.dtype))
    return jax.lax.complex(zr, zi)


def irfftn_pencil2(
    y,
    mesh: Mesh,
    n2: Optional[int] = None,
    *,
    data_axis: str = DATA_AXIS,
    seq_axis: str = SEQ_AXIS,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Inverse of :func:`rfftn_pencil2`: (n0, n1, n2//2+1) complex →
    (n0, n1, n2) real, same pencil sharding, 1/(n0·n1·n2) normalization."""
    y = jnp.asarray(y)
    if y.ndim != 3:
        raise ValueError(f"irfftn_pencil2 expects a 3-D spectrum, got ndim={y.ndim}")
    n0, n1, h = y.shape
    n2 = int(n2) if n2 is not None else 2 * (h - 1)
    if n2 // 2 + 1 != h:
        raise ValueError(f"n2={n2} inconsistent with {h} bins")
    p0 = mesh.shape[data_axis]
    p1 = mesh.shape[seq_axis]
    if n0 % p0 or n1 % p1:
        raise ValueError(f"shape {y.shape} needs n0 % {p0} == 0, n1 % {p1} == 0")
    pp = p0 * p1
    hp = -(-h // pp) * pp
    plan0 = get_plan(n0, 1, "complex", config)
    plan1 = get_plan(n1, 1, "complex", config)
    spec = P(data_axis, seq_axis, None)

    from ..ops.rfft import irfft as _irfft

    def body(yr, yi):
        a2a_seq = partial(jax.lax.all_to_all, axis_name=seq_axis, tiled=True)
        a2a_dat = partial(jax.lax.all_to_all, axis_name=data_axis, tiled=True)
        pad = [(0, 0), (0, 0), (0, hp - h)]
        yr, yi = jnp.pad(yr, pad), jnp.pad(yi, pad)
        yr = a2a_seq(yr, split_axis=2, concat_axis=1)
        yi = a2a_seq(yi, split_axis=2, concat_axis=1)
        yr = a2a_dat(yr, split_axis=2, concat_axis=0)
        yi = a2a_dat(yi, split_axis=2, concat_axis=0)
        # inverse transforms over the gathered leading axes (unnormalized
        # inverse plans; fold 1/(n0*n1) afterwards)
        yr, yi = _local_fft_axis2(plan1, yr, yi)
        yr = jnp.moveaxis(yr, 0, -1)
        yi = jnp.moveaxis(yi, 0, -1)
        yr, yi = _local_fft_last(plan0, yr, yi)
        yr = jnp.moveaxis(yr, -1, 0)
        yi = jnp.moveaxis(yi, -1, 0)
        yr = a2a_dat(yr, split_axis=0, concat_axis=2)
        yi = a2a_dat(yi, split_axis=0, concat_axis=2)
        yr = a2a_seq(yr, split_axis=1, concat_axis=2)
        yi = a2a_seq(yi, split_axis=1, concat_axis=2)
        s = jnp.asarray(1.0 / (n0 * n1), dtype=yr.dtype)
        z = jax.lax.complex(yr[..., :h] * s, yi[..., :h] * s)
        return (_irfft(z, n=n2, config=config),)

    sharded = jax.shard_map(body, mesh=mesh, in_specs=(spec, spec), out_specs=(spec,))
    yr = jnp.real(y).astype(config.dtype)
    yi = jnp.imag(y).astype(config.dtype)
    return sharded(yr, yi)[0]


def poisson_solve_pencil2(
    f,
    mesh: Mesh,
    period=2.0 * np.pi,
    *,
    data_axis: str = DATA_AXIS,
    seq_axis: str = SEQ_AXIS,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Distributed periodic Poisson solve ∇²u = f on the 2-D pencil: the
    spectral multiplier −1/|k|² applies to the naturally-ordered sharded
    spectrum of :func:`rfftn_pencil2` as a partitioned elementwise op, so the
    whole solve costs exactly the 8 all-to-alls of the two transforms.
    Mirrors :func:`ops.signal.poisson_solve` (zero-mean solution)."""
    f = jnp.asarray(f)
    if f.ndim != 3:
        raise ValueError(f"poisson_solve_pencil2 expects a 3-D field, got {f.ndim}-D")
    n0, n1, n2 = f.shape
    periods = np.broadcast_to(np.asarray(period, np.float64), (3,))
    k0 = 2.0 * np.pi * np.fft.fftfreq(n0, 1.0 / n0) / periods[0]
    k1 = 2.0 * np.pi * np.fft.fftfreq(n1, 1.0 / n1) / periods[1]
    k2 = 2.0 * np.pi * np.arange(n2 // 2 + 1, dtype=np.float64) / periods[2]
    ksq = (
        (k0 ** 2)[:, None, None]
        + (k1 ** 2)[None, :, None]
        + (k2 ** 2)[None, None, :]
    )
    inv = np.where(ksq > 0, -1.0 / np.where(ksq > 0, ksq, 1.0), 0.0)

    spec = rfftn_pencil2(f, mesh, data_axis=data_axis, seq_axis=seq_axis,
                         config=config)
    spec = spec * jnp.asarray(inv, dtype=jnp.real(spec).dtype)
    return irfftn_pencil2(spec, mesh, n2=n2, data_axis=data_axis,
                          seq_axis=seq_axis, config=config)


# ---------------------------------------------------------------------------
# Distributed NUFFT: points sharded over the mesh.  The natural parallel
# decomposition for non-uniform data is by POINTS (each chip grids / reads
# its own subset); the uniform-grid work is a single small engine FFT.
# Type 1: local Gaussian spread -> one psum of the oversampled grid
# -> replicated FFT + deconvolution.  Type 2: replicated deconvolve + FFT ->
# each chip interpolates only its local points (zero collectives after the
# broadcast).  Point counts that do not divide the mesh are zero-padded
# (zero-strength points spread nothing; padded outputs are trimmed).
# ---------------------------------------------------------------------------


def nufft1_sharded(
    x,
    c,
    n_modes: int,
    mesh: Mesh,
    axis_name: str = SEQ_AXIS,
    *,
    isign: int = -1,
    eps: float = 1e-6,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Type-1 NUFFT with the point set sharded over ``axis_name``.

    (…, M) strengths + (M,) points -> replicated (…, n_modes) centered modes.
    One collective: a psum of the (…, sigma·N) oversampled grid after local
    spreading — the non-uniform analogue of the four-step's all-to-all.
    """
    from ..ops.fft import fft as _fft
    from ..ops.nufft import _center, _deconv, _grid_params, _spread

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
    parts = mesh.shape[axis_name]
    pad = (-x.shape[0]) % parts
    if pad:  # zero-strength points contribute nothing to the spread
        x = jnp.concatenate([x, jnp.zeros((pad,), x.dtype)])
        widths = [(0, 0)] * (c.ndim - 1) + [(0, pad)]
        c = jnp.pad(c, widths)
    if isign > 0:
        x = -x
    mr, tau, msp = _grid_params(n_modes, eps)
    deconv = _deconv(n_modes, mr, tau)

    def body(xl, cl):
        grid = jax.lax.psum(_spread(xl, cl, mr, tau, msp), axis_name)
        centered = _center(_fft(grid, config=config), mr, n_modes)
        return centered * jnp.asarray(deconv, dtype=centered.real.dtype)

    pt_spec = P(axis_name)
    c_spec = P(*([None] * (c.ndim - 1) + [axis_name]))
    out_spec = P(*([None] * c.ndim))
    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(pt_spec, c_spec),
        out_specs=out_spec,
    )(x, c)


def nufft2_sharded(
    x,
    f,
    mesh: Mesh,
    axis_name: str = SEQ_AXIS,
    *,
    isign: int = +1,
    eps: float = 1e-6,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Type-2 NUFFT with the evaluation points sharded over ``axis_name``.

    Replicated (…, n_modes) modes -> (…, M) values, point axis sharded in
    compute and concatenated (then trimmed) on output.  Zero collectives:
    every chip runs the same small deconvolve+FFT and interpolates only its
    own points.
    """
    from ..ops.fft import ifft as _ifft
    from ..ops.nufft import _deconv, _grid_params, _interp, _wrap

    x = jnp.asarray(x)
    f = jnp.asarray(f)
    if x.ndim != 1 or x.shape[0] < 1:
        raise ValueError("x must be a non-empty 1-D point array")
    n_modes = f.shape[-1]
    if n_modes < 1:
        raise ValueError("f must be non-empty along the mode axis")
    m_out = x.shape[0]
    parts = mesh.shape[axis_name]
    pad = (-m_out) % parts
    if pad:
        x = jnp.concatenate([x, jnp.zeros((pad,), x.dtype)])
    if isign < 0:
        x = -x
    mr, tau, msp = _grid_params(n_modes, eps)
    deconv = _deconv(n_modes, mr, tau)

    def body(xl):
        fd = f * jnp.asarray(deconv, dtype=f.real.dtype)
        u = _ifft(_wrap(fd, mr), config=config) * mr
        return _interp(u, xl, mr, tau, msp)

    out = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(axis_name),),
        out_specs=P(*([None] * (f.ndim - 1) + [axis_name])),
    )(x)
    return out[..., :m_out] if pad else out



def nufft1_2d_sharded(
    x,
    y,
    c,
    n_modes,
    mesh: Mesh,
    axis_name: str = SEQ_AXIS,
    *,
    isign: int = -1,
    eps: float = 1e-6,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """2-D type-1 NUFFT with the point set sharded over ``axis_name``
    (the distributed MRI-gridding shape): (…, M) strengths + (M,) x/y ->
    replicated (…, n1, n2) centered modes.  One collective: a psum of the
    oversampled 2-D grid after local block-matmul spreading."""
    from ..ops.fft import fft2 as _fft2
    from ..ops.nufft import _center, _deconv, _grid_params, _spread_2d

    x = jnp.asarray(x)
    y = jnp.asarray(y)
    c = jnp.asarray(c)
    if x.ndim != 1 or x.shape[0] < 1 or x.shape != y.shape:
        raise ValueError("x and y must be equal-length non-empty 1-D arrays")
    if c.shape[-1] != x.shape[0]:
        raise ValueError(
            f"strengths last axis {c.shape[-1]} != number of points {x.shape[0]}"
        )
    n1, n2 = int(n_modes[0]), int(n_modes[1])
    if n1 < 1 or n2 < 1:
        raise ValueError(f"n_modes must be positive, got {n_modes}")
    parts = mesh.shape[axis_name]
    pad = (-x.shape[0]) % parts
    if pad:  # zero-strength points contribute nothing to the spread
        x = jnp.concatenate([x, jnp.zeros((pad,), x.dtype)])
        y = jnp.concatenate([y, jnp.zeros((pad,), y.dtype)])
        widths = [(0, 0)] * (c.ndim - 1) + [(0, pad)]
        c = jnp.pad(c, widths)
    if isign > 0:
        x, y = -x, -y
    mr1, tau1, msp = _grid_params(n1, eps)
    mr2, tau2, _ = _grid_params(n2, eps)
    deconv = np.outer(_deconv(n1, mr1, tau1), _deconv(n2, mr2, tau2))

    def body(xl, yl, cl):
        grid = jax.lax.psum(
            _spread_2d(xl, yl, cl, (mr1, mr2), (tau1, tau2), msp), axis_name
        )
        spec = _fft2(grid, config=config)
        centered = _center(_center(spec, mr1, n1, axis=-2), mr2, n2)
        return centered * jnp.asarray(deconv, dtype=centered.real.dtype)

    pt_spec = P(axis_name)
    c_spec = P(*([None] * (c.ndim - 1) + [axis_name]))
    out_spec = P(*([None] * (c.ndim + 1)))
    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(pt_spec, pt_spec, c_spec),
        out_specs=out_spec,
    )(x, y, c)


def nufft2_2d_sharded(
    x,
    y,
    f,
    mesh: Mesh,
    axis_name: str = SEQ_AXIS,
    *,
    isign: int = +1,
    eps: float = 1e-6,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """2-D type-2 NUFFT with the evaluation points sharded over
    ``axis_name``: replicated (…, n1, n2) modes -> (…, M) values.  Zero
    collectives — every chip runs the same deconvolve + fft2 and
    interpolates only its own points."""
    from ..ops.fft import ifft2 as _ifft2
    from ..ops.nufft import _deconv, _grid_params, _interp_2d, _wrap

    x = jnp.asarray(x)
    y = jnp.asarray(y)
    f = jnp.asarray(f)
    if x.ndim != 1 or x.shape[0] < 1 or x.shape != y.shape:
        raise ValueError("x and y must be equal-length non-empty 1-D arrays")
    if f.ndim < 2 or f.shape[-1] < 1 or f.shape[-2] < 1:
        raise ValueError("f must be (…, n1, n2) with non-empty mode axes")
    n1, n2 = f.shape[-2], f.shape[-1]
    m_out = x.shape[0]
    parts = mesh.shape[axis_name]
    pad = (-m_out) % parts
    if pad:
        x = jnp.concatenate([x, jnp.zeros((pad,), x.dtype)])
        y = jnp.concatenate([y, jnp.zeros((pad,), y.dtype)])
    if isign < 0:
        x, y = -x, -y
    mr1, tau1, msp = _grid_params(n1, eps)
    mr2, tau2, _ = _grid_params(n2, eps)
    deconv = np.outer(_deconv(n1, mr1, tau1), _deconv(n2, mr2, tau2))

    def body(xl, yl):
        fd = f * jnp.asarray(deconv, dtype=f.real.dtype)
        u = _ifft2(_wrap(_wrap(fd, mr1, axis=-2), mr2), config=config) * (
            mr1 * mr2
        )
        return _interp_2d(u, xl, yl, (mr1, mr2), (tau1, tau2), msp)

    out = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(axis_name), P(axis_name)),
        out_specs=P(*([None] * (f.ndim - 2) + [axis_name])),
    )(x, y)
    return out[..., :m_out] if pad else out


# ---------------------------------------------------------------------------
# Distributed spherical harmonic transform: latitude bands sharded over the
# mesh.  The longitude FFT is per-latitude (local to each band); analysis
# contracts the Legendre tables over latitude, so each chip reduces its own
# band and one psum completes the quadrature.  Synthesis needs no
# collectives at all: each chip evaluates its latitude band from the
# replicated coefficients.
# ---------------------------------------------------------------------------


def sht_sharded(
    f,
    mesh: Mesh,
    axis_name: str = SEQ_AXIS,
    *,
    grid: str = "gauss",
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Spherical harmonic analysis with latitude sharded over ``axis_name``:
    grid values -> replicated (…, 2L-1, L) coefficients, one psum
    ((…, L, 2L) for grid="gauss", square (…, 2L, 2L) equiangular)."""
    import math as _math

    from ..ops.fft import fft as _fft
    from ..ops.sht import _analyze, _grid_arrays, _legendre_chunks, _select_packed_m

    f = jnp.asarray(f)
    if grid == "equiangular":
        if (
            f.ndim < 2 or f.shape[-1] < 2 or f.shape[-2] != f.shape[-1]
            or f.shape[-1] % 2
        ):
            raise ValueError("equiangular f must be even-square (…, 2L, 2L)")
        L = f.shape[-1] // 2
    else:
        if f.ndim < 2 or f.shape[-2] < 1 or f.shape[-1] != 2 * f.shape[-2]:
            raise ValueError("f must be (…, L, 2L) on the sht_grid")
        L = f.shape[-2]
    parts = mesh.shape[axis_name]
    if f.shape[-2] % parts != 0:
        raise ValueError(
            f"mesh axis size {parts} must divide the latitude count "
            f"{f.shape[-2]}"
        )
    chunks = _legendre_chunks(L, grid)
    m0s = tuple(m0 for m0, _ in chunks)
    _, w, _ = _grid_arrays(L, grid)
    wdphi = (w * (2.0 * _math.pi / (2 * L))).astype(np.float32)
    hermitian = not jnp.issubdtype(f.dtype, jnp.complexfloating)

    def body(fl, wl, *tabs):
        # each chip holds its latitude band of every triangular chunk; the
        # per-band quadrature contraction completes with one psum.
        # Real fields ride the Hermitian fast path (rfft + conj fold, half
        # the Legendre work — the fold is linear, so folding before the
        # psum is exact).
        if hermitian:
            from ..ops.rfft import rfft as _rfft

            fsel = _rfft(fl, config=config)[..., :L]
        else:
            fsel = _select_packed_m(_fft(fl, config=config), L)
        part = _analyze(
            tuple(zip(m0s, tabs)), fsel, wl, L, config, hermitian=hermitian
        )
        return jax.lax.psum(part, axis_name)

    lat_spec = P(*([None] * (f.ndim - 2) + [axis_name, None]))
    out_spec = P(*([None] * f.ndim))
    tab_specs = tuple(P(None, None, axis_name) for _ in chunks)
    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(lat_spec, P(axis_name)) + tab_specs,
        out_specs=out_spec,
    )(f, wdphi, *(t for _, t in chunks))


def isht_sharded(
    alm,
    mesh: Mesh,
    axis_name: str = SEQ_AXIS,
    *,
    grid: str = "gauss",
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Spherical harmonic synthesis with latitude bands sharded over
    ``axis_name``: replicated (…, 2L-1, L) coefficients -> grid values
    ((…, L, 2L) gauss, (…, 2L, 2L) equiangular) sharded on latitude.
    Zero collectives (each chip evaluates its band)."""
    from ..ops.sht import _legendre_chunks, _synthesize  # noqa: F401

    alm = jnp.asarray(alm)
    if alm.ndim < 2 or alm.shape[-1] < 1 or alm.shape[-2] != 2 * alm.shape[-1] - 1:
        raise ValueError("alm must be (…, 2L-1, L) packed coefficients")
    L = alm.shape[-1]
    parts = mesh.shape[axis_name]
    nlat = L if grid == "gauss" else 2 * L
    if nlat % parts != 0:
        raise ValueError(
            f"mesh axis size {parts} must divide the latitude count {nlat}"
        )
    chunks = _legendre_chunks(L, grid)
    m0s = tuple(m0 for m0, _ in chunks)

    def body(*tabs):
        # each chip synthesizes its own latitude band — zero collectives
        return _synthesize(tuple(zip(m0s, tabs)), alm, config)

    out_spec = P(*([None] * (alm.ndim - 2) + [axis_name, None]))
    tab_specs = tuple(P(None, None, axis_name) for _ in chunks)
    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=tab_specs,
        out_specs=out_spec,
    )(*(t for _, t in chunks))


def sht_recurrence_sharded(
    f,
    mesh: Mesh,
    axis_name: str = SEQ_AXIS,
    *,
    compensated: bool = False,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Latitude-sharded on-device-recurrence spherical analysis: the scan's
    Legendre planes shrink to (L, L/parts) per chip (each chip scans only
    its own latitude band — the recurrence is independent per latitude) and
    one psum completes the quadrature.  NOTE the (…, 2L-1, L) coefficient
    accumulator itself stays O(L²) per chip (it spans all degrees); the
    memory win vs the table path is the absent ~L³/2 table, not the
    accumulator."""
    import math as _math

    from ..ops.fft import fft as _fft
    from ..ops.rfft import rfft as _rfft
    from ..ops.sht import (
        _fold_neg_last, _gauss_grid, _rec_analyze_core, _rec_pack,
        _recurrence_coeffs, _recurrence_coeffs_dw, _select_packed_m,
    )

    f = jnp.asarray(f)
    if f.ndim < 2 or f.shape[-2] < 1 or f.shape[-1] != 2 * f.shape[-2]:
        raise ValueError("f must be (…, L, 2L) on the sht_grid")
    L = f.shape[-2]
    parts = mesh.shape[axis_name]
    if L % parts != 0:
        raise ValueError(
            f"mesh axis size {parts} must divide the latitude count L={L}"
        )
    _, _, mant, k0, mu = _recurrence_coeffs(L)
    _, w, _ = _gauss_grid(L)
    wdphi = (w * (2.0 * _math.pi / (2 * L))).astype(np.float32)
    hermitian = not jnp.issubdtype(f.dtype, jnp.complexfloating)
    if compensated:
        _, _, mant_lo, mu_lo = _recurrence_coeffs_dw(L)
        lo_ops = (jnp.asarray(mu_lo), jnp.asarray(mant_lo))
        lo_specs = (P(axis_name), P(None, axis_name))
    else:
        lo_ops, lo_specs = (), ()

    def body(fl, mul, mantl, kl, wl, *lo):
        if hermitian:
            fw = _rfft(fl, config=config)[..., :L] * wl[:, None]
            srcs = fw[None]
        else:
            fw = _select_packed_m(_fft(fl, config=config), L) * wl[:, None]
            srcs = jnp.stack([fw[..., :L], _fold_neg_last(fw, L)])
        acc = _rec_analyze_core(
            srcs, L, config, lat=(mul, mantl, kl) + lo,
            compensated=compensated,
        )
        acc = jax.lax.psum(acc, axis_name)
        return _rec_pack(acc, L, hermitian)

    lat_spec = P(*([None] * (f.ndim - 2) + [axis_name, None]))
    out_spec = P(*([None] * f.ndim))
    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(lat_spec, P(axis_name), P(None, axis_name),
                  P(None, axis_name), P(axis_name)) + lo_specs,
        out_specs=out_spec,
    )(f, jnp.asarray(mu), jnp.asarray(mant), jnp.asarray(k0),
      jnp.asarray(wdphi), *lo_ops)


def isht_recurrence_sharded(
    alm,
    mesh: Mesh,
    axis_name: str = SEQ_AXIS,
    *,
    real_output: bool = False,
    compensated: bool = False,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Latitude-sharded on-device-recurrence spherical synthesis: zero
    collectives; scan planes are (L, L/parts) per chip, while the
    replicated coefficient input is O(L²) (see the analysis note)."""
    from ..ops.fft import ifft as _ifft
    from ..ops.rfft import irfft as _irfft
    from ..ops.sht import (
        _neg_signs, _rec_synth_core, _recurrence_coeffs,
        _recurrence_coeffs_dw,
    )

    alm = jnp.asarray(alm)
    if alm.ndim < 2 or alm.shape[-1] < 1 or alm.shape[-2] != 2 * alm.shape[-1] - 1:
        raise ValueError("alm must be (…, 2L-1, L) packed coefficients")
    L = alm.shape[-1]
    parts = mesh.shape[axis_name]
    if L % parts != 0:
        raise ValueError(
            f"mesh axis size {parts} must divide the latitude count L={L}"
        )
    _, _, mant, k0, mu = _recurrence_coeffs(L)
    if compensated:
        _, _, mant_lo, mu_lo = _recurrence_coeffs_dw(L)
        lo_ops = (jnp.asarray(mu_lo), jnp.asarray(mant_lo))
        lo_specs = (P(axis_name), P(None, axis_name))
    else:
        lo_ops, lo_specs = (), ()
    apos = alm[..., :L, :]
    if real_output:
        srcs = apos[None]
    else:
        half = jnp.flip(alm[..., L:, :], axis=-2)
        z = jnp.zeros(alm.shape[:-2] + (1, L), alm.dtype)
        sign = jnp.asarray(_neg_signs(L), alm.real.dtype)
        srcs = jnp.stack(
            [apos, jnp.concatenate([z, half], axis=-2) * sign[:, None]]
        )
    nlon = 2 * L

    def body(mul, mantl, kl, *lo):
        g = _rec_synth_core(
            srcs, L, config, lat=(mul, mantl, kl) + lo,
            compensated=compensated,
        )
        gpos = g[0]
        zeros = jnp.zeros(gpos.shape[:-1] + (1,), gpos.dtype)
        if real_output:
            bins = jnp.concatenate([gpos, zeros], axis=-1)
            return _irfft(bins, n=nlon, config=config) * nlon
        bins = jnp.concatenate(
            [gpos, zeros, jnp.flip(g[1][..., 1:], axis=-1)], axis=-1
        )
        return _ifft(bins, config=config) * nlon

    out_spec = P(*([None] * (alm.ndim - 2) + [axis_name, None]))
    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(axis_name), P(None, axis_name), P(None, axis_name))
        + lo_specs,
        out_specs=out_spec,
    )(jnp.asarray(mu), jnp.asarray(mant), jnp.asarray(k0), *lo_ops)


def kalman_filter_sharded(
    F,
    Q,
    H,
    R,
    m0,
    P0,
    ys,
    mesh: Mesh,
    axis_name: str = DATA_AXIS,
    *,
    smooth: bool = False,
    config: SpectralConfig = DEFAULT_CONFIG,
):
    """Multi-target tracking: the parallel-in-time Kalman filter (or RTS
    smoother with ``smooth=True``) vmapped over a BATCH of independent
    observation sequences ``ys`` (B, T, d_obs), the batch sharded over the
    mesh.  Zero collectives — each chip runs the log-depth associative
    scans on its shard of tracks; the model (F, Q, H, R, m0, P0) is shared.
    Returns (means (B, T, d), covs (B, T, d, d)) with the batch sharding
    preserved.
    """
    from ..ops.kalman import kalman_filter, kalman_smoother

    ys = jnp.asarray(ys)
    if ys.ndim != 3:
        raise ValueError("ys must be (batch, T, d_obs)")
    ys = shard_batch(ys, mesh, axis_name)
    fn = kalman_smoother if smooth else kalman_filter

    def one(seq):
        return fn(F, Q, H, R, m0, P0, seq, parallel=True, config=config)

    ms, Ps = jax.vmap(one)(ys)
    spec_m = P(axis_name, None, None)
    spec_P = P(axis_name, None, None, None)
    return (
        jax.lax.with_sharding_constraint(ms, NamedSharding(mesh, spec_m)),
        jax.lax.with_sharding_constraint(Ps, NamedSharding(mesh, spec_P)),
    )


def pfb_analysis_sharded(
    x,
    n_channels: int,
    mesh: Mesh,
    axis_name: str = DATA_AXIS,
    *,
    taps_per_branch: int = 8,
    window: str = "hamming",
    h: Optional[np.ndarray] = None,
    hop: Optional[int] = None,
    mode: str = "valid",
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Batch-sharded K-channel PFB channelization: (batch, T) signals laid
    out over the mesh, each chip channelizing its own shard (zero
    collectives — the polyphase weighting and the length-K engine FFT are
    independent per signal).  This is the multi-beam / multi-antenna
    receiver layout: one chip per group of RF streams.  Returns
    (batch, frames, K) with the batch sharding preserved."""
    from ..ops.pfb import pfb_analysis

    x = jnp.asarray(x)
    if x.ndim != 2:
        raise ValueError("pfb_analysis_sharded expects (batch, T) signals")
    parts = mesh.shape[axis_name]
    if x.shape[0] % parts != 0:
        raise ValueError(
            f"batch {x.shape[0]} must divide over mesh axis "
            f"{axis_name!r} ({parts})"
        )
    x = shard_batch(x, mesh, axis_name)

    def body(xl):
        return pfb_analysis(
            xl, n_channels, taps_per_branch, window, h=h, hop=hop,
            mode=mode, config=config,
        )

    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=P(axis_name, None),
        out_specs=P(axis_name, None, None),
    )(x)


def range_doppler_cfar_sharded(
    rx,
    tx,
    mesh: Mesh,
    axis_name: str = DATA_AXIS,
    *,
    window: Optional[str] = None,
    doppler_window: Optional[str] = "hann",
    normalize: bool = True,
    num_train: int = 8,
    num_guard: int = 2,
    pfa: float = 1e-4,
    method: str = "ca",
    cfar_axes: Tuple[int, ...] = (-2, -1),
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tuple[Array, Array, Array]:
    """Batch-sharded radar CPI chain: (batch, n_pulses, N) coherent
    processing intervals laid out over the mesh, each chip running pulse
    compression → Doppler FFT → CFAR on its own CPIs (zero collectives —
    the chain is independent per CPI; the shared transmit replica is a
    broadcast plan constant).  This is the multi-channel / multi-dwell
    surveillance layout.  Returns (rd_map, detections, threshold), each
    (batch, n_pulses, N−Nt+1) with the batch sharding preserved."""
    from ..ops.radar import cfar as _cfar, range_doppler as _range_doppler

    rx = jnp.asarray(rx)
    if rx.ndim != 3:
        raise ValueError(
            "range_doppler_cfar_sharded expects (batch, n_pulses, n_samples)"
        )
    parts = mesh.shape[axis_name]
    if rx.shape[0] % parts != 0:
        raise ValueError(
            f"batch {rx.shape[0]} must divide over mesh axis "
            f"{axis_name!r} ({parts})"
        )
    rx = shard_batch(rx, mesh, axis_name)
    axes = tuple(cfar_axes)  # shard_map keeps rank; axes mean the same

    def body(rl):
        Y = _range_doppler(
            rl, tx, window=window, doppler_window=doppler_window,
            normalize=normalize, config=config,
        )
        p = jnp.real(Y) ** 2 + jnp.imag(Y) ** 2
        det, th = _cfar(
            p, num_train=num_train, num_guard=num_guard, pfa=pfa,
            method=method, axes=axes,
        )
        return Y, det, th

    spec = P(axis_name, None, None)
    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=spec,
        out_specs=(spec, spec, spec),
    )(rx)
