"""Plan construction (L2-cold-path of the reference, trace-time here).

Replacement for `fft_init` / `struct fft_set` / `free_fft`
(reference: src/highSpeedFFT.c:206-286, 2315-2318; src/highspeedFFT.h:36-43).

Key design differences from the reference, all deliberate:

* Plans are **immutable pytrees** (frozen dataclasses registered with JAX).
  The reference mutates its plan during Bluestein execution
  (src/highSpeedFFT.c:1759-1760, 1861-1866), making `fft_exec` non-reentrant;
  immutability eliminates that class of bug and makes plans safely shareable
  across jit traces and threads.
* The Bluestein **chirp spectrum is precomputed at plan time** (the reference
  recomputes it on every exec, src/highSpeedFFT.c:1786-1797) and the padded
  length is computed in one place (the reference's two disagreeing formulas,
  src/highSpeedFFT.c:242-252 vs 1750-1751, cause a verified heap overflow at
  N = 257).
* Twiddles always use the correct dynamic formula with exact integer phase
  reduction (the reference's table path is verifiably wrong for non-innermost
  radices 3/4/7 — SURVEY.md §2.2(4)).
* N = 1 is a valid plan (identity); the reference calls exit(1)
  (src/highSpeedFFT.c:2240-2245).

Static metadata (N, sign, stage factors) lives in pytree aux data so jit
retraces per plan *structure*; the twiddle/DFT constants are pytree leaves.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import Tuple

import jax
import numpy as np

from .utils.config import DEFAULT_CONFIG, SpectralConfig
from .utils.factorize import is_smooth, next_fast_len, next_pow2, plan_stages
from .utils.twiddle import chirp, dft_matrix, split_twiddles, twiddle_split

Array = jax.Array


@dataclasses.dataclass(frozen=True)
class MixedRadixPlan:
    """Stage schedule for the mixed-radix engine.

    ``factors`` are dense DFT stage sizes (descending, product = n); stage i
    contributes one (f_i × f_i) matmul.  ``tw_*[i]`` are the Cooley-Tukey
    split twiddles between stage i and the remainder, shape
    (f_i, prod(factors[i+1:])).
    """

    n: int = dataclasses.field(metadata=dict(static=True))
    sign: int = dataclasses.field(metadata=dict(static=True))
    factors: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    # matmul precision for the stage DFTs, from the building config ("highest"
    # keeps fp32 accuracy in the matmuls; see SpectralConfig.precision).  Either a
    # single string applied to every stage, or a tuple of per-stage strings
    # (stage i uses precision[min(i, len-1)]) for mixed-precision schemes.
    precision: "str | Tuple[str, ...]" = dataclasses.field(
        default="highest", metadata=dict(static=True)
    )
    # Execute stages of size 2/4 as elementwise butterflies (adds + re/im swaps)
    # instead of dense matmuls — at f<=4 every DFT entry is ±1/±i, and
    # the matmul form drags a 4-wide minormost dim through the neighbouring
    # big stages (A/B lever; see stockham._butterfly_stage).
    butterfly: bool = dataclasses.field(default=False, metadata=dict(static=True))
    # Largest stage size the butterfly dispatch may take: 16 by default
    # (SpectralConfig.butterfly="auto"), which the (64,16) plan at N=1024
    # relies on; SpectralConfig.butterfly="8" caps at 8.
    butterfly_max: int = dataclasses.field(default=8, metadata=dict(static=True))
    dft_re: Tuple[Array, ...] = ()
    dft_im: Tuple[Array, ...] = ()
    tw_re: Tuple[Array, ...] = ()
    tw_im: Tuple[Array, ...] = ()


@dataclasses.dataclass(frozen=True)
class BluesteinPlan:
    """Chirp-z plan for lengths whose largest prime factor exceeds the stage cap.

    X = w ⊙ ifft_M(fft_M(pad(w ⊙ x)) ⊙ Ĉ), with w the quadratic chirp and Ĉ its
    padded spectrum — both baked in at plan time (reference recomputes Ĉ per
    exec: src/highSpeedFFT.c:1786-1797).  ``inner`` is a forward plan of the
    padded length m; the inverse inner transform uses the conjugation identity,
    so one inner plan serves both directions.
    """

    n: int = dataclasses.field(metadata=dict(static=True))
    sign: int = dataclasses.field(metadata=dict(static=True))
    m: int = dataclasses.field(metadata=dict(static=True))
    inner: MixedRadixPlan = None
    chirp_re: Array = None
    chirp_im: Array = None
    spec_re: Array = None
    spec_im: Array = None


@dataclasses.dataclass(frozen=True)
class RaderPlan:
    """Rader plan for a prime length ``n`` whose ``n−1`` is stage-smooth.

    With g a primitive root mod n, the nonzero output bins become ONE cyclic
    convolution of length L = n−1:

        X[g^{−m} mod n] = x[0] + (a ⊛ b)[m],   a[q] = x[g^q mod n],
        b[r] = W^{g^{−r} mod n},               X[0] = x[0] + Â[0]

    so the prime transform costs two smooth length-(n−1) inner FFTs — vs
    Bluestein's two length-(m ≈ 2.4n) chirp-padded FFTs.  The kernel spectrum
    ``spec = fft_L(b)/L`` (Gauss-sum flat, |·| = √n) is a plan constant, and
    the inverse inner FFT rides the conjugation identity, so ONE forward
    inner plan serves the whole transform.  The reference has no prime-length
    fast path at all — every non-smooth length takes its per-exec-rechirped
    Bluestein (src/highSpeedFFT.c:1735-1907).
    """

    n: int = dataclasses.field(metadata=dict(static=True))
    sign: int = dataclasses.field(metadata=dict(static=True))
    inner: MixedRadixPlan = None  # forward plan of length n−1
    perm_in: Array = None   # q -> g^q mod n (input gather)
    perm_out: Array = None  # output bin k (1..n−1) -> conv index m
    spec_re: Array = None
    spec_im: Array = None


@dataclasses.dataclass(frozen=True)
class RealPlan:
    """Packed real FFT plan: one half-length complex plan + split twiddles
    (reference: fft_real_init, src/real.c:26-76).  n must be even — same
    contract as the reference (src/real.c:28-32); odd lengths take the
    full-complex fallback at the op layer instead of crashing."""

    n: int = dataclasses.field(metadata=dict(static=True))
    sign: int = dataclasses.field(metadata=dict(static=True))
    inner: object = None  # any ComplexPlan (MixedRadix/Bluestein/Rader) for n//2
    split_re: Array = None
    split_im: Array = None
    # fused split/merge coefficients: X[k] = P[k]·Z[k mod h] + Q[k]·conj(Z[(h-k) mod h])
    # with P = (1 + sign·i·w)/2, Q = (1 − sign·i·w)/2, w the split twiddle —
    # one elementwise pass instead of the reference's multi-step split algebra
    # (src/real.c:109-125)
    p_re: Array = None
    p_im: Array = None
    q_re: Array = None
    q_im: Array = None


for _cls in (MixedRadixPlan, BluesteinPlan, RaderPlan, RealPlan):
    _fields = dataclasses.fields(_cls)
    jax.tree_util.register_dataclass(
        _cls,
        data_fields=[f.name for f in _fields if not f.metadata.get("static")],
        meta_fields=[f.name for f in _fields if f.metadata.get("static")],
    )

ComplexPlan = (MixedRadixPlan, BluesteinPlan, RaderPlan)


def _precision_str(p) -> "str | Tuple[str, ...]":
    """Canonical string (or tuple of per-stage strings) for a
    jax.lax.Precision / string / sequence config value."""
    if isinstance(p, str):
        return p.lower()
    if isinstance(p, (tuple, list)):
        return tuple(_precision_str(q) for q in p)
    return {
        jax.lax.Precision.DEFAULT: "default",
        jax.lax.Precision.HIGH: "high",
        jax.lax.Precision.HIGHEST: "highest",
    }[p]


def _as_jnp(pair, dtype) -> Tuple[np.ndarray, np.ndarray]:
    """Plan constants are **host numpy arrays**, not device arrays: plans are
    built lazily — often inside a jit trace (the first `fft` call under a
    user's jit) — and a cached device array created during tracing would be a
    leaked tracer when the cached plan is reused in a later trace.  Numpy
    leaves are embedded as XLA constants at every use site instead."""
    re, im = pair
    return np.asarray(re, dtype=dtype), np.asarray(im, dtype=dtype)


def build_mixed_radix_plan(
    n: int, sign: int, config: SpectralConfig = DEFAULT_CONFIG
) -> MixedRadixPlan:
    """Stage-matmul plan for a smooth length ``n``: planned stage split,
    per-stage DFT matrices + split twiddles as fp64-generated host constants
    (reference: fft_init's lt=0 branch, src/highSpeedFFT.c:206-233)."""
    if sign not in (-1, 1):
        raise ValueError(f"sign must be -1 (forward) or +1 (inverse), got {sign}")
    if n < 1:
        raise ValueError(f"length must be >= 1, got {n}")
    if n == 1 or n <= config.direct_dft_max:
        factors: Tuple[int, ...] = (n,)
    else:
        factors = plan_stages(n, config.max_stage, config.stage_strategy)
    dtype = config.dtype
    dft_re, dft_im, tw_re, tw_im = [], [], [], []
    for i, f in enumerate(factors):
        wr, wi = _as_jnp(dft_matrix(f, sign, np.float64), dtype)
        dft_re.append(wr)
        dft_im.append(wi)
        if i < len(factors) - 1:
            n_rem = math.prod(factors[i + 1 :])
            tr, ti = _as_jnp(twiddle_split(f, n_rem, f * n_rem, sign, np.float64), dtype)
            tw_re.append(tr)
            tw_im.append(ti)
    return MixedRadixPlan(
        n=n,
        sign=sign,
        factors=factors,
        precision=_precision_str(config.precision),
        # butterfly dispatch is per-stage in the engine (stockham.
        # BUTTERFLY_RADICES); the plan bit records the config lever
        butterfly=config.butterfly != "off",
        butterfly_max=8 if config.butterfly == "8" else 16,
        dft_re=tuple(dft_re),
        dft_im=tuple(dft_im),
        tw_re=tuple(tw_re),
        tw_im=tuple(tw_im),
    )


def _padded_length(n: int, config: SpectralConfig) -> int:
    """Single source of truth for the Bluestein padded length — fixes the
    reference's plan/exec disagreement (src/highSpeedFFT.c:242-252 vs
    1750-1751, heap overflow at N = 2^k + 1)."""
    need = 2 * n - 1
    if config.pad_mode == "fast":
        return next_fast_len(need)
    if config.pad_mode == "pow23":
        # smallest 2^a or 3·2^a >= need: up to 25% less transform work than
        # pow2 while keeping balanced power-of-two-dominated stages
        p2 = next_pow2(need)
        p3 = 3 * next_pow2(-(-need // 3))
        return min(p2, p3)
    return next_pow2(need)


def build_bluestein_plan(
    n: int, sign: int, config: SpectralConfig = DEFAULT_CONFIG
) -> BluesteinPlan:
    """Chirp-z plan for arbitrary length ``n``: padded inner plan (shared
    across equal padded lengths via the cache) + plan-time chirp spectrum
    (reference: fft_init's lt=1 branch, src/highSpeedFFT.c:236-265, which
    recomputes the chirp per exec and over/under-pads — both fixed here)."""
    if sign not in (-1, 1):
        raise ValueError(f"sign must be -1 or +1, got {sign}")
    m = _padded_length(n, config)
    # The inner padded plan comes from the shared cache: every Bluestein
    # length with the same padded m (e.g. all primes in (8192, 12288]) reuses
    # one plan object, so their jitted inner pipelines share XLA cache entries
    # (the reference instead rebuilds per length AND re-FFTs the chirp per
    # exec, src/highSpeedFFT.c:1786-1797).
    inner = get_plan(m, -1, "complex", config)
    # Chirp w[j] = e^(sign·iπj²/n); kernel c = conj(w) wrapped circularly.
    wr64, wi64 = chirp(n, sign, np.float64)
    c = np.zeros(m, dtype=np.complex128)
    w64 = wr64 + 1j * wi64
    c[:n] = np.conj(w64)
    c[m - n + 1 :] = np.conj(w64)[1:][::-1]
    # Plan-time fp64 spectrum of the chirp kernel, with the inverse inner
    # FFT's 1/m normalization folded in — saves one elementwise pass per exec.
    spec = np.fft.fft(c) / m
    dtype = config.dtype
    return BluesteinPlan(
        n=n,
        sign=sign,
        m=m,
        inner=inner,
        chirp_re=np.asarray(wr64, dtype=dtype),
        chirp_im=np.asarray(wi64, dtype=dtype),
        spec_re=np.asarray(spec.real, dtype=dtype),
        spec_im=np.asarray(spec.imag, dtype=dtype),
    )


def build_rader_plan(
    n: int, sign: int, config: SpectralConfig = DEFAULT_CONFIG
) -> RaderPlan:
    """Rader plan for a prime ``n`` with stage-smooth ``n−1`` (see RaderPlan).
    Permutations and the Gauss-sum kernel spectrum are fp64 host constants;
    the inner length-(n−1) forward plan comes from the shared cache."""
    from .utils.factorize import is_prime, primitive_root

    if sign not in (-1, 1):
        raise ValueError(f"sign must be -1 or +1, got {sign}")
    if not is_prime(n):
        raise ValueError(f"Rader requires a prime length, got {n}")
    L = n - 1
    g = primitive_root(n)
    ginv = pow(g, n - 2, n)
    # q -> g^q and m -> g^{−m}, both mod n (exact integer arithmetic)
    perm_in = np.empty(L, np.int64)
    ipow = np.empty(L, np.int64)
    cur_f, cur_i = 1, 1
    for q in range(L):
        perm_in[q] = cur_f
        ipow[q] = cur_i
        cur_f = cur_f * g % n
        cur_i = cur_i * ginv % n
    inv = np.zeros(n, np.int64)
    inv[ipow] = np.arange(L)
    perm_out = inv[1:]  # output bin k (1..n−1) -> conv index m
    # b[r] = W^{g^{−r}}, W = e^(sign·2πi/n) — exact integer phase mod n
    phase = 2.0 * np.pi * ipow.astype(np.float64) / n
    b = np.cos(phase) + 1j * (sign * np.sin(phase))
    # kernel spectrum with the inverse inner FFT's 1/L folded in
    spec = np.fft.fft(b) / L
    inner = get_plan(L, -1, "complex", config)
    assert isinstance(inner, MixedRadixPlan), (n, L)  # eligibility guarantee
    dtype = config.dtype
    return RaderPlan(
        n=n,
        sign=sign,
        inner=inner,
        perm_in=perm_in.astype(np.int32),
        perm_out=perm_out.astype(np.int32),
        spec_re=np.asarray(spec.real, dtype=dtype),
        spec_im=np.asarray(spec.imag, dtype=dtype),
    )


def build_complex_plan(n: int, sign: int, config: SpectralConfig = DEFAULT_CONFIG):
    """Dispatch: mixed-radix when every prime factor fits in a dense stage;
    Rader for primes whose n−1 is stage-smooth (two inner FFTs of n−1 points);
    Bluestein otherwise (reference: fft_init's dividebyN branch,
    src/highSpeedFFT.c:214-265 — but with a complete prime predicate and the
    prime fast path the reference lacks)."""
    if n < 1:
        raise ValueError(f"length must be >= 1, got {n}")
    if n <= config.direct_dft_max or is_smooth(n, config.max_stage):
        return build_mixed_radix_plan(n, sign, config)
    from .utils.factorize import is_prime

    if (
        config.rader == "auto"
        and is_prime(n)
        and is_smooth(n - 1, config.max_stage)
    ):
        return build_rader_plan(n, sign, config)
    return build_bluestein_plan(n, sign, config)


def build_real_plan(
    n: int, sign: int, config: SpectralConfig = DEFAULT_CONFIG
) -> RealPlan:
    """Packed real-FFT plan: half-length complex plan + split twiddles
    (reference: fft_real_init, src/real.c:26-76); even ``n`` only, like the
    reference — odd lengths route through the complex engine at the API layer."""
    if n % 2 != 0:
        raise ValueError(f"packed real FFT requires even length, got {n}")
    inner = build_complex_plan(n // 2, sign, config)
    c64, s64 = split_twiddles(n, sign, np.float64)  # w = e^(sign·2πik/n)
    dtype = config.dtype
    p_re = ((1.0 - sign * s64) / 2.0).astype(dtype)
    p_im = (sign * c64 / 2.0).astype(dtype)
    q_re = ((1.0 + sign * s64) / 2.0).astype(dtype)
    q_im = (-sign * c64 / 2.0).astype(dtype)
    return RealPlan(
        n=n, sign=sign, inner=inner,
        split_re=c64.astype(dtype), split_im=s64.astype(dtype),
        p_re=p_re, p_im=p_im, q_re=q_re, q_im=q_im,
    )


# --------------------------------------------------------------------------
# Plan cache — the analogue of the reference's long-lived fft_object
# (plus XLA's own compilation cache on top).  Keyed on everything that changes
# plan structure or constants.
# --------------------------------------------------------------------------

_CACHE: dict = {}
_CACHE_LOCK = threading.Lock()


def _cfg_key(config: SpectralConfig):
    return (
        config.max_stage,
        config.direct_dft_max,
        str(config.dtype),
        str(config.precision),
        config.pad_mode,
        config.stage_strategy,
        config.rader,
        config.butterfly,
    )


def get_plan(n: int, sign: int, kind: str = "complex",
             config: SpectralConfig = DEFAULT_CONFIG):
    """Cached plan lookup keyed on (n, sign, kind, config) — the library's
    `fft_init` equivalent, but immutable and shared (thread-safe LRU)."""
    from .utils.metrics import incr, logger

    key = (kind, n, sign, _cfg_key(config))
    with _CACHE_LOCK:
        plan = _CACHE.get(key)
    if plan is not None:
        incr("plan_cache_hits")
        return plan
    if kind == "complex":
        plan = build_complex_plan(n, sign, config)
    elif kind == "real":
        plan = build_real_plan(n, sign, config)
    else:
        raise ValueError(f"unknown plan kind {kind!r}")
    incr("plans_built")
    logger.info(
        "built %s plan n=%d sign=%+d (%s)", kind, n, sign,
        type(plan).__name__,
    )
    with _CACHE_LOCK:
        _CACHE.setdefault(key, plan)
    return plan


def clear_plan_cache() -> None:
    """Drop every cached plan (reference `free_fft`, for the whole cache)."""
    with _CACHE_LOCK:
        _CACHE.clear()
