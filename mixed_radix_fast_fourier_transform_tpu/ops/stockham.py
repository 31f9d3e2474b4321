"""Mixed-radix complex FFT engine (L2-hot-path of the reference).

Replacement for `mixed_radix_dit_rec` (reference:
src/highSpeedFFT.c:318-1629).  The reference's shape — recursive, strided,
scalar butterflies with in-place combining — is exactly wrong for an
accelerator (strided gathers, no vector lanes, no matmuls).  Here the same
Cooley-Tukey mixed-radix decomposition is expressed as a *trace-time* recursion that emits, per stage:

    reshape → (batched length-N2 sub-FFTs) → twiddle ⊙ → dense f×f DFT matmul

so every stage's butterfly work is one big matmul contracted over the
stage size with the full batch (and all sibling sub-transforms) folded into
the matmul's M dimension, and every twiddle multiply is an elementwise op
that XLA fuses with its neighbours.  There is no bit-reversal and no strided
recursion at runtime — like the reference's implicit digit-reversal, ordering
falls out of the reshape/transpose algebra, but as dense layout changes
instead of scalar strided loads.

Leaf codelets (reference src/highSpeedFFT.c:333-713) and the O(r²) general-
radix combine (1475-1628) both collapse into the same dense DFT matmul here:
on a matrix unit a hand-unrolled radix-7 butterfly and a 7×7 matrix multiply
are the same thing, and the matmul version is correct for *every* radix (the
reference's leaf-2 drops input[0] — verified bug, src/highSpeedFFT.c:354-364).

All functions are jittable; the plan rides along as a pytree argument.
"""

from __future__ import annotations

import math
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..plan import BluesteinPlan, MixedRadixPlan, RaderPlan
from ..utils.numerics import cmul

Array = jax.Array


# Complex stage matmul forms, chosen per stage size f.  The crossover is an
# inherited default, not measured on the H100 (ROADMAP S5):
#
# * STACKED (f < KARATSUBA_MIN_STAGE): one real matmul with the re/im planes
#   concatenated on the contraction axis against the (2f, 2f) block matrix
#   [[Wr, Wi], [−Wi, Wr]].  Same flops as the naive 4-matmul form but double
#   the contraction depth K, which feeds a matrix unit better at small K.
# * KARATSUBA (f >= KARATSUBA_MIN_STAGE): three real matmuls
#   M1 = xr·Wr, M2 = xi·Wi, M3 = (xr+xi)·(Wr+Wi); zr = M1−M2,
#   zi = M3−M1−M2: 25% fewer flops than the stacked form.
KARATSUBA_MIN_STAGE = 128

# Stage sizes executed as elementwise butterflies when the plan's butterfly
# lever is on (SpectralConfig.butterfly="auto", the default; see
# _butterfly_stage).  plan.butterfly_max=8 (config value "8") caps out the
# radix-16 form for A/Bs.
BUTTERFLY_RADICES = (2, 4, 8, 16)


def _stacked_dft_matrix(wr: Array, wi: Array) -> Array:
    """(2f, 2f) real block matrix [[Wr, Wi], [−Wi, Wr]].  XLA constant-folds
    this build when the plan leaves are constants (the usual case)."""
    wr = jnp.asarray(wr)
    wi = jnp.asarray(wi)
    top = jnp.concatenate([wr, wi], axis=1)
    bot = jnp.concatenate([-wi, wr], axis=1)
    return jnp.concatenate([top, bot], axis=0)


def _bf16_chunks3(v: Array) -> Tuple[Array, Array, Array]:
    """Three-term bf16 decomposition of an fp32 array: v ≈ c1 + c2 + c3.

    Chunks are cut by BITMASK, not dtype casts: the natural
    ``v - v.astype(bf16).astype(f32)`` residual can be silently zeroed by
    XLA's excess-precision simplifier (the f32→bf16→f32 round trip is
    elided and the split6 error collapses to bf16 class).
    Masking the low 16 mantissa bits keeps each chunk exactly
    bf16-representable while the subtraction stays a real f32 op."""
    mask = np.int32(~np.int32(0xFFFF))
    def cut(x):
        bits = jax.lax.bitcast_convert_type(x, jnp.int32)
        return jax.lax.bitcast_convert_type(bits & mask, jnp.float32)
    c1 = cut(v)
    r1 = v - c1
    c2 = cut(r1)
    r2 = r1 - c2
    return (
        c1.astype(jnp.bfloat16),
        c2.astype(jnp.bfloat16),
        r2.astype(jnp.bfloat16),
    )


def _einsum_split6(subscripts: str, axis: int, x: Array, w: Array) -> Array:
    """fp32-accurate matmul as ONE deep bf16 pass ("split6" form).

    The six bf16 chunk products of a three-way split
    (x1w1; x1w2+x2w1; x1w3+x2w2+x3w1) are stacked onto the contraction axis,
    giving a single bf16 matmul of depth 6K with fp32 accumulation.
    bf16·bf16 products are exact in the fp32 accumulator (8-bit mantissas),
    so accuracy is HIGHEST-class (~1e-7)."""
    x1, x2, x3 = _bf16_chunks3(x)
    w1, w2, w3 = _bf16_chunks3(w)
    xs = jnp.concatenate([x1, x1, x2, x1, x2, x3], axis=axis)
    ws = jnp.concatenate([w1, w2, w1, w3, w2, w1], axis=0)
    return jnp.einsum(subscripts, xs, ws, preferred_element_type=jnp.float32)


def _dft_apply(
    subscripts: str,
    axis: int,
    xr: Array,
    xi: Array,
    wr: Array,
    wi: Array,
    precision: str,
) -> Tuple[Array, Array]:
    """Dense complex DFT stage over ``axis`` via ``subscripts`` einsum,
    dispatching on the stacked/Karatsuba crossover."""
    f = wr.shape[0]
    if precision == "split6":
        dot = lambda a, w: _einsum_split6(subscripts, axis, a, jnp.asarray(w))
    else:
        dot = lambda a, w: jnp.einsum(
            subscripts, a, w, precision=precision,
            preferred_element_type=xr.dtype,
        )
    if f >= KARATSUBA_MIN_STAGE:
        wr = jnp.asarray(wr)
        wi = jnp.asarray(wi)
        m1 = dot(xr, wr)
        m2 = dot(xi, wi)
        m3 = dot(xr + xi, wr + wi)
        return m1 - m2, m3 - m1 - m2
    w2 = _stacked_dft_matrix(wr, wi)
    x2 = jnp.concatenate([xr, xi], axis=axis)
    z2 = dot(x2, w2)
    if axis == -1:
        return z2[..., :f], z2[..., f:]
    return z2[..., :f, :], z2[..., f:, :]


def _dft_apply_last(
    xr: Array, xi: Array, wr: Array, wi: Array, precision: str
) -> Tuple[Array, Array]:
    """DFT over the last axis: z[..., k] = Σ_n x[..., n] W[n, k]."""
    return _dft_apply("...n,nk->...k", -1, xr, xi, wr, wi, precision)


def _dft_apply_axis2(
    xr: Array, xi: Array, wr: Array, wi: Array, precision: str
) -> Tuple[Array, Array]:
    """DFT over axis -2: z[..., m, k] = Σ_n x[..., n, k] W[n, m]."""
    return _dft_apply("...nk,nm->...mk", -2, xr, xi, wr, wi, precision)


def _bfly4(pr, pi, sign: int):
    """Length-4 DFT of four (re, im) plane tuples; returns 4-tuples."""
    x0r, x1r, x2r, x3r = pr
    x0i, x1i, x2i, x3i = pi
    ar, ai = x0r + x2r, x0i + x2i
    br, bi = x0r - x2r, x0i - x2i
    cr, ci = x1r + x3r, x1i + x3i
    dr, di = x1r - x3r, x1i - x3i
    if sign > 0:
        edr, edi = -di, dr  # +i·d
    else:
        edr, edi = di, -dr  # −i·d
    return (
        (ar + cr, br + edr, ar - cr, br - edr),
        (ai + ci, bi + edi, ai - ci, bi - edi),
    )


_SQRT1_2 = float(np.float32(np.sqrt(0.5)))
_COS_PI_8 = float(np.float32(np.cos(np.pi / 8)))
_SIN_PI_8 = float(np.float32(np.sin(np.pi / 8)))


def _bfly8(pr, pi, sign: int):
    """Length-8 DFT of eight (re, im) plane tuples; returns 8-tuples.

    Two radix-4 halves + the W8 combine — only the two odd twiddles carry a
    (scalar) multiply, by √½."""
    er, ei = _bfly4(pr[0::2], pi[0::2], sign)
    orr, oii = _bfly4(pr[1::2], pi[1::2], sign)
    s = float(sign)
    c = _SQRT1_2
    # W8^1 = √½·(1 + i·s), W8^2 = i·s, W8^3 = √½·(−1 + i·s)
    t1r, t1i = c * (orr[1] - s * oii[1]), c * (oii[1] + s * orr[1])
    if sign > 0:
        t2r, t2i = -oii[2], orr[2]
    else:
        t2r, t2i = oii[2], -orr[2]
    t3r, t3i = -c * (orr[3] + s * oii[3]), c * (s * orr[3] - oii[3])
    tr = (orr[0], t1r, t2r, t3r)
    ti = (oii[0], t1i, t2i, t3i)
    return (
        tuple(er[k] + tr[k] for k in range(4))
        + tuple(er[k] - tr[k] for k in range(4)),
        tuple(ei[k] + ti[k] for k in range(4))
        + tuple(ei[k] - ti[k] for k in range(4)),
    )


def _bfly16(pr, pi, sign: int):
    """Length-16 DFT of sixteen (re, im) plane tuples; returns 16-tuples.

    Two radix-8 halves + the W16^k = (cos πk/8, s·sin πk/8) combine: k = 4
    is a plane swap, k = 2/6 are √½ forms, k ∈ {1,3,5,7} each cost four
    scalar multiplies with the cos/sin(π/8) constants."""
    er, ei = _bfly8(pr[0::2], pi[0::2], sign)
    orr, oii = _bfly8(pr[1::2], pi[1::2], sign)
    s = float(sign)
    c1, s1, c2 = _COS_PI_8, _SIN_PI_8, _SQRT1_2

    def tw(k, cr, sn):
        # t = (cr + i·s·sn) · O_k
        return (
            cr * orr[k] - s * sn * oii[k],
            cr * oii[k] + s * sn * orr[k],
        )

    t1r, t1i = tw(1, c1, s1)
    t2r, t2i = c2 * (orr[2] - s * oii[2]), c2 * (oii[2] + s * orr[2])
    t3r, t3i = tw(3, s1, c1)
    if sign > 0:
        t4r, t4i = -oii[4], orr[4]
    else:
        t4r, t4i = oii[4], -orr[4]
    t5r, t5i = tw(5, -s1, c1)
    t6r, t6i = -c2 * (orr[6] + s * oii[6]), c2 * (s * orr[6] - oii[6])
    t7r, t7i = tw(7, -c1, s1)
    tr = (orr[0], t1r, t2r, t3r, t4r, t5r, t6r, t7r)
    ti = (oii[0], t1i, t2i, t3i, t4i, t5i, t6i, t7i)
    return (
        tuple(er[k] + tr[k] for k in range(8))
        + tuple(er[k] - tr[k] for k in range(8)),
        tuple(ei[k] + ti[k] for k in range(8))
        + tuple(ei[k] - ti[k] for k in range(8)),
    )


def _butterfly_stage(
    f: int, sign: int, axis: int, xr: Array, xi: Array
) -> Tuple[Array, Array]:
    """Radix-2/4/8/16 DFT over ``axis`` (-1 or -2) as elementwise passes.

    For f <= 4 every DFT-matrix entry is ±1 or ±i, so the stage needs no
    real multiplies at all: multiplication by ±i is a re/im plane swap with
    a sign flip; f = 8 adds only scalar √½ multiplies for the two odd
    twiddles.  The dense-matmul form of these stages runs a depth-2f
    contraction and keeps an f-wide minormost dimension through the
    neighbouring big stages' matmuls; the butterfly form is a handful of
    full-width elementwise passes instead.  Enabled per-plan
    (``MixedRadixPlan.butterfly``) like every other engine lever."""
    if axis == -1:
        part = lambda a, j: a[..., j]
    else:
        part = lambda a, j: a[..., j, :]
    if f == 2:
        x0r, x1r = part(xr, 0), part(xr, 1)
        x0i, x1i = part(xi, 0), part(xi, 1)
        outr = (x0r + x1r, x0r - x1r)
        outi = (x0i + x1i, x0i - x1i)
    elif f == 4:
        outr, outi = _bfly4(
            tuple(part(xr, j) for j in range(4)),
            tuple(part(xi, j) for j in range(4)),
            sign,
        )
    elif f == 8:
        outr, outi = _bfly8(
            tuple(part(xr, j) for j in range(8)),
            tuple(part(xi, j) for j in range(8)),
            sign,
        )
    else:  # f == 16
        outr, outi = _bfly16(
            tuple(part(xr, j) for j in range(16)),
            tuple(part(xi, j) for j in range(16)),
            sign,
        )
    return jnp.stack(outr, axis=axis), jnp.stack(outi, axis=axis)


def _exec_level(
    plan: MixedRadixPlan, level: int, xr: Array, xi: Array
) -> Tuple[Array, Array]:
    """Execute the transform of length prod(factors[level:]) over the last axis.

    Cooley-Tukey split at this node: N_cur = f · n_rem with f = factors[level]
    as the *outer* DFT.  Input index n = f·n2 + n1; output k = n_rem·k1 + k2:

        X[n_rem·k1 + k2] = Σ_{n1} W_f^{n1·k1} · T[n1,k2] · FFT_{n_rem}(x[f·:+n1])[k2]

    with T the split twiddle e^(sign·2πi·n1·k2/N_cur) — the correct dynamic
    formula (reference src/highSpeedFFT.c:2275-2288), never the broken table
    path.
    """
    factors = plan.factors
    prec = getattr(plan, "precision", "highest")
    if isinstance(prec, tuple):  # per-stage mixed-precision scheme
        prec = prec[min(level, len(prec) - 1)]
    f = factors[level]
    bfly = (
        plan.butterfly
        and f in BUTTERFLY_RADICES
        and f <= getattr(plan, "butterfly_max", 8)
    )
    if level == len(factors) - 1:
        if bfly:
            return _butterfly_stage(f, plan.sign, -1, xr, xi)
        return _dft_apply_last(xr, xi, plan.dft_re[level], plan.dft_im[level], prec)
    n_rem = math.prod(factors[level + 1 :])
    batch = xr.shape[:-1]
    # (..., N_cur) -> (..., n2, n1) -> (..., n1, n2): sub-transform n1 over last axis
    xr = jnp.swapaxes(xr.reshape(*batch, n_rem, f), -1, -2)
    xi = jnp.swapaxes(xi.reshape(*batch, n_rem, f), -1, -2)
    yr, yi = _exec_level(plan, level + 1, xr, xi)
    yr, yi = cmul(yr, yi, plan.tw_re[level], plan.tw_im[level])
    if bfly:
        zr, zi = _butterfly_stage(f, plan.sign, -2, yr, yi)
    else:
        zr, zi = _dft_apply_axis2(yr, yi, plan.dft_re[level], plan.dft_im[level], prec)
    return zr.reshape(*batch, f * n_rem), zi.reshape(*batch, f * n_rem)


def exec_mixed_radix(
    plan: MixedRadixPlan, xr: Array, xi: Array
) -> Tuple[Array, Array]:
    """Unnormalized transform over the last axis (matches the reference's
    unnormalized fft_exec, src/highSpeedFFT.c:1920-1942; normalization is
    applied by the API layer per the ``norm`` argument)."""
    if plan.n == 1:
        return xr, xi  # identity — valid here, exit(1) in the reference
    return _exec_level(plan, 0, xr, xi)


def exec_bluestein(plan: BluesteinPlan, xr: Array, xi: Array) -> Tuple[Array, Array]:
    """Chirp-z transform (reference: bluestein_fft, src/highSpeedFFT.c:1735-1907)
    — same algorithm, but the chirp spectrum is a plan constant, padding is
    consistent, nothing is mutated, and the inverse inner FFT uses the
    conjugation identity instead of negating plan twiddles in place."""
    n, m = plan.n, plan.m
    batch = xr.shape[:-1]
    # a = w ⊙ x, zero-padded to m
    ar, ai = cmul(xr, xi, plan.chirp_re, plan.chirp_im)
    pad = [(0, 0)] * len(batch) + [(0, m - n)]
    ar = jnp.pad(ar, pad)
    ai = jnp.pad(ai, pad)
    # A = fft_m(a); B = A ⊙ (Ĉ/m); b = ifft_m'(B) = conj(fft_m(conj(B)))
    # (the 1/m normalization is baked into spec_* at plan time)
    fr, fi = exec_mixed_radix(plan.inner, ar, ai)
    br, bi = cmul(fr, fi, plan.spec_re, plan.spec_im)
    gr, gi = exec_mixed_radix(plan.inner, br, -bi)
    # X = w ⊙ conj(b)[:n]
    return cmul(gr[..., :n], -gi[..., :n], plan.chirp_re, plan.chirp_im)


def exec_rader(plan: RaderPlan, xr: Array, xi: Array) -> Tuple[Array, Array]:
    """Prime-length transform as one length-(n−1) cyclic convolution
    (see plan.RaderPlan).  Gathers are static permutations over the last
    axis (one layout pass each); the heavy work is the two smooth inner
    FFTs, which reuse the stage-matmul engine unchanged.  The reference has
    no prime fast path — this replaces its Bluestein-for-everything branch
    (src/highSpeedFFT.c:236-265) where n−1 is smooth."""
    n = plan.n
    x0r, x0i = xr[..., 0], xi[..., 0]
    ar = jnp.take(xr, plan.perm_in, axis=-1)
    ai = jnp.take(xi, plan.perm_in, axis=-1)
    fr, fi = exec_mixed_radix(plan.inner, ar, ai)
    # DC bin: X[0] = x[0] + Σ_{j≠0} x[j] = x[0] + Â[0]
    dr, di = x0r + fr[..., 0], x0i + fi[..., 0]
    # cyclic convolution with the planned kernel spectrum (1/L folded in);
    # inverse inner FFT via the conjugation identity
    br, bi = cmul(fr, fi, plan.spec_re, plan.spec_im)
    gr, gi = exec_mixed_radix(plan.inner, br, -bi)
    tr = x0r[..., None] + gr
    ti = x0i[..., None] - gi
    outr = jnp.concatenate(
        [dr[..., None], jnp.take(tr, plan.perm_out, axis=-1)], axis=-1
    )
    outi = jnp.concatenate(
        [di[..., None], jnp.take(ti, plan.perm_out, axis=-1)], axis=-1
    )
    return outr, outi


def exec_complex(plan, xr: Array, xi: Array) -> Tuple[Array, Array]:
    """Dispatch on plan type (reference: fft_exec's lt branch,
    src/highSpeedFFT.c:1928-1941)."""
    if isinstance(plan, BluesteinPlan):
        return exec_bluestein(plan, xr, xi)
    if isinstance(plan, RaderPlan):
        return exec_rader(plan, xr, xi)
    return exec_mixed_radix(plan, xr, xi)


def exec_len(
    config, n: int, sign: int, xr: Array, xi: Array
) -> Tuple[Array, Array]:
    """Length-``n`` unnormalized transform over the last axis through the
    plan-based stage pipeline.  Single dispatch point shared by the
    fft/rfft API layers."""
    from ..plan import get_plan

    return exec_complex(get_plan(n, sign, "complex", config), xr, xi)
