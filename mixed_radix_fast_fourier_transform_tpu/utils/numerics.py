"""Complex-as-planes helpers.

Matrix and vector units operate on real arrays; complex64 is decomposed by
XLA anyway, and keeping explicit (re, im) fp32 planes (struct-of-arrays) gives
the engine direct control over fusion and matmul shapes — the opposite of the
reference's interleaved `fft_data {re, im}` AoS layout (src/highspeedFFT.h:20-23)
which does not vectorize.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

Array = jax.Array


def to_planes(x, dtype=jnp.float32) -> Tuple[Array, Array]:
    """Split a complex (or real) array into (re, im) planes of ``dtype``."""
    x = jnp.asarray(x)
    if jnp.issubdtype(x.dtype, jnp.complexfloating):
        return jnp.real(x).astype(dtype), jnp.imag(x).astype(dtype)
    x = x.astype(dtype)
    return x, jnp.zeros_like(x)


def from_planes(re: Array, im: Array) -> Array:
    """Combine (re, im) planes into a complex array (complex64 for fp32
    planes).  lax.complex only accepts fp32/fp64, so low-precision working
    dtypes (bf16) upcast at the boundary — compute stays in the working dtype,
    only the user-facing complex view widens."""
    if re.dtype not in (jnp.float32, jnp.float64):
        re = re.astype(jnp.float32)
        im = im.astype(jnp.float32)
    return jax.lax.complex(re, im)


def cmul(ar: Array, ai: Array, br: Array, bi: Array) -> Tuple[Array, Array]:
    """Elementwise complex multiply on planes."""
    return ar * br - ai * bi, ar * bi + ai * br


def conj_planes(re: Array, im: Array) -> Tuple[Array, Array]:
    return re, -im


# ---------------------------------------------------------------------------
# Error-free transforms (Knuth two-sum, Dekker/Veltkamp split product) — the
# canonical set shared by the compensated SHT recurrence (ops/sht.py), the
# NUFFT exact phase reduction and double-word segment sums (ops/nufft.py).
# XLA preserves IEEE semantics (no reassociation), so these hold on GPU and
# CPU alike; if the backend contracts mul+add into an FMA the product-error
# term only gets MORE accurate.  All helpers are dtype-polymorphic but the
# splitter constants target fp32 operands.
# ---------------------------------------------------------------------------

# 2^12 + 1: Dekker splitter for fp32 (balanced 12/12-bit halves — two_prod)
DW_SPLIT = 4097.0
# 2^16 + 1: Veltkamp splitter for fp32 8-bit-mantissa heads (exact products
# of head pieces even after a further split — the NUFFT phase chain)
VELTKAMP_SPLIT = 65537.0


def two_sum(a, b):
    """Error-free addition: (s, e) with s + e == a + b exactly (Knuth)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def fast_two_sum(a, b):
    """Error-free addition assuming |a| >= |b| (or a == 0) — Dekker."""
    s = a + b
    return s, b - (s - a)


def two_prod(a, b):
    """Error-free product: (p, e) with p + e == a·b exactly (Dekker split)."""
    split = jnp.asarray(DW_SPLIT, jnp.asarray(a).dtype)
    p = a * b
    ca = split * a
    ah = ca - (ca - a)
    al = a - ah
    cb = split * b
    bh = cb - (cb - b)
    bl = b - bh
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def veltkamp(v):
    """Exact fp32 split into an 8-bit-mantissa head and a tail."""
    f = jnp.asarray(VELTKAMP_SPLIT, jnp.asarray(v).dtype)
    c = f * v
    hi = c - (c - v)
    return hi, v - hi


def dw_mul(ah, al, bh, bl):
    """Double-word × double-word product, renormalized (hi, lo)."""
    ph, pe = two_prod(ah, bh)
    return fast_two_sum(ph, pe + (ah * bl + al * bh))


def dw_add(ah, al, bh, bl):
    """Double-word + double-word sum, renormalized (hi, lo)."""
    sh, se = two_sum(ah, bh)
    return fast_two_sum(sh, se + al + bl)
