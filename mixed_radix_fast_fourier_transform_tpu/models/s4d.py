"""S4D: diagonal state-space sequence model (Gu et al. 2022, S4D-Lin).

Fourth model family on the engine, and the one whose compute IS the
library's headline op: an S4D layer is a bank of per-channel length-L
causal convolutions whose kernels come from a diagonal linear ODE,

    s'(t) = A s(t) + B u(t),   y(t) = 2·Re(C s(t)) + D u(t),

discretized (ZOH) to  s[l+1] = Ā s[l] + B̄ u[l]  with  Ā = exp(Δ·A),
B̄ = (Ā − 1)/A.  Unrolling gives the convolution kernel

    K[l] = 2·Re( Σ_n C_n · B̄_n · Ā_n^l ),      l = 0..L−1,

evaluated here as one dense (H·N × L) contraction over the complex
exponential table (real/imag planes — no complex dtype on the wire), and
applied with the library's packed rFFT long-convolution (ops/rfft), which
is exactly BASELINE config 5's shape.  A `step` function runs the same
layer recurrently for O(1)-per-token streaming inference; the FFT and
recurrent paths agree to fp32 and oracle-test each other.

The reference library has no models (its demo harness, src/real.c:269-482,
is disabled); this family showcases long-convolution training on an accelerator.
"""

from __future__ import annotations

import math

from typing import Dict, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.rfft import irfft, rfft
from ..utils.config import DEFAULT_CONFIG, SpectralConfig
from ..utils.factorize import is_smooth

Array = jax.Array
Params = Dict[str, object]


def init_s4d_layer(key, hidden: int, state: int = 64,
                   dt_min: float = 1e-3, dt_max: float = 1e-1,
                   dtype=jnp.float32) -> Params:
    """One S4D-Lin layer: ``state`` must be even (N/2 conjugate pairs are
    materialized; the kernel takes 2·Re of the half-spectrum sum)."""
    if state % 2:
        raise ValueError(f"state size must be even, got {state}")
    n2 = state // 2
    k_dt, k_c = jax.random.split(key)
    # S4D-Lin init: A_n = -1/2 + i·π·n  (n-th Fourier-like mode)
    log_neg_a_re = jnp.full((n2,), math.log(0.5), dtype)
    a_im = jnp.asarray(math.pi * np.arange(n2), dtype)
    log_dt = jax.random.uniform(
        k_dt, (hidden,), dtype,
        minval=math.log(dt_min), maxval=math.log(dt_max),
    )
    c = jax.random.normal(k_c, (2, hidden, n2), dtype)
    return {
        "log_neg_a_re": log_neg_a_re,  # (N/2,)  Re A = −exp(·) < 0: stable
        "a_im": a_im,                  # (N/2,)
        "log_dt": log_dt,              # (H,)
        "c_re": c[0], "c_im": c[1],    # (H, N/2)
        "d": jnp.ones((hidden,), dtype),
        # output mix + prenorm of the residual block
        "w_out": (jax.random.normal(jax.random.fold_in(key, 7),
                                    (hidden, hidden)) / math.sqrt(hidden)
                  ).astype(dtype),
        "b_out": jnp.zeros((hidden,), dtype),
        "ln_scale": jnp.ones((hidden,), dtype),
        "ln_bias": jnp.zeros((hidden,), dtype),
    }


def _discretize(p: Params) -> Tuple[Array, Array, Array, Array]:
    """ZOH: returns (ā_re, ā_im, b̄c_re, b̄c_im), each (H, N/2), where
    b̄c = C·B̄ already folds the input matrix into the output one."""
    a_re = -jnp.exp(p["log_neg_a_re"])[None, :]          # (1, N/2)
    a_im = p["a_im"][None, :]
    dt = jnp.exp(p["log_dt"])[:, None]                   # (H, 1)
    dta_re, dta_im = dt * a_re, dt * a_im                # (H, N/2)
    mag = jnp.exp(dta_re)
    abar_re = mag * jnp.cos(dta_im)
    abar_im = mag * jnp.sin(dta_im)
    # B̄ = (Ā − 1)/A  (B = 1); complex division by A in planes
    num_re, num_im = abar_re - 1.0, abar_im
    den = a_re * a_re + a_im * a_im
    bbar_re = (num_re * a_re + num_im * a_im) / den
    bbar_im = (num_im * a_re - num_re * a_im) / den
    bc_re = p["c_re"] * bbar_re - p["c_im"] * bbar_im
    bc_im = p["c_re"] * bbar_im + p["c_im"] * bbar_re
    return abar_re, abar_im, bc_re, bc_im


def s4d_kernel(p: Params, length: int) -> Array:
    """(H, L) real convolution kernel K[l] = 2·Re(Σ_n b̄c_n · Ā_n^l).

    Ā^l is evaluated in log space (l·Δ·A), so the (H, N/2, L) exponential
    table is numerically stable at any l; the n-contraction is a dense
    matmul per channel (einsum over the state axis).
    """
    a_re = -jnp.exp(p["log_neg_a_re"])[None, :]
    a_im = p["a_im"][None, :]
    dt = jnp.exp(p["log_dt"])[:, None]
    dta_re, dta_im = dt * a_re, dt * a_im                # (H, N/2)
    _, _, bc_re, bc_im = _discretize(p)
    l = jnp.arange(length, dtype=dta_re.dtype)           # (L,)
    ph_re = dta_re[..., None] * l                        # (H, N/2, L)
    ph_im = dta_im[..., None] * l
    mag = jnp.exp(ph_re)
    e_re = mag * jnp.cos(ph_im)
    e_im = mag * jnp.sin(ph_im)
    # 2·Re(bc · e) — two real contractions over the state axis
    return 2.0 * (
        jnp.einsum("hn,hnl->hl", bc_re, e_re)
        - jnp.einsum("hn,hnl->hl", bc_im, e_im)
    )


def _conv_len(L: int) -> int:
    """Smallest stage-smooth FFT length >= 2L−1 for the causal convolution
    (2L when L is a power of two — the packed-rfft sweet spot)."""
    m = 2 * L
    while not is_smooth(m, 256):
        m += 2  # stay even: the packed-rfft fast path needs even lengths
    return m


def s4d_conv(p: Params, u: Array, *,
             config: SpectralConfig = DEFAULT_CONFIG) -> Array:
    """Causal depthwise convolution y = K * u + D·u over (B, L, H) inputs,
    via the library's packed rFFT (one forward per operand, one inverse)."""
    B, L, H = u.shape
    k = s4d_kernel(p, L)                                 # (H, L)
    m = _conv_len(L)
    uf = rfft(jnp.moveaxis(u, -1, -2), n=m, config=config)   # (B, H, M/2+1)
    kf = rfft(k, n=m, config=config)                         # (H, M/2+1)
    y = irfft(uf * kf[None], n=m, config=config)[..., :L]    # causal slice
    return jnp.moveaxis(y, -2, -1) + u * p["d"]


def s4d_step(p: Params, s_re: Array, s_im: Array, u: Array,
             ) -> Tuple[Tuple[Array, Array], Array]:
    """One recurrent step for streaming inference: state (B, H, N/2) planes,
    input (B, H).  Returns ((s_re', s_im'), y) with y = 2·Re(C·s') + D·u —
    identical output to ``s4d_conv`` fed the same prefix (oracle-tested)."""
    abar_re, abar_im, bc_re, bc_im = _discretize(p)
    # s' = Ā s + B̄ u carries the B̄-scaled history; C stays in the readout
    a_re = -jnp.exp(p["log_neg_a_re"])[None, :]
    a_im = p["a_im"][None, :]
    num_re, num_im = abar_re - 1.0, abar_im
    den = a_re * a_re + a_im * a_im
    bbar_re = (num_re * a_re + num_im * a_im) / den      # (H, N/2)
    bbar_im = (num_im * a_re - num_re * a_im) / den
    s_re_n = s_re * abar_re - s_im * abar_im + u[..., None] * bbar_re
    s_im_n = s_re * abar_im + s_im * abar_re + u[..., None] * bbar_im
    y = 2.0 * jnp.sum(p["c_re"] * s_re_n - p["c_im"] * s_im_n, axis=-1)
    return (s_re_n, s_im_n), y + u * p["d"]


def _layer_norm(x: Array, scale: Array, bias: Array, eps: float = 1e-6) -> Array:
    mu = jnp.mean(x, axis=-1, keepdims=True)
    var = jnp.mean((x - mu) ** 2, axis=-1, keepdims=True)
    return (x - mu) * jax.lax.rsqrt(var + eps) * scale + bias


def block_apply(p: Params, x: Array, *,
                config: SpectralConfig = DEFAULT_CONFIG) -> Array:
    """Prenorm residual S4D block: x + W·GELU(s4d(LN(x)))."""
    h = _layer_norm(x, p["ln_scale"], p["ln_bias"])
    h = s4d_conv(p, h, config=config)
    h = jax.nn.gelu(h)
    return x + h @ p["w_out"] + p["b_out"]


def init_s4d_model(key, hidden: int, n_layers: int = 2, state: int = 64,
                   in_dim: int = 1, out_dim: int = 1,
                   dtype=jnp.float32) -> Dict[str, object]:
    """Encoder: linear embed → n S4D blocks → mean-pool → linear head."""
    keys = jax.random.split(key, n_layers + 2)
    return {
        "embed_w": (jax.random.normal(keys[0], (in_dim, hidden))
                    / math.sqrt(in_dim)).astype(dtype),
        "embed_b": jnp.zeros((hidden,), dtype),
        "layers": [init_s4d_layer(k, hidden, state, dtype=dtype)
                   for k in keys[1:-1]],
        "head_w": (jax.random.normal(keys[-1], (hidden, out_dim))
                   / math.sqrt(hidden)).astype(dtype),
        "head_b": jnp.zeros((out_dim,), dtype),
    }


def apply_s4d(params: Dict[str, object], u: Array, *,
              pool: bool = True,
              config: SpectralConfig = DEFAULT_CONFIG) -> Array:
    """(B, L, in_dim) → (B, out_dim) when ``pool`` else (B, L, out_dim)."""
    x = u @ params["embed_w"] + params["embed_b"]
    for p in params["layers"]:
        x = block_apply(p, x, config=config)
    if pool:
        x = jnp.mean(x, axis=1)
    return x @ params["head_w"] + params["head_b"]


def loss_fn(params, u: Array, target: Array, *,
            config: SpectralConfig = DEFAULT_CONFIG) -> Array:
    pred = apply_s4d(params, u, pool=(target.ndim == 2), config=config)
    return jnp.mean((pred - target) ** 2)


def train_step(params, u: Array, target: Array, lr: float = 1e-3, *,
               config: SpectralConfig = DEFAULT_CONFIG):
    loss, grads = jax.value_and_grad(
        lambda p: loss_fn(p, u, target, config=config)
    )(params)
    params = jax.tree_util.tree_map(lambda p, g: p - lr * g, params, grads)
    return params, loss
