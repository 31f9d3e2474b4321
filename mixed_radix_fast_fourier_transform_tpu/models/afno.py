"""Adaptive Fourier Neural Operator (AFNO) — the FourCastNet-class mixer.

Third neural-operator family on the engine (after :mod:`.fno` and
:mod:`.sfno`): a ViT-style backbone whose token mixing happens in the 2-D
Fourier domain (Guibas et al., 2022).  Each block computes

    x = x + irfft2( softshrink( BlockMLP( rfft2(LN(x)) ) ) )
    x = x + MLP(LN(x))

where BlockMLP is a two-layer complex MLP applied BLOCK-DIAGONALLY over the
channel dimension (channels split into ``n_blocks`` groups — O(d²/nb)
weights instead of FNO's O(d²·modes)), and softshrink(z, λ) =
sign(z)·max(|z|−λ, 0) adaptively sparsifies the spectrum.  A hard mode
fraction keeps only the lowest spatial frequencies (static slices — XLA
sees fixed shapes).

Device shape: the spectral MLP is einsums over (block, channel) on the kept
low-mode tensor; complex arithmetic is explicit (re, im) plane pairs
(four real matmuls per complex product — no complex64 in the hot path);
the rfft2/irfft2 ride the plan-based engine.  Everything is a dict pytree
with jittable, differentiable apply/train_step like the other families.

The reference ships no models (src/ is the C FFT engine alone); this module
is capability extension built on the same transform stack.
"""

from __future__ import annotations

from typing import Dict

import jax
import jax.numpy as jnp

from ..ops.rfft import irfft2, rfft2
from ..utils.config import DEFAULT_CONFIG, SpectralConfig

Array = jax.Array
Params = Dict[str, Array]


def _layer_norm(x: Array, scale: Array, bias: Array, eps: float = 1e-6) -> Array:
    mu = jnp.mean(x, axis=-1, keepdims=True)
    var = jnp.var(x, axis=-1, keepdims=True)
    return (x - mu) * jax.lax.rsqrt(var + eps) * scale + bias


def init_block(
    key, dim: int, n_blocks: int, mlp_ratio: float = 4.0, dtype=jnp.float32
) -> Params:
    if dim % n_blocks:
        raise ValueError(f"dim {dim} not divisible by n_blocks {n_blocks}")
    bs = dim // n_blocks
    hidden = bs  # AFNO uses a square block MLP in the spectral domain
    ks = jax.random.split(key, 6)
    s = 0.02
    ff = int(dim * mlp_ratio)
    return {
        # spectral block-diagonal complex MLP: (nb, bs, hidden) × {re, im}
        "w1_re": s * jax.random.normal(ks[0], (n_blocks, bs, hidden), dtype),
        "w1_im": s * jax.random.normal(ks[1], (n_blocks, bs, hidden), dtype),
        "b1_re": jnp.zeros((n_blocks, hidden), dtype),
        "b1_im": jnp.zeros((n_blocks, hidden), dtype),
        "w2_re": s * jax.random.normal(ks[2], (n_blocks, hidden, bs), dtype),
        "w2_im": s * jax.random.normal(ks[3], (n_blocks, hidden, bs), dtype),
        "b2_re": jnp.zeros((n_blocks, bs), dtype),
        "b2_im": jnp.zeros((n_blocks, bs), dtype),
        # token MLP
        "mlp_w1": s * jax.random.normal(ks[4], (dim, ff), dtype),
        "mlp_b1": jnp.zeros((ff,), dtype),
        "mlp_w2": s * jax.random.normal(ks[5], (ff, dim), dtype),
        "mlp_b2": jnp.zeros((dim,), dtype),
        "ln1_s": jnp.ones((dim,), dtype),
        "ln1_b": jnp.zeros((dim,), dtype),
        "ln2_s": jnp.ones((dim,), dtype),
        "ln2_b": jnp.zeros((dim,), dtype),
    }


def init_afno(
    key,
    in_channels: int,
    dim: int,
    out_channels: int,
    *,
    patch: int = 4,
    n_layers: int = 2,
    n_blocks: int = 4,
    mlp_ratio: float = 4.0,
    dtype=jnp.float32,
) -> Dict[str, object]:
    """AFNO for (batch, H, W, in_channels) fields: patch embed -> n_layers
    AFNO blocks -> patch de-embed to (batch, H, W, out_channels)."""
    keys = jax.random.split(key, n_layers + 2)
    pdim = patch * patch * in_channels
    return {
        "embed": {
            "w": jax.random.normal(keys[0], (pdim, dim), dtype) / pdim,
            "b": jnp.zeros((dim,), dtype),
        },
        "blocks": [
            init_block(keys[i + 1], dim, n_blocks, mlp_ratio, dtype)
            for i in range(n_layers)
        ],
        "head": {
            "w": jax.random.normal(
                keys[-1], (dim, patch * patch * out_channels), dtype
            ) / dim,
            "b": jnp.zeros((patch * patch * out_channels,), dtype),
        },
    }


def _softshrink(x: Array, lam: float) -> Array:
    return jnp.sign(x) * jnp.maximum(jnp.abs(x) - lam, 0.0)


def afno_filter(
    p: Params,
    x: Array,
    n_blocks: int,
    *,
    sparsity: float = 0.01,
    hard_fraction: float = 1.0,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Spectral token mixing: (b, h, w, d) -> (b, h, w, d).

    rfft2 over the token grid, block-diagonal two-layer complex MLP with
    ReLU on the kept modes, soft shrinkage, irfft2.  ``hard_fraction``
    statically truncates to the lowest |k_h| rows and first k_w columns."""
    b, h, w, d = x.shape
    bs = d // n_blocks
    # channels-first planes for the spatial transform
    xc = jnp.moveaxis(x, -1, 1)  # (b, d, h, w)
    spec = rfft2(xc, config=config)  # (b, d, h, w//2+1) complex
    sr, si = jnp.real(spec), jnp.imag(spec)
    wb = spec.shape[-1]
    kh = max(1, min(h, int(h * hard_fraction)))
    kw = max(1, min(wb, int(wb * hard_fraction)))
    # kept rows: lowest |freq| along h — [0:ceil(kh/2)] and [h-floor(kh/2):]
    top = -(-kh // 2)
    bot = kh // 2

    def keep(a):
        if bot == 0:
            return a[..., :top, :kw]
        return jnp.concatenate([a[..., :top, :kw], a[..., h - bot :, :kw]], axis=-2)

    lr_, li_ = keep(sr), keep(si)  # (b, d, kh, kw)
    # (b, nb, bs, kh, kw)
    lr_ = lr_.reshape(b, n_blocks, bs, kh, kw)
    li_ = li_.reshape(b, n_blocks, bs, kh, kw)
    prec = config.op_precision

    def cmm(ar, ai, wre, wim, br, bi):
        # complex (…, c) @ (nb, c, o) + bias, on planes
        re = (
            jnp.einsum("bnchw,nco->bnohw", ar, wre, precision=prec)
            - jnp.einsum("bnchw,nco->bnohw", ai, wim, precision=prec)
            + br[None, :, :, None, None]
        )
        im = (
            jnp.einsum("bnchw,nco->bnohw", ai, wre, precision=prec)
            + jnp.einsum("bnchw,nco->bnohw", ar, wim, precision=prec)
            + bi[None, :, :, None, None]
        )
        return re, im

    o1r, o1i = cmm(lr_, li_, p["w1_re"], p["w1_im"], p["b1_re"], p["b1_im"])
    o1r, o1i = jax.nn.relu(o1r), jax.nn.relu(o1i)
    o2r, o2i = cmm(o1r, o1i, p["w2_re"], p["w2_im"], p["b2_re"], p["b2_im"])
    o2r = _softshrink(o2r, sparsity)
    o2i = _softshrink(o2i, sparsity)
    o2r = o2r.reshape(b, d, kh, kw)
    o2i = o2i.reshape(b, d, kh, kw)

    def scatter(lo):
        z = jnp.zeros((b, d, h, wb), lo.dtype)
        z = z.at[..., :top, :kw].set(lo[..., :top, :])
        if bot:
            z = z.at[..., h - bot :, :kw].set(lo[..., top:, :])
        return z

    full = jax.lax.complex(scatter(o2r), scatter(o2i))
    out = irfft2(full, s=(h, w), config=config)
    return jnp.moveaxis(out, 1, -1)


def afno_block(
    p: Params,
    x: Array,
    n_blocks: int,
    *,
    sparsity: float = 0.01,
    hard_fraction: float = 1.0,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    h = _layer_norm(x, p["ln1_s"], p["ln1_b"])
    x = x + afno_filter(
        p, h, n_blocks, sparsity=sparsity, hard_fraction=hard_fraction,
        config=config,
    )
    h = _layer_norm(x, p["ln2_s"], p["ln2_b"])
    h = jax.nn.gelu(h @ p["mlp_w1"] + p["mlp_b1"])
    return x + (h @ p["mlp_w2"] + p["mlp_b2"])


def apply(
    params: Dict[str, object],
    x: Array,
    *,
    patch: int = 4,
    n_blocks: int = 4,
    sparsity: float = 0.01,
    hard_fraction: float = 1.0,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """(batch, H, W, in_channels) -> (batch, H, W, out_channels); ``patch``
    must divide H and W (static — pass the same value used at init)."""
    p = int(patch)
    b, H, W, cin = x.shape
    if H % p or W % p:
        raise ValueError(f"patch={p} must divide H={H} and W={W}")
    hp, wp = H // p, W // p
    # patchify: (b, hp, wp, p*p*cin)
    t = x.reshape(b, hp, p, wp, p, cin).transpose(0, 1, 3, 2, 4, 5)
    t = t.reshape(b, hp, wp, p * p * cin)
    t = t @ params["embed"]["w"] + params["embed"]["b"]
    for blk in params["blocks"]:
        t = afno_block(
            blk, t, n_blocks, sparsity=sparsity,
            hard_fraction=hard_fraction, config=config,
        )
    t = t @ params["head"]["w"] + params["head"]["b"]
    cout = t.shape[-1] // (p * p)
    t = t.reshape(b, hp, wp, p, p, cout).transpose(0, 1, 3, 2, 4, 5)
    return t.reshape(b, H, W, cout)


def loss_fn(params, x, target, **kw) -> Array:
    return jnp.mean((apply(params, x, **kw) - target) ** 2)


def train_step(params, x, target, lr: float = 1e-3, **kw):
    loss, grads = jax.value_and_grad(loss_fn)(params, x, target, **kw)
    params = jax.tree_util.tree_map(lambda p, g: p - lr * g, params, grads)
    return params, loss
