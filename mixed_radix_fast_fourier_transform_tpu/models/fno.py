"""Fourier Neural Operator (1-D): a second model family built on the engine.

The reference ships no models; the spectral-filter flagship
(:mod:`.spectral_filter`) is its demo promoted to a trainable pipeline.  This
module goes one step further into real ML territory: FNO layers mix channels
in the frequency domain

    y = act( W·x  +  irfft( R ⊙ rfft(x) ) )

with a learned complex tensor R over the lowest ``modes`` frequency bins —
the standard neural-operator block (Li et al., 2021), here running on this
library's plan-based rFFT instead of a framework builtin.  Device-shaped by
construction: the spectral mix is an einsum over channels on the
low-mode slice, everything else is elementwise (fused by XLA).

Functional API: params are dict pytrees, apply/train_step are jittable and
differentiate through every stage matmul of the FFT engine.
"""

from __future__ import annotations

from typing import Dict

import jax
import jax.numpy as jnp

from ..ops.rfft import irfft, rfft
from ..utils.config import DEFAULT_CONFIG, SpectralConfig

Array = jax.Array
Params = Dict[str, Array]


def init_layer(key, channels: int, modes: int, dtype=jnp.float32) -> Params:
    k1, k2, k3 = jax.random.split(key, 3)
    scale = 1.0 / channels
    return {
        "r_re": scale * jax.random.normal(k1, (channels, channels, modes), dtype),
        "r_im": scale * jax.random.normal(k2, (channels, channels, modes), dtype),
        "w": scale * jax.random.normal(k3, (channels, channels), dtype),
        "b": jnp.zeros((channels,), dtype),
    }


def init_fno(
    key,
    in_channels: int,
    hidden: int,
    out_channels: int,
    n_layers: int = 2,
    modes: int = 16,
    dtype=jnp.float32,
) -> Dict[str, object]:
    keys = jax.random.split(key, n_layers + 2)
    return {
        "lift": {
            "w": jax.random.normal(keys[0], (in_channels, hidden), dtype)
            / max(in_channels, 1),
            "b": jnp.zeros((hidden,), dtype),
        },
        "layers": [init_layer(keys[i + 1], hidden, modes, dtype) for i in range(n_layers)],
        "proj": {
            "w": jax.random.normal(keys[-1], (hidden, out_channels), dtype) / hidden,
            "b": jnp.zeros((out_channels,), dtype),
        },
    }


def spectral_mix(layer: Params, x: Array, *, config: SpectralConfig) -> Array:
    """(batch, channels, n) -> (batch, channels, n): per-mode channel mixing."""
    n = x.shape[-1]
    modes = layer["r_re"].shape[-1]
    spec = rfft(x, config=config)  # (b, c, n//2+1) complex
    lo = spec[..., :modes]
    r = jax.lax.complex(layer["r_re"], layer["r_im"])  # (c_in, c_out, modes)
    mixed = jnp.einsum("bim,iom->bom", lo, r)
    pad = spec.shape[-1] - modes
    mixed = jnp.pad(mixed, ((0, 0), (0, 0), (0, pad)))
    return irfft(mixed, n=n, config=config)


def fno_layer(layer: Params, x: Array, *, config: SpectralConfig) -> Array:
    local = jnp.einsum("bin,io->bon", x, layer["w"]) + layer["b"][None, :, None]
    return jax.nn.gelu(local + spectral_mix(layer, x, config=config))


def apply(params: Dict[str, object], x: Array, *, config: SpectralConfig = DEFAULT_CONFIG) -> Array:
    """(batch, in_channels, n) -> (batch, out_channels, n)."""
    h = jnp.einsum("bin,io->bon", x, params["lift"]["w"]) + params["lift"]["b"][None, :, None]
    for layer in params["layers"]:
        h = fno_layer(layer, h, config=config)
    return jnp.einsum("bin,io->bon", h, params["proj"]["w"]) + params["proj"]["b"][None, :, None]


def loss_fn(params, x, target, *, config=DEFAULT_CONFIG) -> Array:
    return jnp.mean((apply(params, x, config=config) - target) ** 2)


def train_step(params, x, target, lr: float = 1e-3, *, config=DEFAULT_CONFIG):
    loss, grads = jax.value_and_grad(loss_fn)(params, x, target, config=config)
    params = jax.tree_util.tree_map(lambda p, g: p - lr * g, params, grads)
    return params, loss


# ---------------------------------------------------------------------------
# 2-D FNO: the standard image/PDE-grid operator block, built on rfft2-style
# separable transforms (rfft over W, complex fft over H).
# ---------------------------------------------------------------------------

def init_layer2d(key, channels: int, modes_h: int, modes_w: int, dtype=jnp.float32) -> Params:
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    scale = 1.0 / channels
    shape = (channels, channels, modes_h, modes_w)
    # Two learned tensors, one per low-frequency corner of the half-plane
    # spectrum (non-negative and negative H modes) — the standard FNO-2D
    # block (Li et al. 2021) needs both: with only the non-negative corner,
    # operators with energy in the negative H modes are unrepresentable.
    return {
        "r_re": scale * jax.random.normal(k1, shape, dtype),
        "r_im": scale * jax.random.normal(k2, shape, dtype),
        "r2_re": scale * jax.random.normal(k4, shape, dtype),
        "r2_im": scale * jax.random.normal(k5, shape, dtype),
        "w": scale * jax.random.normal(k3, (channels, channels), dtype),
        "b": jnp.zeros((channels,), dtype),
    }


def init_fno2d(
    key, in_channels: int, hidden: int, out_channels: int,
    n_layers: int = 2, modes: int = 8, dtype=jnp.float32,
) -> Dict[str, object]:
    keys = jax.random.split(key, n_layers + 2)
    return {
        "lift": {
            "w": jax.random.normal(keys[0], (in_channels, hidden), dtype)
            / max(in_channels, 1),
            "b": jnp.zeros((hidden,), dtype),
        },
        "layers": [
            init_layer2d(keys[i + 1], hidden, modes, modes, dtype)
            for i in range(n_layers)
        ],
        "proj": {
            "w": jax.random.normal(keys[-1], (hidden, out_channels), dtype) / hidden,
            "b": jnp.zeros((out_channels,), dtype),
        },
    }


def spectral_mix2d(layer: Params, x: Array, *, config: SpectralConfig) -> Array:
    """(b, c, H, W) -> (b, c, H, W): low-mode channel mixing in 2-D frequency
    space (rfft over W, complex fft over H).  Mixes BOTH low-frequency corners
    of the half-plane spectrum — non-negative H modes (spec[:mh]) with r and
    negative H modes (spec[-mh:]) with r2 — the standard FNO-2D block
    (Li et al. 2021)."""
    from ..ops.fft import fft, ifft

    bh, bw = x.shape[-2], x.shape[-1]
    mh, mw = layer["r_re"].shape[-2:]
    if 2 * mh > bh:
        raise ValueError(f"modes_h={mh} needs H >= 2*modes_h, got H={bh}")
    spec = fft(rfft(x, config=config), axis=-2, config=config)  # (b,c,H,W//2+1)
    r = jax.lax.complex(layer["r_re"], layer["r_im"])
    r2 = jax.lax.complex(layer["r2_re"], layer["r2_im"])
    mixed = jnp.zeros(spec.shape[:1] + r.shape[1:2] + spec.shape[2:], dtype=spec.dtype)
    mixed = mixed.at[..., :mh, :mw].set(
        jnp.einsum("bihw,iohw->bohw", spec[..., :mh, :mw], r)
    )
    mixed = mixed.at[..., bh - mh :, :mw].set(
        jnp.einsum("bihw,iohw->bohw", spec[..., bh - mh :, :mw], r2)
    )
    return irfft(ifft(mixed, axis=-2, config=config), n=bw, config=config)


def fno2d_layer(layer: Params, x: Array, *, config: SpectralConfig) -> Array:
    local = jnp.einsum("bihw,io->bohw", x, layer["w"]) + layer["b"][None, :, None, None]
    return jax.nn.gelu(local + spectral_mix2d(layer, x, config=config))


def apply2d(params, x: Array, *, config: SpectralConfig = DEFAULT_CONFIG) -> Array:
    """(batch, in_channels, H, W) -> (batch, out_channels, H, W)."""
    h = jnp.einsum("bihw,io->bohw", x, params["lift"]["w"]) + params["lift"]["b"][None, :, None, None]
    for layer in params["layers"]:
        h = fno2d_layer(layer, h, config=config)
    return jnp.einsum("bihw,io->bohw", h, params["proj"]["w"]) + params["proj"]["b"][None, :, None, None]


def loss_fn2d(params, x, target, *, config=DEFAULT_CONFIG) -> Array:
    return jnp.mean((apply2d(params, x, config=config) - target) ** 2)


def train_step2d(params, x, target, lr: float = 1e-3, *, config=DEFAULT_CONFIG):
    loss, grads = jax.value_and_grad(loss_fn2d)(params, x, target, config=config)
    params = jax.tree_util.tree_map(lambda p, g: p - lr * g, params, grads)
    return params, loss


# ---------------------------------------------------------------------------
# 3-D FNO: the volumetric/PDE operator block (rfft over W, complex fft over
# H and D).  Four learned tensors — one per signed-frequency corner of the
# (D, H) plane (the W axis is the non-negative rfft half), the standard
# FNO-3D layout (Li et al. 2021).
# ---------------------------------------------------------------------------

def init_layer3d(key, channels: int, modes_d: int, modes_h: int, modes_w: int,
                 dtype=jnp.float32) -> Params:
    keys = jax.random.split(key, 10)
    scale = 1.0 / channels
    shape = (channels, channels, modes_d, modes_h, modes_w)
    out: Params = {
        "w": scale * jax.random.normal(keys[8], (channels, channels), dtype),
        "b": jnp.zeros((channels,), dtype),
    }
    for i in range(4):
        out[f"r{i}_re"] = scale * jax.random.normal(keys[2 * i], shape, dtype)
        out[f"r{i}_im"] = scale * jax.random.normal(keys[2 * i + 1], shape, dtype)
    return out


def init_fno3d(
    key, in_channels: int, hidden: int, out_channels: int,
    n_layers: int = 2, modes: int = 4, dtype=jnp.float32,
) -> Dict[str, object]:
    keys = jax.random.split(key, n_layers + 2)
    return {
        "lift": {
            "w": jax.random.normal(keys[0], (in_channels, hidden), dtype)
            / max(in_channels, 1),
            "b": jnp.zeros((hidden,), dtype),
        },
        "layers": [
            init_layer3d(keys[i + 1], hidden, modes, modes, modes, dtype)
            for i in range(n_layers)
        ],
        "proj": {
            "w": jax.random.normal(keys[-1], (hidden, out_channels), dtype) / hidden,
            "b": jnp.zeros((out_channels,), dtype),
        },
    }


def spectral_mix3d(layer: Params, x: Array, *, config: SpectralConfig) -> Array:
    """(b, c, D, H, W) -> (b, c, D, H, W): low-mode channel mixing in 3-D
    frequency space over all four signed-frequency corners of the (D, H)
    plane."""
    from ..ops.fft import fft, ifft

    bd, bh, bw = x.shape[-3], x.shape[-2], x.shape[-1]
    md, mh, mw = layer["r0_re"].shape[-3:]
    if 2 * md > bd or 2 * mh > bh:
        raise ValueError(
            f"modes ({md}, {mh}) need D >= 2*modes_d and H >= 2*modes_h, "
            f"got ({bd}, {bh})"
        )
    spec = rfft(x, config=config)                      # (b,c,D,H,W//2+1)
    spec = fft(spec, axis=-2, config=config)           # over H
    spec = fft(spec, axis=-3, config=config)           # over D
    mixed = jnp.zeros(
        spec.shape[:1] + layer["r0_re"].shape[1:2] + spec.shape[2:],
        dtype=spec.dtype,
    )
    corners = [
        (slice(None, md), slice(None, mh), 0),
        (slice(bd - md, None), slice(None, mh), 1),
        (slice(None, md), slice(bh - mh, None), 2),
        (slice(bd - md, None), slice(bh - mh, None), 3),
    ]
    for sd, sh, i in corners:
        r = jax.lax.complex(layer[f"r{i}_re"], layer[f"r{i}_im"])
        mixed = mixed.at[..., sd, sh, :mw].set(
            jnp.einsum("bidhw,iodhw->bodhw", spec[..., sd, sh, :mw], r)
        )
    out = ifft(mixed, axis=-3, config=config)
    out = ifft(out, axis=-2, config=config)
    return irfft(out, n=bw, config=config)


def fno3d_layer(layer: Params, x: Array, *, config: SpectralConfig) -> Array:
    local = jnp.einsum("bidhw,io->bodhw", x, layer["w"]) + layer["b"][
        None, :, None, None, None
    ]
    return jax.nn.gelu(local + spectral_mix3d(layer, x, config=config))


def apply3d(params, x: Array, *, config: SpectralConfig = DEFAULT_CONFIG) -> Array:
    """(batch, in_channels, D, H, W) -> (batch, out_channels, D, H, W)."""
    h = jnp.einsum("bidhw,io->bodhw", x, params["lift"]["w"]) + params["lift"]["b"][
        None, :, None, None, None
    ]
    for layer in params["layers"]:
        h = fno3d_layer(layer, h, config=config)
    return jnp.einsum("bidhw,io->bodhw", h, params["proj"]["w"]) + params["proj"]["b"][
        None, :, None, None, None
    ]


def loss_fn3d(params, x, target, *, config=DEFAULT_CONFIG) -> Array:
    return jnp.mean((apply3d(params, x, config=config) - target) ** 2)


def train_step3d(params, x, target, lr: float = 1e-3, *, config=DEFAULT_CONFIG):
    loss, grads = jax.value_and_grad(loss_fn3d)(params, x, target, config=config)
    params = jax.tree_util.tree_map(lambda p, g: p - lr * g, params, grads)
    return params, loss
