"""Spherical Fourier Neural Operator (SFNO) — learning on the sphere.

Third neural-operator family built on the engine (after FNO-1/2/3D and
FNet): channels mix in the SPHERICAL-HARMONIC basis, the architecture of
modern ML weather models (Bonev et al., ICML 2023).  Each layer computes

    y = act( W·x + Re isht( R_l ⊙ sht(x) ) )

with a learned complex tensor R[i, o, l] that depends on the DEGREE l only —
by Schur's lemma that is exactly the set of linear maps commuting with
rotations, so the spectral path is SO(3)-equivariant by construction (tested
via exact azimuthal grid rotations).  The sht/isht pair is this library's
Gauss-Legendre transform (:mod:`..ops.sht`): Legendre tables contract as
matmuls and longitude rides the batched engine FFT.

Functional API mirroring :mod:`.fno`: params are dict pytrees; apply /
loss_fn / train_step are jittable and differentiate through the transforms.
"""

from __future__ import annotations

from typing import Dict

import jax
import jax.numpy as jnp

from ..ops.sht import isht, sht
from ..utils.config import DEFAULT_CONFIG, SpectralConfig

Array = jax.Array
Params = Dict[str, Array]


def init_layer(key, channels: int, L: int, dtype=jnp.float32) -> Params:
    k1, k2, k3 = jax.random.split(key, 3)
    scale = 1.0 / channels
    return {
        "r_re": scale * jax.random.normal(k1, (channels, channels, L), dtype),
        "r_im": scale * jax.random.normal(k2, (channels, channels, L), dtype),
        "w": scale * jax.random.normal(k3, (channels, channels), dtype),
        "b": jnp.zeros((channels,), dtype),
    }


def init_sfno(
    key,
    in_channels: int,
    hidden: int,
    out_channels: int,
    lmax: int,
    n_layers: int = 2,
    dtype=jnp.float32,
) -> Dict[str, object]:
    """Parameters for an SFNO operating on (batch, ch, L, 2L) sphere grids,
    L = lmax + 1 (the grid of :func:`..ops.sht.sht_grid`)."""
    L = lmax + 1
    keys = jax.random.split(key, n_layers + 2)
    return {
        "lift": {
            "w": jax.random.normal(keys[0], (in_channels, hidden), dtype)
            / max(in_channels, 1),
            "b": jnp.zeros((hidden,), dtype),
        },
        "layers": [init_layer(keys[i + 1], hidden, L, dtype) for i in range(n_layers)],
        "proj": {
            "w": jax.random.normal(keys[-1], (hidden, out_channels), dtype) / hidden,
            "b": jnp.zeros((out_channels,), dtype),
        },
    }


def spectral_mix(layer: Params, x: Array, *, config: SpectralConfig) -> Array:
    """(b, c, L, 2L) -> (b, c, L, 2L): per-degree channel mixing in SH space."""
    a = sht(x, config=config)  # (b, c, 2L-1, L) complex
    r = jax.lax.complex(layer["r_re"], layer["r_im"])  # (c_in, c_out, L)
    mixed = jnp.einsum("biql,iol->boql", a, r, precision=config.op_precision)
    return jnp.real(isht(mixed, config=config))


def sfno_layer(layer: Params, x: Array, *, config: SpectralConfig) -> Array:
    local = (
        jnp.einsum("bihw,io->bohw", x, layer["w"])
        + layer["b"][None, :, None, None]
    )
    return jax.nn.gelu(local + spectral_mix(layer, x, config=config))


def apply(
    params: Dict[str, object], x: Array, *, config: SpectralConfig = DEFAULT_CONFIG
) -> Array:
    """(batch, in_channels, L, 2L) -> (batch, out_channels, L, 2L)."""
    h = (
        jnp.einsum("bihw,io->bohw", x, params["lift"]["w"])
        + params["lift"]["b"][None, :, None, None]
    )
    for layer in params["layers"]:
        h = sfno_layer(layer, h, config=config)
    return (
        jnp.einsum("bihw,io->bohw", h, params["proj"]["w"])
        + params["proj"]["b"][None, :, None, None]
    )


def loss_fn(params, x, target, *, config=DEFAULT_CONFIG) -> Array:
    return jnp.mean((apply(params, x, config=config) - target) ** 2)


def train_step(params, x, target, lr: float = 1e-3, *, config=DEFAULT_CONFIG):
    loss, grads = jax.value_and_grad(loss_fn)(params, x, target, config=config)
    params = jax.tree_util.tree_map(lambda p, g: p - lr * g, params, grads)
    return params, loss
