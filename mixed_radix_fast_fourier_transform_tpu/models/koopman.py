"""Koopman autoencoder: learned linear latent dynamics (Lusch et al. 2018).

Ninth model family: an encoder φ lifts nonlinear system states into a
latent space where one matrix K advances time — the TRAINABLE counterpart
of :func:`..ops.datadriven.dmd` (DMD fits K on raw snapshots; here the
coordinates are learned jointly so strongly nonlinear dynamics become
linear).  Multi-step forecasting is latent matrix powers + one decode:
``x̂_{t+s} = ψ(K^s φ(x_t))`` — the rollout is a `lax.scan` over matmuls,
every step as matmuls, and the learned spectrum (eig K) reads exactly like
a DMD mode analysis.

Plain pytree params + functional apply, matching the other model families;
the reference C library has no models at all.
"""

from __future__ import annotations

from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array
Params = Dict[str, object]

__all__ = ["init_koopman", "koopman_encode", "koopman_decode",
           "koopman_rollout", "koopman_loss", "koopman_spectrum"]


def _init_mlp(key, sizes, dtype):
    layers = []
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        key, sub = jax.random.split(key)
        w = jax.random.normal(sub, (a, b), dtype) * jnp.sqrt(2.0 / a)
        layers.append({"w": w, "b": jnp.zeros((b,), dtype)})
    return key, layers


def _mlp(layers, x):
    for i, l in enumerate(layers):
        x = x @ l["w"] + l["b"]
        if i < len(layers) - 1:
            x = jax.nn.gelu(x)
    return x


def init_koopman(key, state_dim: int, latent_dim: int = 16,
                 hidden: int = 64, depth: int = 2,
                 dtype=jnp.float32) -> Params:
    """Encoder/decoder MLPs (``depth`` hidden layers of ``hidden``) and the
    latent advance matrix K, initialized as a slightly contractive
    identity so early rollouts don't explode."""
    if latent_dim < 1 or state_dim < 1:
        raise ValueError("state_dim and latent_dim must be >= 1")
    enc_sizes = [state_dim] + [hidden] * depth + [latent_dim]
    dec_sizes = [latent_dim] + [hidden] * depth + [state_dim]
    key, enc = _init_mlp(key, enc_sizes, dtype)
    key, dec = _init_mlp(key, dec_sizes, dtype)
    K = 0.99 * jnp.eye(latent_dim, dtype=dtype)
    return {"enc": enc, "dec": dec, "K": K}


def koopman_encode(params: Params, x: Array) -> Array:
    """States (..., state_dim) → latents (..., latent_dim)."""
    return _mlp(params["enc"], x)


def koopman_decode(params: Params, z: Array) -> Array:
    """Latents (..., latent_dim) → states (..., state_dim)."""
    return _mlp(params["dec"], z)


def koopman_rollout(params: Params, x0: Array, n_steps: int) -> Array:
    """Forecast: encode once, advance ``n_steps`` in the linear latent
    space (a scan of matmuls), decode every step.  Returns
    (n_steps + 1, ..., state_dim) including the reconstruction of x0."""
    if n_steps < 0:
        raise ValueError("n_steps must be >= 0")
    z0 = koopman_encode(params, x0)
    K = params["K"]

    def step(z, _):
        z_next = z @ K
        return z_next, z_next

    _, zs = jax.lax.scan(step, z0, None, length=n_steps)
    z_all = jnp.concatenate([z0[None], zs], axis=0)
    return koopman_decode(params, z_all)


def koopman_loss(params: Params, trajs: Array, horizon: int = 8,
                 w_recon: float = 1.0, w_pred: float = 1.0,
                 w_lin: float = 0.3) -> Array:
    """Lusch-style objective on (batch, T, state_dim) trajectories:
    reconstruction ‖x − ψφx‖², multi-step prediction
    ‖x_{t+s} − ψ(K^sφx_t)‖², and latent linearity ‖φx_{t+s} − K^sφx_t‖²
    over s = 1..horizon."""
    trajs = jnp.asarray(trajs)
    if trajs.ndim != 3:
        raise ValueError("trajs must be (batch, T, state_dim)")
    B, T, D = trajs.shape
    if T <= horizon:
        raise ValueError(f"need T > horizon, got T={T}, horizon={horizon}")
    z = koopman_encode(params, trajs)            # (B, T, L)
    x_rec = koopman_decode(params, z)
    loss = w_recon * jnp.mean((x_rec - trajs) ** 2)
    K = params["K"]
    z_s = z[:, : T - horizon]                    # rollout sources
    for s in range(1, horizon + 1):
        z_s = z_s @ K                            # K^s φ(x_t)
        target_x = trajs[:, s: T - horizon + s]
        target_z = z[:, s: T - horizon + s]
        loss = loss + (w_pred / horizon) * jnp.mean(
            (koopman_decode(params, z_s) - target_x) ** 2)
        loss = loss + (w_lin / horizon) * jnp.mean((z_s - target_z) ** 2)
    return loss


def koopman_spectrum(params: Params) -> Tuple[np.ndarray, np.ndarray]:
    """(eigenvalues, continuous rates log λ) of the learned latent advance
    — read like a DMD spectrum (|λ| < 1 decaying, angle = frequency)."""
    eigs = np.linalg.eigvals(np.asarray(params["K"], np.float64))
    return eigs, np.log(eigs.astype(np.complex128))
