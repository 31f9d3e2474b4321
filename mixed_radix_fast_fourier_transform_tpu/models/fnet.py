"""FNet encoder: parameter-free Fourier token mixing (Lee-Thorp et al. 2021).

Third model family on the engine.  The reference ships no models (its demo
harness at src/real.c:269-482 is disabled); here the library's plan-based FFT
replaces the attention sublayer of a transformer encoder:

    mix(x)  = Re( F_seq( F_hidden(x) ) )          (one 2-D FFT, no params)
    h       = LayerNorm( x + mix(x) )
    out     = LayerNorm( h + FFN(h) )             FFN = GELU(x·W1+b1)·W2+b2

The two FFT passes are stage matmuls batched over (batch·seq) and
(batch·hidden); LayerNorm/GELU are elementwise ops XLA fuses.  The FFN
products follow JAX's default matmul precision (TF32 on Hopper tensor
cores); wrap a step in ``jax.default_matmul_precision("highest")`` for
fp32 products.  The distributed variant runs the sequence-axis
FFT through the four-step all-to-all engine, giving sequence parallelism for
contexts longer than one chip — the transformer-shaped showcase of the
library's long-transform machinery.

Functional API matching the other model families: params are dict pytrees,
apply/train_step are jittable and differentiate through every FFT stage.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from ..ops.fft import fft
from ..parallel.distributed import fft_four_step
from ..utils.config import DEFAULT_CONFIG, SpectralConfig

Array = jax.Array
Params = Dict[str, object]


def init_layer(key, hidden: int, ff_dim: int, dtype=jnp.float32) -> Params:
    k1, k2 = jax.random.split(key)
    s1 = 1.0 / jnp.sqrt(jnp.asarray(hidden, jnp.float32))
    s2 = 1.0 / jnp.sqrt(jnp.asarray(ff_dim, jnp.float32))
    return {
        "ln1_scale": jnp.ones((hidden,), dtype),
        "ln1_bias": jnp.zeros((hidden,), dtype),
        "w1": (s1 * jax.random.normal(k1, (hidden, ff_dim))).astype(dtype),
        "b1": jnp.zeros((ff_dim,), dtype),
        "w2": (s2 * jax.random.normal(k2, (ff_dim, hidden))).astype(dtype),
        "b2": jnp.zeros((hidden,), dtype),
        "ln2_scale": jnp.ones((hidden,), dtype),
        "ln2_bias": jnp.zeros((hidden,), dtype),
    }


def init_fnet(
    key, hidden: int, ff_dim: Optional[int] = None, n_layers: int = 2,
    dtype=jnp.float32,
) -> Dict[str, List[Params]]:
    """Encoder stack over continuous inputs (batch, seq, hidden)."""
    ff_dim = ff_dim if ff_dim is not None else 4 * hidden
    keys = jax.random.split(key, n_layers)
    return {"layers": [init_layer(k, hidden, ff_dim, dtype) for k in keys]}


def _layer_norm(x: Array, scale: Array, bias: Array, eps: float = 1e-6) -> Array:
    mu = jnp.mean(x, axis=-1, keepdims=True)
    var = jnp.mean((x - mu) ** 2, axis=-1, keepdims=True)
    return (x - mu) * jax.lax.rsqrt(var + eps) * scale + bias


def fourier_mix(x: Array, *, config: SpectralConfig = DEFAULT_CONFIG) -> Array:
    """Token mixing: Re(F_seq(F_hidden(x))) over (..., seq, hidden) real."""
    z = fft(x, axis=-1, config=config)       # hidden-axis FFT
    z = fft(z, axis=-2, config=config)       # sequence-axis FFT
    return jnp.real(z)


def _encoder_layer(p: Params, x: Array, mix: Array) -> Array:
    h = _layer_norm(x + mix, p["ln1_scale"], p["ln1_bias"])
    ff = jax.nn.gelu(h @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]
    return _layer_norm(h + ff, p["ln2_scale"], p["ln2_bias"])


def apply(params, x: Array, *, config: SpectralConfig = DEFAULT_CONFIG) -> Array:
    """(batch, seq, hidden) real -> same shape."""
    for p in params["layers"]:
        x = _encoder_layer(p, x, fourier_mix(x, config=config))
    return x


def loss_fn(params, x, target, *, config=DEFAULT_CONFIG) -> Array:
    y = apply(params, x, config=config)
    return jnp.mean((y - target) ** 2)


def train_step(
    params, x, target, lr: float = 1e-2, *, config=DEFAULT_CONFIG
) -> Tuple[Params, Array]:
    """One SGD step — jittable, differentiates through both FFT passes."""
    loss, grads = jax.value_and_grad(loss_fn)(params, x, target, config=config)
    params = jax.tree_util.tree_map(lambda p, g: p - lr * g, params, grads)
    return params, loss


# ---------------------------------------------------------------------------
# Distributed variant: dp over "data" (batch) + sequence parallelism over
# "seq" — the sequence-axis mixing FFT runs through the four-step all-to-all
# engine, so contexts larger than one chip's memory still mix globally.
# ---------------------------------------------------------------------------

def fourier_mix_distributed(
    x: Array,
    mesh: Mesh,
    *,
    data_axis: Optional[str] = "data",
    seq_axis: str = "seq",
    n1: Optional[int] = None,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """Token mixing with the sequence axis sharded over ``seq_axis``.

    The hidden-axis FFT is local (batched over the sharded sequence); the
    sequence-axis FFT is the distributed four-step (three all-to-alls).
    ``x``: (batch, seq, hidden) sharded (data_axis, seq_axis, None).
    """
    z = fft(x, axis=-1, config=config)             # local, sharding propagates
    zt = jnp.swapaxes(z, -1, -2)                   # (batch, hidden, seq)
    zt = fft_four_step(
        zt, mesh, seq_axis=seq_axis, data_axis=data_axis, n1=n1, config=config
    )
    return jnp.real(jnp.swapaxes(zt, -1, -2))


def apply_distributed(
    params,
    x: Array,
    mesh: Mesh,
    *,
    data_axis: Optional[str] = "data",
    seq_axis: str = "seq",
    n1: Optional[int] = None,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    for p in params["layers"]:
        mix = fourier_mix_distributed(
            x, mesh, data_axis=data_axis, seq_axis=seq_axis, n1=n1, config=config
        )
        x = _encoder_layer(p, x, mix)
    return x


def loss_distributed(params, x, target, mesh, **kw) -> Array:
    y = apply_distributed(params, x, mesh, **kw)
    return jnp.mean((y - target) ** 2)


def train_step_distributed(
    params, x, target, mesh, lr: float = 1e-2, **kw
) -> Tuple[Params, Array]:
    """One SGD step of the sequence-parallel FNet; param grads are summed
    across the mesh by jit's partitioner, activation grads ride the reverse
    all-to-alls of the four-step transform."""
    loss, grads = jax.value_and_grad(loss_distributed)(params, x, target, mesh, **kw)
    params = jax.tree_util.tree_map(lambda p, g: p - lr * g, params, grads)
    return params, loss
