"""Flagship end-to-end model: a trainable spectral filter.

The reference ships no models — its closest analogue is the disabled demo
harness that generates sine signals, FFTs them, and checks MSE
(src/real.c:269-482).  This module turns that demo pattern into the library's
flagship differentiable pipeline: a learned per-bin complex gain applied in
the frequency domain,

    y = irfft( rfft(x) ⊙ (gain + i·gain_im) ) + bias

which is simultaneously (a) a real workload (learned FIR filtering /
spectral pooling / FNO-style mixing), (b) an autodiff test of the whole
engine (grad flows through every butterfly matmul and twiddle), and (c) the
vehicle for the distributed training step: batch sharded over the ``data``
mesh axis and the transform sharded over ``seq`` via the four-step engine.

Everything is functional: params are a dict pytree, steps are jittable.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from ..ops.rfft import irfft, rfft
from ..parallel.distributed import fft_four_step, ifft_four_step
from ..utils.config import DEFAULT_CONFIG, SpectralConfig

Array = jax.Array
Params = Dict[str, Array]


def init_params(key: jax.Array, n: int, dtype=jnp.float32) -> Params:
    """Per-bin complex gain (identity-initialized + noise) and a bias."""
    n_bins = n // 2 + 1
    k1, k2 = jax.random.split(key)
    return {
        "gain_re": 1.0 + 0.01 * jax.random.normal(k1, (n_bins,), dtype),
        "gain_im": 0.01 * jax.random.normal(k2, (n_bins,), dtype),
        "bias": jnp.zeros((), dtype),
    }


def apply(params: Params, x: Array, *, config: SpectralConfig = DEFAULT_CONFIG) -> Array:
    """Forward pass: (..., n) real -> (..., n) real."""
    n = x.shape[-1]
    spec = rfft(x, config=config)
    gain = jax.lax.complex(params["gain_re"], params["gain_im"])
    return irfft(spec * gain, n=n, config=config) + params["bias"]


def loss_fn(params: Params, x: Array, target: Array, *, config=DEFAULT_CONFIG) -> Array:
    """MSE between the filtered signal and the target."""
    y = apply(params, x, config=config)
    return jnp.mean((y - target) ** 2)


def train_step(
    params: Params, x: Array, target: Array, lr: float = 1e-2, *, config=DEFAULT_CONFIG
) -> Tuple[Params, Array]:
    """One SGD step — jittable, differentiates through the full FFT engine."""
    loss, grads = jax.value_and_grad(loss_fn)(params, x, target, config=config)
    params = jax.tree_util.tree_map(lambda p, g: p - lr * g, params, grads)
    return params, loss


# ---------------------------------------------------------------------------
# Distributed variant: dp over "data" (batch) + sp over "seq" (the transform
# axis, via the four-step all-to-all engine).  Complex-valued filter so the
# sharded transform is the plain complex four-step.
# ---------------------------------------------------------------------------

def init_params_complex(key: jax.Array, n: int, dtype=jnp.float32) -> Params:
    """Full-spectrum (length n) gain params for the distributed complex filter."""
    k1, k2 = jax.random.split(key)
    return {
        "gain_re": 1.0 + 0.01 * jax.random.normal(k1, (n,), dtype),
        "gain_im": 0.01 * jax.random.normal(k2, (n,), dtype),
        "bias": jnp.zeros((), dtype),
    }


def apply_distributed(
    params: Params,
    x: Array,
    mesh: Mesh,
    *,
    data_axis: Optional[str] = "data",
    seq_axis: str = "seq",
    n1: Optional[int] = None,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Array:
    """(batch, n) real -> (batch, n) real with batch and transform both sharded.

    Forward four-step FFT -> per-bin complex gain -> inverse four-step; the
    gain is replicated, activations stay sharded (data_axis, seq_axis)
    throughout, and each transform costs three all-to-alls.
    """
    spec = fft_four_step(
        x, mesh, seq_axis=seq_axis, data_axis=data_axis, n1=n1, config=config
    )
    gain = jax.lax.complex(params["gain_re"], params["gain_im"])
    y = ifft_four_step(
        spec * gain, mesh, seq_axis=seq_axis, data_axis=data_axis, n1=n1, config=config
    )
    return jnp.real(y) + params["bias"]


def loss_distributed(params, x, target, mesh, **kw) -> Array:
    y = apply_distributed(params, x, mesh, **kw)
    return jnp.mean((y - target) ** 2)


def train_step_distributed(
    params: Params, x: Array, target: Array, mesh: Mesh, lr: float = 1e-2, **kw
) -> Tuple[Params, Array]:
    """One SGD step of the sharded spectral filter.  Gradients flow through
    the all-to-alls (their transpose is the reverse all-to-all); param grads
    are summed across the mesh by jit's partitioner automatically."""
    loss, grads = jax.value_and_grad(loss_distributed)(params, x, target, mesh, **kw)
    params = jax.tree_util.tree_map(lambda p, g: p - lr * g, params, grads)
    return params, loss
