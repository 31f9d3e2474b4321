"""Spectral PDE toolbox demo: heat, Burgers, and Poisson on the engine.

Three classic pseudo-spectral workloads, each validated against an analytic
or fp64 result — the PDE-side counterpart of examples/demo.py (the reference
ships no PDE tooling; its demo only FFTs sine waves, src/real.c:269-482):

1. 2-D periodic heat equation, exact integrating-factor step in Fourier
   space (error vs the closed-form mode decay).
2. 1-D viscous Burgers via spectral derivatives + RK4 (conservation and
   fp64-oracle checks).
3. 2-D Poisson solve (residual check via spectral Laplacian).

Run: python examples/pde_spectral.py
"""

import os
import sys

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import mixed_radix_fast_fourier_transform_tpu as sp  # noqa: E402


def heat_2d():
    """u_t = nu * lap(u) on [0, 2pi)^2: spectral step is exact per mode."""
    n, nu, t = 128, 0.05, 0.7
    xs = np.linspace(0, 2 * np.pi, n, endpoint=False)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    u0 = np.sin(3 * X) * np.cos(5 * Y) + 0.5 * np.cos(X + 2 * Y)
    u0 = u0.astype(np.float32)

    kx = np.fft.fftfreq(n, 1.0 / n)
    k2 = kx[:, None] ** 2 + kx[None, :] ** 2  # full-grid |k|^2
    decay_full = np.exp(-nu * k2 * t)

    @jax.jit
    def step(u):
        spec = sp.fft2(u.astype(jnp.complex64))
        spec = spec * jnp.asarray(decay_full, jnp.float32)
        return jnp.real(sp.ifft2(spec))

    u = np.asarray(step(jnp.asarray(u0)))
    # analytic: each initial mode decays by exp(-nu |k|^2 t)
    want = (
        np.exp(-nu * (9 + 25) * t) * np.sin(3 * X) * np.cos(5 * Y)
        + 0.5 * np.exp(-nu * (1 + 4) * t) * np.cos(X + 2 * Y)
    )
    err = np.max(np.abs(u - want)) / np.max(np.abs(want))
    print(f"heat 2-D (n={n}): rel err vs analytic decay {err:.2e}")
    assert err < 1e-5
    return err


def burgers_1d():
    """u_t + u u_x = nu u_xx, periodic, pseudo-spectral RK4."""
    n, nu, dt, steps = 256, 0.02, 1e-3, 400
    xs = np.linspace(0, 2 * np.pi, n, endpoint=False)
    u0 = (np.sin(xs) + 0.5 * np.sin(3 * xs)).astype(np.float32)

    def rhs(u):
        ux = sp.spectral_diff(u, order=1)
        uxx = sp.spectral_diff(u, order=2)
        return -u * ux + nu * uxx

    @jax.jit
    def rk4(u):
        k1 = rhs(u)
        k2 = rhs(u + 0.5 * dt * k1)
        k3 = rhs(u + 0.5 * dt * k2)
        k4 = rhs(u + dt * k3)
        return u + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)

    u = jnp.asarray(u0)
    for _ in range(steps):
        u = rk4(u)
    u = np.asarray(u)

    # fp64 numpy oracle of the same scheme
    def rhs64(v):
        k = np.fft.fftfreq(n, 1.0 / n)
        vh = np.fft.fft(v)
        vx = np.real(np.fft.ifft(1j * k * vh))
        vxx = np.real(np.fft.ifft(-(k ** 2) * vh))
        return -v * vx + nu * vxx

    v = u0.astype(np.float64)
    for _ in range(steps):
        k1 = rhs64(v); k2 = rhs64(v + 0.5 * dt * k1)
        k3 = rhs64(v + 0.5 * dt * k2); k4 = rhs64(v + dt * k3)
        v = v + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)

    err = np.max(np.abs(u - v)) / np.max(np.abs(v))
    # momentum is conserved up to viscosity (mean(u) stays 0)
    drift = abs(float(np.mean(u)))
    print(f"burgers 1-D (n={n}, {steps} RK4 steps): rel err vs fp64 oracle "
          f"{err:.2e}, mean drift {drift:.2e}")
    assert err < 1e-3 and drift < 1e-5
    return err


def poisson_2d():
    """lap(u) = f, periodic: solve then verify the residual spectrally."""
    n = 192  # mixed radix (2^6 * 3)
    xs = np.linspace(0, 2 * np.pi, n, endpoint=False)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    f = (np.sin(2 * X) * np.sin(Y) - 0.3 * np.cos(4 * X + 3 * Y)).astype(np.float32)

    u = np.asarray(sp.poisson_solve(jnp.asarray(f)))

    # fp64 oracle solution
    k = np.fft.fftfreq(n, 1.0 / n)
    k2 = k[:, None] ** 2 + k[None, :] ** 2
    inv = np.where(k2 > 0, -1.0 / np.where(k2 > 0, k2, 1.0), 0.0)
    want = np.real(np.fft.ifft2(np.fft.fft2(f.astype(np.float64)) * inv))
    err = np.max(np.abs(u - want)) / np.max(np.abs(want))

    # residual check is ill-conditioned in fp32 (re-amplified by k_max^2),
    # so it only gets a loose bound
    ud = jnp.asarray(u)
    lap = sp.spectral_diff(ud, order=2, axis=0) + sp.spectral_diff(ud, order=2, axis=1)
    res = float(jnp.max(jnp.abs(lap - jnp.asarray(f)))) / float(np.max(np.abs(f)))
    print(f"poisson 2-D (n={n}): rel err vs fp64 oracle {err:.2e}, "
          f"fp32 residual {res:.2e}")
    assert err < 1e-5 and res < 1e-2
    return err


if __name__ == "__main__":
    heat_2d()
    burgers_1d()
    poisson_2d()
    print("PDE spectral demo: ALL OK")
