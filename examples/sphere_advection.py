"""Spectral advection on the sphere: transport a tracer with the SHT ops.

A passive tracer q is advected by a solid-body rotation wind
(u_phi = sin(theta)·omega, u_theta = 0); the exact solution is the initial
field rotated in longitude, so the error after any time is measurable
exactly.  The right-hand side -u·∇q uses :func:`sphere_grad`, time stepping
is classic RK4, and everything jits into one compiled step — the skeleton
of a spherical dynamical core on this library's transforms.

Run: python examples/sphere_advection.py
"""

import os
import sys

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import mixed_radix_fast_fourier_transform_tpu as sp  # noqa: E402


def main():
    lmax = 31
    L = lmax + 1
    theta, phi, _ = sp.sht_grid(lmax)
    TH, PH = theta[:, None], phi[None, :]

    # smooth band-limited blob centred on the equator
    q0 = np.exp(
        -((TH - np.pi / 2) ** 2 + (PH - np.pi) ** 2) / 0.18
    ).astype(np.float32)
    # project onto the band limit so "exact rotation" stays in-band
    q0 = np.real(np.asarray(sp.isht(np.asarray(sp.sht(q0)))))

    omega = 1.0  # solid-body angular velocity about the pole
    sin_th = jnp.asarray(np.sin(theta).astype(np.float32))[:, None]

    def rhs(q):
        # u·∇q with u_phi = omega·sin(theta) (solid body), u_theta = 0;
        # sphere_grad's phi component already carries the 1/sin factor, so
        # -u_phi·(∇q)_phi = -omega·sin(theta)·(1/sin)·dq/dphi = -omega·dq/dphi
        _, gphi = sp.sphere_grad(q)
        return -omega * sin_th * gphi

    @jax.jit
    def rk4(q, dt):
        k1 = rhs(q)
        k2 = rhs(q + 0.5 * dt * k1)
        k3 = rhs(q + 0.5 * dt * k2)
        k4 = rhs(q + dt * k3)
        return q + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)

    steps, dt = 160, 2.0 * np.pi / (8 * 160)  # one-eighth revolution
    q = jnp.asarray(q0)
    for _ in range(steps):
        q = rk4(q, dt)
    # exact: rotate by omega*T = 2pi/8 = one-eighth of the longitudes
    shift = (2 * L) // 8
    exact = np.roll(q0, shift, axis=-1)
    err = np.max(np.abs(np.asarray(q) - exact)) / np.max(np.abs(exact))
    print(f"spectral advection on the sphere (lmax={lmax}, RK4 x{steps}):")
    print(f"  rel err vs exact rotation: {err:.3e}")
    print("  (spectral in space — the error is the RK4 time truncation)")


if __name__ == "__main__":
    main()
