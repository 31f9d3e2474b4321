"""Parallel-in-time Kalman filtering and RTS smoothing.

The textbook Kalman filter is a sequential recurrence over time — serial
depth T.  Särkkä & García-Fernández (2021, "Temporal parallelization of
Bayesian smoothers") showed the Bayesian filtering/smoothing recursions are
compositions of an ASSOCIATIVE operator on small per-step elements, so the
whole pass runs as a `lax.associative_scan` — log₂(T) depth of batched
(T, d, d) matrix products, the same trick this library already uses for IIR
filtering (ops/iir._recurrence_scan) and LTI simulation (ops/ltisys).  On a
d=4 state that turns a length-65536 filter from 65536 dependent steps into
17 rounds of matmul-batched 4×4 algebra.

Filtering elements (A, b, C, η, J) represent the map from the previous
filtered density to the current one; smoothing elements (E, g, L) compose
in reverse.  Time-invariant (F, Q, H, R) models; per-step inverses are
d_obs-sized solves.  `kalman_filter(..., parallel=False)` runs the
sequential `lax.scan` form — the two paths oracle-test each other.

Capability extension (the LTI estimation counterpart of ops/ltisys's
simulation); no analogue in the reference.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.config import DEFAULT_CONFIG, SpectralConfig

Array = jax.Array

__all__ = ["kalman_filter", "kalman_smoother"]


def _as_f32(*mats):
    return tuple(jnp.asarray(m).astype(jnp.float32) for m in mats)


def _filter_elements(F, Q, H, R, m0, P0, ys):
    """Per-step associative filtering elements (A, b, C, eta, J)."""
    d = F.shape[0]
    I = jnp.eye(d, dtype=F.dtype)
    S_generic = H @ Q @ H.T + R                       # innovation cov, k >= 2
    K_generic = jnp.linalg.solve(S_generic, H @ Q).T  # Q Hᵀ S⁻¹
    ImKH = I - K_generic @ H
    HtSinv = jnp.linalg.solve(S_generic, H).T         # Hᵀ S⁻¹

    def generic(y):
        A = ImKH @ F
        b = K_generic @ y
        C = ImKH @ Q
        eta = F.T @ HtSinv @ y
        J = F.T @ HtSinv @ H @ F
        return A, b, C, eta, J

    A_g, b_g, C_g, eta_g, J_g = jax.vmap(generic)(ys)

    # first element folds in the prior exactly
    m_pred = F @ m0
    P_pred = F @ P0 @ F.T + Q
    S1 = H @ P_pred @ H.T + R
    K1 = jnp.linalg.solve(S1, H @ P_pred).T
    b1 = m_pred + K1 @ (ys[0] - H @ m_pred)
    C1 = (I - K1 @ H) @ P_pred
    A = A_g.at[0].set(jnp.zeros_like(F))
    b = b_g.at[0].set(b1)
    C = C_g.at[0].set(C1)
    return A, b, C, eta_g, J_g


def _mv(M: Array, v: Array) -> Array:
    """Batched matrix-vector product for (..., d, d) @ (..., d)."""
    return (M @ v[..., None])[..., 0]


def _filter_combine(left, right):
    """Särkkä & García-Fernández eq. (10)-(11): composition of filtering
    elements (associative)."""
    A1, b1, C1, eta1, J1 = left
    A2, b2, C2, eta2, J2 = right
    d = A1.shape[-1]
    I = jnp.eye(d, dtype=A1.dtype)
    # (I + C1 J2)⁻¹ applied from the right of A2 / left of (b1 + C1 η2)
    M = I + C1 @ J2
    A2M = A2 @ jnp.linalg.solve(M, jnp.broadcast_to(I, M.shape))
    A = A2M @ A1
    b = _mv(A2M, b1 + _mv(C1, eta2)) + b2
    C = A2M @ C1 @ jnp.swapaxes(A2, -1, -2) + C2
    Mt = I + J2 @ C1
    A1tM = jnp.swapaxes(A1, -1, -2) @ jnp.linalg.solve(
        Mt, jnp.broadcast_to(I, Mt.shape))
    eta = _mv(A1tM, eta2 - _mv(J2, b1)) + eta1
    J = A1tM @ J2 @ A1 + J1
    return A, b, C, eta, J


def kalman_filter(F, Q, H, R, m0, P0, ys, *, parallel: bool = False,
                  config: SpectralConfig = DEFAULT_CONFIG
                  ) -> Tuple[Array, Array]:
    """Kalman filter for x_{k+1} = F x_k + w (cov Q), y_k = H x_k + v
    (cov R), prior N(m0, P0), observations ``ys`` of shape (T, d_obs).

    Returns (means (T, d), covs (T, d, d)) of the filtered densities.
    ``parallel=True`` runs the log-depth associative scan; ``False``
    (default) the sequential `lax.scan` (identical results — fp32 to
    ~1e-5).  At small state dimension (d=4) the sequential scan's tiny
    per-step products beat the associative form's ~2·log2(T) full-array
    combine passes on one device (an inherited default, not measured on
    the H100).  The associative form is the
    MULTI-DEVICE lever — `parallel.kalman_filter_sharded` shards the time
    axis and passes parallel=True, where log-depth spans chips — and the
    single-device choice for much larger state dimensions (bigger per-step
    matrix work shifts the balance; re-measure via bench_kalman)."""
    F, Q, H, R, m0, P0 = _as_f32(F, Q, H, R, m0, P0)
    ys = jnp.asarray(ys).astype(jnp.float32)  # tracer-safe cast
    if ys.ndim != 2 or ys.shape[0] < 1:
        raise ValueError("ys must be (T >= 1, d_obs)")
    d = F.shape[0]
    if F.shape != (d, d) or Q.shape != (d, d) or P0.shape != (d, d):
        raise ValueError("F, Q, P0 must all be (d, d)")
    if H.shape[1] != d or R.shape != (H.shape[0], H.shape[0]):
        raise ValueError("H must be (d_obs, d) and R (d_obs, d_obs)")
    if ys.shape[1] != H.shape[0]:
        raise ValueError(f"ys.shape[1]={ys.shape[1]} must equal "
                         f"d_obs={H.shape[0]}")
    # HIGHEST matmul precision throughout: default precision may lower the
    # 4x4-class products to reduced-precision operand passes (bf16, or TF32
    # on GPU tensor cores) whose ~1e-3 error COMPOUNDS
    # — over log2(T) combine levels in the parallel form and over T serial
    # steps in the scan (same hazard class as iir._recurrence_scan).
    with jax.default_matmul_precision("highest"):
        if parallel:
            elems = _filter_elements(F, Q, H, R, m0, P0, ys)
            _, b, C, _, _ = jax.lax.associative_scan(_filter_combine, elems)
            return b, C

        def step(carry, y):
            m, P = carry
            m_pred = F @ m
            P_pred = F @ P @ F.T + Q
            S = H @ P_pred @ H.T + R
            K = jnp.linalg.solve(S, H @ P_pred).T
            m_new = m_pred + K @ (y - H @ m_pred)
            P_new = (jnp.eye(d, dtype=F.dtype) - K @ H) @ P_pred
            return (m_new, P_new), (m_new, P_new)

        (_, _), (ms, Ps) = jax.lax.scan(step, (m0, P0), ys)
        return ms, Ps


def _smoother_elements(F, Q, ms, Ps):
    """Per-step associative smoothing elements (E, g, L)."""
    def generic(m, P):
        P_pred = F @ P @ F.T + Q
        E = jnp.linalg.solve(P_pred.T, F @ P.T).T   # P Fᵀ P_pred⁻¹
        g = m - E @ (F @ m)
        L = P - E @ P_pred @ E.T
        return E, g, L

    E, g, L = jax.vmap(generic)(ms, Ps)
    # last element carries the filtered terminal density
    E = E.at[-1].set(jnp.zeros_like(F))
    g = g.at[-1].set(ms[-1])
    L = L.at[-1].set(Ps[-1])
    return E, g, L


def _smoother_combine(right, left):
    """Reverse-direction composition (associative): applying ``left``'s
    gain to ``right``'s already-combined tail."""
    E2, g2, L2 = right
    E1, g1, L1 = left
    E = E1 @ E2
    g = _mv(E1, g2) + g1
    L = E1 @ L2 @ jnp.swapaxes(E1, -1, -2) + L1
    return E, g, L


def kalman_smoother(F, Q, H, R, m0, P0, ys, *, parallel: bool = False,
                    config: SpectralConfig = DEFAULT_CONFIG
                    ) -> Tuple[Array, Array]:
    """Rauch-Tung-Striebel smoother: the full-information posterior at every
    step.  Runs the (parallel or sequential) Kalman filter, then composes
    the smoothing gains with a second log-depth associative scan in
    reverse.  Returns (means (T, d), covs (T, d, d))."""
    ms, Ps = kalman_filter(F, Q, H, R, m0, P0, ys, parallel=parallel,
                           config=config)
    F32, Q32 = _as_f32(F, Q)
    # HIGHEST for the same compounding reason as kalman_filter
    with jax.default_matmul_precision("highest"):
        elems = _smoother_elements(F32, Q32, ms, Ps)
        if parallel:
            _, g, L = jax.lax.associative_scan(_smoother_combine, elems,
                                               reverse=True)
            return g, L

        def step(carry, elem):
            m_next, P_next = carry
            E, g, L = elem
            m = E @ m_next + g
            P = E @ P_next @ E.T + L
            return (m, P), (m, P)

        E, g, L = elems
        init = (g[-1], L[-1])
        (_, _), (gs, Ls) = jax.lax.scan(
            step, init, (E[:-1], g[:-1], L[:-1]), reverse=True)
        gs = jnp.concatenate([gs, g[-1][None]], axis=0)
        Ls = jnp.concatenate([Ls, L[-1][None]], axis=0)
        return gs, Ls
