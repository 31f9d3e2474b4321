"""Twiddle / chirp precomputation (L1 of the reference), host-side, fp64.

Replaces the reference's `twiddle`/`longvectorN` (src/highSpeedFFT.c:2186-2313)
and the static radix tables (src/highSpeedFFT.c:57-116).  The reference's table
path is verifiably wrong (off-by-one table indexing, j-independent values —
SURVEY.md §2.2(3)(4)); here every twiddle uses the *correct* dynamic formula
e^(sign·2πi·j·k/N), evaluated with an exact integer reduction of the phase
index (j·k mod N as Python/NumPy integers, never floats) so fp64 cos/sin see a
small argument.  This is what keeps fp32 transforms at ~1e-7 relative error
even at N = 65536.

Everything here returns NumPy arrays: these are plan-time constants that get
embedded into the jaxpr (or donated as plan pytree leaves); they are computed
once per (N, sign) plan and cached.
"""

from __future__ import annotations

import functools
import os

import numpy as np


@functools.lru_cache(maxsize=1)
def _native():
    """The native generator (native/planner.cpp) when built, else None.
    Bit-identical to the Python path (both use exact integer phase reduction
    then libm cos/sin); the test suite asserts parity."""
    if os.environ.get("SPECTRAL_NO_NATIVE"):
        return None
    from . import native

    return native if native.available() else None


def _planes(angles: np.ndarray, dtype) -> tuple[np.ndarray, np.ndarray]:
    return np.cos(angles).astype(dtype), np.sin(angles).astype(dtype)


def _cast(pair, dtype) -> tuple[np.ndarray, np.ndarray]:
    re, im = pair
    return re.astype(dtype), im.astype(dtype)


def dft_matrix(n: int, sign: int, dtype=np.float32) -> tuple[np.ndarray, np.ndarray]:
    """Dense n×n DFT matrix W[j,k] = e^(sign·2πi·j·k/n) as (real, imag) planes.

    Replacement for the reference's unrolled leaf butterflies and its
    O(r²) general-radix combine (src/highSpeedFFT.c:333-713, 1475-1628): a small dense DFT is a
    single matmul.
    """
    nat = _native()
    if nat is not None:
        return _cast(nat.dft_matrix(n, sign), dtype)
    k = np.arange(n, dtype=np.int64)
    phase = (np.outer(k, k) % n).astype(np.float64)
    angles = (sign * 2.0 * np.pi / n) * phase
    return _planes(angles, dtype)


def twiddle_split(
    n1: int, n2: int, big_n: int, sign: int, dtype=np.float32
) -> tuple[np.ndarray, np.ndarray]:
    """Inter-stage twiddles T[j1, k2] = e^(sign·2πi·j1·k2/N) of shape (n1, n2).

    The correct generalization of the reference's `longvectorN` dynamic path
    (src/highSpeedFFT.c:2275-2288), laid out as the 2-D array the Cooley-Tukey
    split actually consumes rather than the flat telescoped vector.
    """
    nat = _native()
    if nat is not None and big_n == n1 * n2:
        return _cast(nat.split_twiddles(n1, n2, sign), dtype)
    j1 = np.arange(n1, dtype=np.int64)
    k2 = np.arange(n2, dtype=np.int64)
    phase = (np.outer(j1, k2) % big_n).astype(np.float64)
    angles = (sign * 2.0 * np.pi / big_n) * phase
    return _planes(angles, dtype)


def split_twiddles(n: int, sign: int, dtype=np.float32) -> tuple[np.ndarray, np.ndarray]:
    """Half-spectrum split twiddles e^(sign·2πi·k/N), k = 0..N/2, for the packed
    real FFT (reference: src/real.c:56-61, which bakes +sin for both directions
    and hides direction in the inner plan; here the sign is explicit)."""
    nat = _native()
    if nat is not None:
        return _cast(nat.real_split_twiddles(n, sign), dtype)
    k = np.arange(n // 2 + 1, dtype=np.int64)
    angles = (sign * 2.0 * np.pi / n) * k.astype(np.float64)
    return _planes(angles, dtype)


def chirp(n: int, sign: int, dtype=np.float32) -> tuple[np.ndarray, np.ndarray]:
    """Bluestein chirp w[j] = e^(sign·iπ·j²/n), j = 0..n-1, as (re, im) planes.

    Uses the exact quadratic residue j² mod 2n (integer arithmetic — the vector
    analogue of the reference's incremental `l2 += 2i+1 (mod 2N)` trick,
    src/highSpeedFFT.c:1674-1690) so the phase argument stays in [0, 2π) and
    fp64 cos/sin lose no accuracy even for n ~ 10⁵.
    """
    nat = _native()
    if nat is not None:
        return _cast(nat.chirp(n, n, sign), dtype)
    j = np.arange(n, dtype=np.int64)
    phase = ((j * j) % (2 * n)).astype(np.float64)
    angles = (sign * np.pi / n) * phase
    return _planes(angles, dtype)
