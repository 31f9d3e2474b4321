"""Runtime configuration for the spectral library.

The reference's only knobs are compile-time macros (`USE_TWIDDLE_TABLES`,
`LOOKUP_MAX`, `fft_type` — src/highSpeedFFT.c:9,12, src/highspeedFFT.h:15-17).
Here configuration is a small dataclass resolved at plan/trace time.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class SpectralConfig:
    # Every default below is inherited from the library's first target (a
    # different accelerator) and has NOT been measured on the H100; PERF.md
    # holds what has been.
    #
    # Largest dense DFT stage the mixed-radix engine will emit.  Each stage is
    # one matmul of this size; primes above it route the length to
    # Bluestein.  256 lets lengths up to 65536 run as two balanced stages
    # ((256,256) for 65536) with contraction dims <= 256.
    max_stage: int = 256
    # Lengths <= this are done as one dense DFT matmul (single-stage plan).
    direct_dft_max: int = 64
    # Stage grouping: "balanced" (fewest stages, then LPT-equal sizes) or
    # "greedy" (descending-prime packing, matches the native planner).
    stage_strategy: str = "balanced"
    # Working dtype of the (re, im) planes on device.
    dtype: jnp.dtype = jnp.float32
    # Matmul precision for the stage DFTs.  HIGHEST (fp32 products; on a GPU
    # fp32 outside the tensor cores) is what the 1e-5 error budget
    # (NUMERICS.md) is stated for; cheaper precisions ("high", "default")
    # trade accuracy for speed per workload.  A tuple of strings gives
    # per-stage precisions (stage i of the plan uses
    # precision[min(i, len-1)]) for mixed schemes such as ("highest",
    # "high") — see tools/tune.py prec for the measurement harness.
    precision: "jax.lax.Precision | str | tuple" = jax.lax.Precision.HIGHEST
    # Padded-length selector for Bluestein / convolution: "pow23" picks the
    # smallest 2^a or 3·2^a (e.g. m=24576 instead of 32768 at N=10007, same
    # ~1e-7 accuracy); "pow2" mirrors the reference (src/convolve.c:20-25);
    # "fast" is 2·3·5·7-smooth.
    pad_mode: str = "pow23"
    # Rader's algorithm for prime lengths whose n−1 is max_stage-smooth:
    # "auto" converts the prime DFT into ONE length-(n−1) cyclic
    # convolution — two smooth inner FFTs of n−1 points instead of
    # Bluestein's two FFTs of m ≈ 2.4n chirp-padded points, at the cost of
    # two permutation gathers.  Default "off" (Bluestein); "auto" is the
    # opt-in lever and the plan type keeps its oracle tests.  Primes whose
    # n−1 is NOT smooth (e.g. 10007 = 2·5003 + 1) take Bluestein either way.
    rader: str = "off"
    # Small trailing DFT stages as elementwise butterflies instead of dense
    # matmuls: at f <= 4 every DFT entry is ±1/±i (no real multiplies at
    # all; ×i is a plane swap), f = 8 adds two scalar-√½ twiddles, f = 16
    # is two radix-8 halves + a cos/sin(π/8) constant-twiddle combine (~11
    # ops/point vs a depth-32 stacked matmul).  Stages keep descending
    # order, so butterflies apply where the small factors already sit.
    # "auto" (default) = butterfly stages of size 2/4/8/16; "8" = cap at
    # 8; "16" = synonym of auto; "off" = always matmul.
    butterfly: str = "auto"


    @property
    def op_precision(self):
        """``precision`` resolved to a value every ``jnp.einsum`` accepts.

        The engine-only schemes — per-stage tuples and the "split6" fused
        form — are meaningful only inside the stage-matmul engine
        (ops/stockham.py, via the plan); every other op resolves them here
        to plain HIGHEST (their accuracy-equivalent).  Without this, a
        tuple would be silently reinterpreted by einsum as JAX per-operand
        (lhs, rhs) precision and "split6" would raise deep inside jax."""
        p = self.precision
        if isinstance(p, (tuple, list)) or (
            isinstance(p, str) and p.lower() == "split6"
        ):
            return "highest"
        return p

    def __post_init__(self):
        if self.pad_mode not in ("pow2", "pow23", "fast"):
            raise ValueError(
                f"pad_mode must be 'pow2', 'pow23' or 'fast', got {self.pad_mode!r}"
            )
        if self.rader not in ("auto", "off"):
            raise ValueError(
                f"rader must be 'auto' or 'off', got {self.rader!r}"
            )
        if self.butterfly not in ("auto", "off", "8", "16"):
            raise ValueError(
                f"butterfly must be 'auto', 'off', '8' or '16', got "
                f"{self.butterfly!r}"
            )
        if self.stage_strategy not in ("balanced", "greedy"):
            raise ValueError(
                f"stage_strategy must be 'balanced' or 'greedy', "
                f"got {self.stage_strategy!r}"
            )
        if self.max_stage < 2:
            raise ValueError(f"max_stage must be >= 2, got {self.max_stage}")
        if self.direct_dft_max < 1:
            raise ValueError(
                f"direct_dft_max must be >= 1, got {self.direct_dft_max}"
            )


DEFAULT_CONFIG = SpectralConfig()
