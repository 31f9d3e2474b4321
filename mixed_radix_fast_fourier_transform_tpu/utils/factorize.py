"""Number theory & planning layer (L0 of the reference).

Reimplementation of the reference's factorability check and prime
factorization planner (reference: `src/highSpeedFFT.c:11-55` `dividebyN` lookup,
`1954-2025` `divideby`/`dividebyN`, `2038-2163` `factors`).  Unlike the reference,
whose prime set omits 19 from the lookup (`src/highSpeedFFT.c:12-55`) while
`factors()` handles it, this planner factorizes over *all* primes and lets the
plan layer decide (by largest prime factor) whether a length goes to the
mixed-radix engine or to Bluestein.  All of this runs at trace/plan time on the
host; nothing here touches the device.
"""

from __future__ import annotations

import functools
import math
import os
from typing import List, Sequence, Tuple


@functools.lru_cache(maxsize=1)
def _use_native() -> bool:
    """Native planner opt-out: set SPECTRAL_NO_NATIVE=1 to force pure Python."""
    if os.environ.get("SPECTRAL_NO_NATIVE"):
        return False
    from . import native

    return native.available()

# Prime set the reference's planner can divide by (src/highSpeedFFT.c:2046-2160
# handles {53..13, 11, 8, 7, 5, 4, 3, 2} plus a 6k±1 wheel for residuals <= 31²).
# We keep it only for the compat `dividebyN` predicate.
REFERENCE_PRIME_SET: Tuple[int, ...] = (
    2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53,
)


def prime_factors(n: int) -> List[int]:
    """Full prime factorization (ascending), trial division with a 6k±1 wheel.

    Replaces the reference's `factors()` (src/highSpeedFFT.c:2038-2163) but is
    exact for every n >= 1 (the reference caps the factor list at 64 entries and
    prefers composite radices 8/4; radix grouping happens later in
    :func:`plan_stages` here).  Uses the native C++ planner (native/planner.cpp)
    when built; this Python path is the fallback and the parity oracle.
    """
    if n < 1:
        raise ValueError(f"length must be >= 1, got {n}")
    if _use_native():
        from . import native

        got = native.prime_factors(n)
        if got is not None:
            return got
    out: List[int] = []
    for p in (2, 3):
        while n % p == 0:
            out.append(p)
            n //= p
    f = 5
    while f * f <= n:
        for p in (f, f + 2):
            while n % p == 0:
                out.append(p)
                n //= p
        f += 6
    if n > 1:
        out.append(n)
    return out


def largest_prime_factor(n: int) -> int:
    if n == 1:
        return 1
    return prime_factors(n)[-1]


@functools.lru_cache(maxsize=4096)
def dividebyN(n: int, primes: Tuple[int, ...] = REFERENCE_PRIME_SET) -> bool:
    """Compat predicate: is ``n`` smooth over ``primes``?

    Mirrors the reference's `dividebyN` (src/highSpeedFFT.c:1979-2025) but with
    a complete prime set (the reference's lookup omits 19, mis-routing N=19k to
    Bluestein) and no 1024-entry table cap.
    """
    if n < 1:
        return False
    for p in primes:
        while n % p == 0:
            n //= p
    return n == 1


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (reference `next_power_of_two`,
    src/convolve.c:20-25 — which is log10-based and disagrees with execution for
    N = 2^k + 1; this version is exact)."""
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def next_fast_len(n: int, primes: Sequence[int] = (2, 3, 5, 7)) -> int:
    """Smallest ``m >= n`` whose prime factors are all in ``primes``.

    Used to pick efficient padded lengths for convolution / Bluestein instead
    of always rounding to a power of two like the reference (src/convolve.c:39-55).
    """
    if n <= 1:
        return 1
    if primes == (2, 3, 5, 7) and _use_native():
        from . import native

        got = native.next_fast_len(n)
        if got is not None:
            return got
    best = next_pow2(n)

    def smooth(m: int) -> bool:
        for p in primes:
            while m % p == 0:
                m //= p
        return m == 1

    m = n
    while m < best:
        if smooth(m):
            return m
        m += 1
    return best


def prev_fast_len(n: int, primes: Sequence[int] = (2, 3, 5, 7)) -> int:
    """Largest ``m <= n`` whose prime factors are all in ``primes``
    (scipy.fft.prev_fast_len parity) — the truncation-side counterpart of
    :func:`next_fast_len` for workloads that shorten instead of pad."""
    if n < 1:
        raise ValueError(f"length must be >= 1, got {n}")
    if primes == (2, 3, 5, 7) and _use_native():
        from . import native

        got = native.prev_fast_len(n)
        if got is not None:
            return got

    def smooth(m: int) -> bool:
        for p in primes:
            while m % p == 0:
                m //= p
        return m == 1

    m = n
    while not smooth(m):
        m -= 1
    return m


def plan_stages(
    n: int, max_stage: int = 64, strategy: str = "balanced"
) -> Tuple[int, ...]:
    """Group the prime factorization of ``n`` into DFT stage sizes <= max_stage.

    The engine executes one dense (stage x stage) DFT matmul per stage, so
    stage choice is a throughput knob — the moral equivalent of the
    reference preferring radices 8 and 4 over 2
    (src/highSpeedFFT.c:2046-2137), generalized:

    * ``balanced`` (default): **fewest stages, then most equal sizes** (LPT
      packing).  Each stage is a full pass over the data, so stage count
      dominates; among equal counts, sizes are balanced.
    * ``greedy``: pack descending primes toward max_stage (the native C++
      planner's algorithm, kept for parity tests and plan reproducibility).

    Returns stage sizes in descending order; their product is ``n``.
    Raises ValueError if some prime factor exceeds ``max_stage`` (callers route
    those lengths to Bluestein).
    """
    if n == 1:
        return (1,)
    if strategy == "greedy":
        if _use_native():
            from . import native

            got = native.plan_stages(n, max_stage)  # raises ValueError like below
            if got is not None:
                return got
        return _plan_stages_greedy(n, max_stage)
    if strategy != "balanced":
        raise ValueError(f"unknown stage strategy {strategy!r}")
    # The special cases below (N=1024, power-of-two 128-stages, the
    # non-pow2 window rule) are inherited rules tuned on the library's first
    # accelerator; none has been measured on the H100 (ROADMAP S5/D7).
    # Power-of-two lengths >= 2048 prefer 128-stages plus one remainder
    # (a remainder of 2 merges into one 256 stage); N=1024 runs (64,16) with
    # the radix-16 butterfly tail, gated at max_stage >= 128.
    if n == 1024 and max_stage >= 128:
        return (64, 16)
    if n >= 2048 and n & (n - 1) == 0 and max_stage >= 256:
        v = n.bit_length() - 1
        stages = []
        while v >= 7:
            stages.append(128)
            v -= 7
        if v == 1 and stages:
            stages[0] = 256
            v = 0
        if v:
            stages.append(1 << v)
        return tuple(sorted(stages, reverse=True))
    primes = sorted(prime_factors(n), reverse=True)
    if primes[0] > max_stage:
        raise ValueError(
            f"prime factor {primes[0]} of {n} exceeds max_stage={max_stage}"
        )
    # Window rule for two-stage non-pow2 lengths >= 3072: the largest
    # divisor in (96..128] leads the plan when its co-factor is <= 128
    # (e.g. 5040 -> (126,40)); other lengths fall through to LPT.
    if n >= 3072 and max_stage >= 256:
        for a in range(128, 96, -1):
            if n % a == 0 and n // a <= 128:
                return tuple(sorted((a, n // a), reverse=True))
    s = max(1, math.ceil(math.log(n) / math.log(max_stage)))
    while True:
        stages = _lpt_pack(primes, s, max_stage)
        if stages is not None:
            return stages
        s += 1


def _plan_stages_greedy(n: int, max_stage: int) -> Tuple[int, ...]:
    primes = sorted(prime_factors(n), reverse=True)
    if primes[0] > max_stage:
        raise ValueError(
            f"prime factor {primes[0]} of {n} exceeds max_stage={max_stage}"
        )
    stages: List[int] = []
    remaining = list(primes)
    while remaining:
        stage = remaining.pop(0)  # largest remaining prime
        # Greedily multiply in further primes while staying <= max_stage.
        i = 0
        while i < len(remaining):
            if stage * remaining[i] <= max_stage:
                stage *= remaining.pop(i)
            else:
                i += 1
        stages.append(stage)
    stages.sort(reverse=True)
    assert math.prod(stages) == n
    return tuple(stages)


def _lpt_pack(primes, s: int, max_stage: int):
    """Longest-processing-time packing of prime factors into ``s`` stages of
    product <= max_stage; None if this heuristic can't fit s stages."""
    groups = [1] * s
    for p in primes:  # descending
        groups.sort()
        for i in range(s):
            if groups[i] * p <= max_stage:
                groups[i] *= p
                break
        else:
            return None
    groups = [g for g in groups if g > 1] or [1]
    groups.sort(reverse=True)
    return tuple(groups)


def is_smooth(n: int, max_prime: int) -> bool:
    """True if every prime factor of n is <= max_prime."""
    return largest_prime_factor(n) <= max_prime


def is_prime(n: int) -> bool:
    """Deterministic primality (trial division — plan-time lengths only)."""
    return n >= 2 and prime_factors(n) == [n]


@functools.lru_cache(maxsize=256)
def primitive_root(p: int) -> int:
    """Smallest primitive root modulo prime ``p`` (the generator of the
    multiplicative group Rader's permutation rides on).  For FFT-class
    primes the smallest root is tiny (2..~20), so a linear search with the
    standard order test over the distinct prime factors of p−1 is instant."""
    if not is_prime(p):
        raise ValueError(f"primitive_root needs a prime, got {p}")
    if p == 2:
        return 1
    phi = p - 1
    qs = sorted(set(prime_factors(phi)))
    g = 2
    while True:
        if all(pow(g, phi // q, p) != 1 for q in qs):
            return g
        g += 1


def next_splittable_len(n: int, parts: int, max_stage: int = 256) -> int:
    """Smallest convenient m >= n that splits as m = n1·n2 with parts | n1,
    parts | n2 and both factors ``max_stage``-smooth — the padded-length
    contract of the distributed four-step (`parallel.distributed.choose_split`).

    Closed form rather than increment-and-retry: m = parts² · s with s the
    next 7-smooth integer >= ceil(n / parts²).  Any divisor pair (a, b) of s
    then yields n1 = parts·a, n2 = parts·b, both divisible by parts and smooth
    (7-smooth · smooth parts), so `choose_split(m, parts)` always succeeds.
    Each candidate test is O(log s) small-prime division, not the O(√m)
    factorization scan of the retry loop this replaces.
    """
    if parts < 1:
        raise ValueError(f"parts must be >= 1, got {parts}")
    if not is_smooth(parts, max_stage):
        raise ValueError(
            f"mesh size {parts} has a prime factor > max_stage={max_stage}"
        )
    if _use_native():
        from . import native

        got = native.next_splittable_len(n, parts, max_stage)
        if got is not None:
            return got
    pp = parts * parts
    s = next_fast_len(-(-n // pp))
    return pp * s
