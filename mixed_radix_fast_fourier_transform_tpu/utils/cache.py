"""Compilation & plan persistence (the checkpoint/resume analogue).

The reference's only persistent artifact is its in-memory plan (SURVEY.md §5
"checkpoint/resume: none").  On an accelerator the expensive artifact is
the *compiled executable* (first compile of a big transform takes seconds
to minutes), so the equivalent here is:

* :func:`enable_persistent_cache` — turn on JAX's on-disk compilation cache
  so every plan shape compiles once per cache directory, not once per
  process.  The directory is ``$JAX_COMPILATION_CACHE_DIR`` when that is
  set, else the fixed ``<repo>/.jax_cache`` (:func:`compile_cache_dir`);
* :func:`save_plans` / :func:`load_plans` — persist the plan *manifest*
  (which (kind, n, sign) plans a workload used) so a fresh process can
  rebuild exactly that working set up front; plan constants are
  deterministic, so rebuilding equals deserializing without the version-skew
  risk of pickling dataclasses.
"""

from __future__ import annotations

import os
from typing import Iterable, Optional, Tuple

import jax
import numpy as np

from ..plan import _CACHE, _CACHE_LOCK, get_plan
from .config import DEFAULT_CONFIG, SpectralConfig

# Fixed path inside the checkout (listed in .gitignore): a cache directory
# that moves between runs never hits.
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def compile_cache_dir() -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` when set, else ``<repo>/.jax_cache``."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or REPO_CACHE_DIR


def enable_persistent_cache(path: Optional[str] = None) -> str:
    """Enable JAX's persistent compilation cache (idempotent) in ``path``,
    default :func:`compile_cache_dir`."""
    path = path or compile_cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path


def warm_plans(
    lengths: Iterable[int],
    *,
    signs: Tuple[int, ...] = (-1, 1),
    kinds: Tuple[str, ...] = ("complex",),
    config: SpectralConfig = DEFAULT_CONFIG,
) -> int:
    """Eagerly build plans for the given lengths; returns how many were built."""
    count = 0
    for n in lengths:
        for kind in kinds:
            for sign in signs:
                if kind == "real" and n % 2:
                    continue
                get_plan(n, sign, kind, config)
                count += 1
    return count


def save_plans(path: str) -> int:
    """Write the manifest of every cached plan to ``path`` (.npz).
    Returns plan count."""
    with _CACHE_LOCK:
        keys = list(_CACHE.keys())
    rows = np.asarray(
        [[{"complex": 0, "real": 1}[kind], n, sign] for kind, n, sign, _ in keys],
        dtype=np.int64,
    ).reshape(-1, 3)
    np.savez_compressed(path, manifest=rows)
    return len(keys)


def load_plans(path: str, *, config: SpectralConfig = DEFAULT_CONFIG) -> int:
    """Rebuild every plan in a manifest saved by :func:`save_plans` into the
    live cache.  Returns plan count loaded.

    Fails CLEANLY on a corrupt or foreign file: a missing path raises
    ``FileNotFoundError``; anything unreadable or structurally wrong raises
    ``ValueError`` naming the path, and the live cache is untouched (plans
    are only built after the whole manifest validates)."""
    try:
        with np.load(path) as z:
            rows = np.asarray(z["manifest"])
    except FileNotFoundError:
        raise
    except Exception as e:
        raise ValueError(f"corrupt plan manifest {path!r}: {e}") from e
    kinds = {0: "complex", 1: "real"}
    if rows.ndim != 2 or (rows.size and rows.shape[1] != 3):
        raise ValueError(
            f"corrupt plan manifest {path!r}: expected (k, 3) rows, "
            f"got shape {rows.shape}"
        )
    bad = [int(k) for k in np.unique(rows[:, 0]) if int(k) not in kinds]
    if bad or (rows.size and int(rows[:, 1].min()) < 1):
        raise ValueError(
            f"corrupt plan manifest {path!r}: invalid kind ids {bad} "
            f"or non-positive lengths"
        )
    if rows.size:
        bad_sign = [int(s) for s in np.unique(rows[:, 2]) if int(s) not in (-1, 1)]
        if bad_sign:
            raise ValueError(
                f"corrupt plan manifest {path!r}: invalid signs {bad_sign}"
            )
        odd_real = rows[(rows[:, 0] == 1) & (rows[:, 1] % 2 == 1)]
        if len(odd_real):
            raise ValueError(
                f"corrupt plan manifest {path!r}: odd lengths for real-kind "
                f"plans {sorted(set(int(n) for n in odd_real[:, 1]))}"
            )
    for kind_id, n, sign in rows:
        get_plan(int(n), int(sign), kinds[int(kind_id)], config)
    return len(rows)
