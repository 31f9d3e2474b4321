"""Test configuration: an 8-virtual-device CPU platform BEFORE jax import.

Tests run on CPU (real fp32 matmuls, deterministic) with 8 virtual devices so
the distributed/sharding paths exercise real collectives without a GPU.
``JAX_PLATFORMS`` defaults to ``cpu``; tests marked ``gpu`` need the card and
run with ``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu`` (they skip on
any other platform).  The benchmark (bench.py) and chip_smoke.py run on the
GPU.
"""

import os
import sys

# Repo root on sys.path: `python -m pytest` prepends cwd, but a bare
# `pytest tests/` does not — and test_bench_line.py imports the top-level
# bench module (round-5 review finding).
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

from mixed_radix_fast_fourier_transform_tpu.utils.cache import (  # noqa: E402
    compile_cache_dir,
)

# Persistent compilation cache: XLA CPU compiles dominate the suite's wall
# time; cache them across runs ($JAX_COMPILATION_CACHE_DIR, else
# <repo>/.jax_cache).
jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

# The native .so is not checked in (reviewability: no opaque binaries in VCS).
# Build it here so the native-parity tests run on fresh clones; they skip
# cleanly if the toolchain is missing.
_repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_so = os.path.join(_repo, "native", "libspectral_native.so")
if not os.path.exists(_so):
    import subprocess
    import sys

    _build = subprocess.run(
        [sys.executable, os.path.join(_repo, "native", "build.py")],
        capture_output=True,
        check=False,
    )
    if _build.returncode != 0:
        # Don't hide a broken toolchain: native-parity tests would silently
        # skip and read as covered.
        sys.stderr.write(
            "WARNING: native/build.py failed (native-parity tests will "
            f"skip):\n{_build.stderr.decode(errors='replace')[-2000:]}\n"
        )


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test on any other platform.  Decided
    here, at run time, never at import or collection."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX platform is {dev.platform!r})")
    return dev


# ---------------------------------------------------------------------------
# Lane-budget gate:
# the default lane must stay fast enough to iterate on.  Two budgets:
#   - per test: any non-slow test whose call phase exceeds PER_TEST_BUDGET_S
#     is reported at session end;
#   - whole lane: a FULL default-lane run (>= LANE_GATE_MIN_TESTS collected)
#     exceeding LANE_BUDGET_S total wall time is reported — new breadth waves
#     must demote or merge an equal amount of test time.
# Both FAIL the session when SPECTRAL_TEST_BUDGET_STRICT=1 (on demand, so CI
# stays robust to a loaded box or a cold compile cache).
# ---------------------------------------------------------------------------
PER_TEST_BUDGET_S = 12.0
LANE_BUDGET_S = 21 * 60.0  # r4's measured full-lane wall time; frozen ceiling
LANE_GATE_MIN_TESTS = 1000  # partial runs don't trip the lane gate
_over_budget: list = []
_session_t0: list = []
_n_collected: list = []


def pytest_sessionstart(session):
    import time

    _session_t0.append(time.time())


def pytest_collection_finish(session):
    _n_collected.append(len(session.items))


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_makereport(item, call):
    out = yield
    rep = out.get_result()
    if (
        rep.when == "call"
        and rep.duration > PER_TEST_BUDGET_S
        and item.get_closest_marker("slow") is None
    ):
        _over_budget.append((item.nodeid, rep.duration))


def pytest_sessionfinish(session, exitstatus):
    import sys
    import time

    strict = os.environ.get("SPECTRAL_TEST_BUDGET_STRICT") == "1"
    if _over_budget:
        lines = "\n".join(f"  {d:6.1f}s  {n}" for n, d in sorted(
            _over_budget, key=lambda t: -t[1]))
        sys.stderr.write(
            f"\n[lane budget] {len(_over_budget)} default-lane test(s) over "
            f"{PER_TEST_BUDGET_S:.0f}s — mark slow, shrink, or dedup:\n"
            f"{lines}\n"
        )
        if strict:
            session.exitstatus = 1
    if (
        _session_t0
        and _n_collected
        and _n_collected[0] >= LANE_GATE_MIN_TESTS
    ):
        wall = time.time() - _session_t0[0]
        if wall > LANE_BUDGET_S:
            sys.stderr.write(
                f"\n[lane budget] full default lane took {wall:.0f}s > "
                f"{LANE_BUDGET_S:.0f}s ceiling (frozen round 5) — demote new "
                f"heavies to the slow lane or merge cases\n"
            )
            if strict:
                session.exitstatus = 1
