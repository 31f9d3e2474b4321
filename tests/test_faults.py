"""Fault-injection tests — resource-failure and corruption paths.

The one idea worth keeping from the reference's (non-compiling) GoogleTest
suite is that FAILURE paths deserve direct tests: it fakes malloc to check
allocation-failure → NULL handling (test/test_mixedRadixFFT.cpp:243-259,
1734-1750) and EXPECT_DEATHs invalid args (262-270).  The analogues
exercised here:

* HBM-budget rejection: an over-budget distributed four-step config raises
  a typed :class:`HBMBudgetError` at plan time instead of OOMing on the device.
* Plan-manifest corruption: :func:`load_plans` fails cleanly (typed error,
  live cache untouched) on missing, corrupt, or structurally-wrong files.
* Native-library disappearance mid-session: the pure-Python fallback takes
  over after :func:`native.reset`, with identical results.
"""

import os
import shutil

import numpy as np
import pytest

import mixed_radix_fast_fourier_transform_tpu as sp
from mixed_radix_fast_fourier_transform_tpu.plan import _CACHE
from mixed_radix_fast_fourier_transform_tpu.utils import native
from mixed_radix_fast_fourier_transform_tpu.utils.cache import (
    load_plans,
    save_plans,
    warm_plans,
)
from mixed_radix_fast_fourier_transform_tpu.utils.factorize import (
    _use_native,
    prime_factors,
)
from mixed_radix_fast_fourier_transform_tpu.utils.profiling import (
    HBMBudgetError,
    require_four_step_hbm,
)


class TestHBMBudget:
    def test_canonical_config_fits(self):
        est = require_four_step_hbm(65536, 4096, 8, limit_gb=80.0)
        assert est["limit_gb"] == 80.0
        assert est["total_gb"] < 15.0

    def test_over_budget_raises_typed(self):
        # 64x the canonical batch on one chip: ~hundreds of GB/chip
        with pytest.raises(HBMBudgetError) as ei:
            require_four_step_hbm(65536, 4096 * 64, 1, limit_gb=80.0)
        msg = str(ei.value)
        assert "GB/device" in msg and "shard" in msg
        # HBMBudgetError is a ValueError: generic API-boundary handlers
        # that catch ValueError keep working
        assert isinstance(ei.value, ValueError)

    def test_budget_scales_down_with_parts(self):
        big = 4096 * 64
        with pytest.raises(HBMBudgetError):
            require_four_step_hbm(65536, big, 1, limit_gb=80.0)
        # the fix the error message suggests actually works
        est = require_four_step_hbm(65536, big, 512, limit_gb=80.0)
        assert est["total_gb"] <= 15.0


class TestPlanManifestFaults:
    def test_roundtrip(self, tmp_path):
        warm_plans([360, 1024], signs=(-1,))
        p = str(tmp_path / "plans.npz")
        n_saved = save_plans(p)
        assert n_saved >= 2
        assert load_plans(p) == n_saved

    def test_missing_file(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            load_plans(str(tmp_path / "nope.npz"))

    def test_corrupt_bytes(self, tmp_path):
        p = tmp_path / "garbage.npz"
        p.write_bytes(b"\x00\x01this is not a zip archive\xff" * 20)
        with pytest.raises(ValueError, match="corrupt plan manifest"):
            load_plans(str(p))

    def test_wrong_shape(self, tmp_path):
        p = str(tmp_path / "badshape.npz")
        np.savez_compressed(p, manifest=np.ones((4, 2), np.int64))
        with pytest.raises(ValueError, match="expected .k, 3. rows"):
            load_plans(p)

    def test_missing_key(self, tmp_path):
        p = str(tmp_path / "nokey.npz")
        np.savez_compressed(p, something_else=np.ones(3))
        with pytest.raises(ValueError, match="corrupt plan manifest"):
            load_plans(p)

    def test_invalid_sign_and_odd_real_rows(self, tmp_path):
        # review finding (round 4): a sign outside {-1,1} or an odd-length
        # real-kind row must fail VALIDATION — before any plan is built —
        # with an error naming the manifest path
        before = len(_CACHE)
        p = str(tmp_path / "badsign.npz")
        np.savez_compressed(p, manifest=np.array([[0, 512, 7]], np.int64))
        with pytest.raises(ValueError, match="invalid signs"):
            load_plans(p)
        p2 = str(tmp_path / "oddreal.npz")
        np.savez_compressed(
            p2, manifest=np.array([[0, 360, -1], [1, 361, -1]], np.int64)
        )
        with pytest.raises(ValueError, match="odd lengths for real-kind"):
            load_plans(p2)
        assert len(_CACHE) == before  # nothing was built from either file

    def test_invalid_rows_leave_cache_untouched(self, tmp_path):
        p = str(tmp_path / "badrows.npz")
        rows = np.array([[7, 360, -1], [0, 1024, -1]], np.int64)
        np.savez_compressed(p, manifest=rows)
        before = len(_CACHE)
        with pytest.raises(ValueError, match="invalid kind ids"):
            load_plans(p)
        assert len(_CACHE) == before
        p2 = str(tmp_path / "badlen.npz")
        np.savez_compressed(p2, manifest=np.array([[0, 0, -1]], np.int64))
        with pytest.raises(ValueError, match="non-positive lengths"):
            load_plans(p2)
        assert len(_CACHE) == before


class TestNativeLibraryDisappears:
    """The .so vanishing mid-session must degrade to the pure-Python path
    with identical results — not crash, not silently skip planning."""

    def test_fallback_kicks_in_and_recovers(self):
        so = os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "native", "libspectral_native.so",
        )
        if not native.available() or not os.path.exists(so):
            pytest.skip("native library not built")
        want = prime_factors(5040)
        hidden = so + ".hidden"
        try:
            shutil.move(so, hidden)
            native.reset()  # re-arm the lazy loader: .so is now gone
            assert not native.available()
            assert not _use_native()
            # the public API keeps working on the pure-Python path
            assert prime_factors(5040) == want
            assert native.prime_factors(5040) is None  # binding reports absent
            x = (np.random.default_rng(0).standard_normal(360)
                 + 0j).astype(np.complex64)
            got = np.asarray(sp.fft(x, config=sp.SpectralConfig()))
            ref = np.fft.fft(x.astype(np.complex128))
            assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) < 1e-5
        finally:
            if os.path.exists(hidden):
                shutil.move(hidden, so)
            native.reset()
        # and the library comes back after restore + reset
        assert native.available()
        assert prime_factors(5040) == want
