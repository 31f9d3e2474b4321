"""Distributed-transform tests on an 8-virtual-device CPU mesh.

The reference has no distributed code to compare against (SURVEY.md §2.3);
the oracle is numpy.fft on the global array.  These tests exercise the real
collectives (all_to_all under shard_map) that ride the interconnect on hardware.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mixed_radix_fast_fourier_transform_tpu.parallel import (
    choose_split,
    fft_batch_sharded,
    fft_four_step,
    ifft_four_step,
    make_mesh,
    shard_batch,
)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


def _mesh_seq():
    return make_mesh((1, 8))


def _mesh_2d():
    return make_mesh((2, 4))


def _rand_complex(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(
        np.complex64
    )


class TestChooseSplit:
    def test_square_split(self):
        n1, n2 = choose_split(4096, 8)
        assert n1 * n2 == 4096 and n1 % 8 == 0 and n2 % 8 == 0

    def test_unsplittable_raises(self):
        with pytest.raises(ValueError):
            choose_split(17 * 19, 8)


class TestFourStep:
    @pytest.mark.parametrize("n", [1024, 4096, 65536])
    def test_forward_matches_numpy(self, rng, n):
        mesh = _mesh_seq()
        x = _rand_complex(rng, (n,))
        got = np.asarray(fft_four_step(x, mesh))
        want = np.fft.fft(x)
        assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 2e-5

    def test_batched_forward(self, rng):
        mesh = _mesh_seq()
        x = _rand_complex(rng, (4, 1024))
        got = np.asarray(fft_four_step(x, mesh))
        want = np.fft.fft(x, axis=-1)
        assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 2e-5

    @pytest.mark.slow
    def test_roundtrip(self, rng):
        mesh = _mesh_seq()
        x = _rand_complex(rng, (2, 4096))
        y = fft_four_step(x, mesh)
        z = np.asarray(ifft_four_step(y, mesh))
        assert np.max(np.abs(z - x)) < 1e-4

    def test_real_input(self, rng):
        mesh = _mesh_seq()
        x = rng.standard_normal(1024).astype(np.float32)
        got = np.asarray(fft_four_step(x, mesh))
        want = np.fft.fft(x)
        assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 2e-5

    def test_2d_mesh_data_plus_seq(self, rng):
        mesh = _mesh_2d()
        x = _rand_complex(rng, (4, 1024))
        got = np.asarray(fft_four_step(x, mesh, data_axis="data"))
        want = np.fft.fft(x, axis=-1)
        assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 2e-5

    def test_explicit_split(self, rng):
        mesh = _mesh_seq()
        x = _rand_complex(rng, (512,))
        got = np.asarray(fft_four_step(x, mesh, n1=8))
        want = np.fft.fft(x)
        assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 2e-5

    def test_mixed_radix_length(self, rng):
        # N = 5040·8... pick a non-power-of-two splittable length: 1920 = 2^7·3·5
        mesh = _mesh_seq()
        x = _rand_complex(rng, (1920,))
        got = np.asarray(fft_four_step(x, mesh))
        want = np.fft.fft(x)
        assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 2e-5

    def test_norm_ortho(self, rng):
        mesh = _mesh_seq()
        x = _rand_complex(rng, (1024,))
        got = np.asarray(fft_four_step(x, mesh, norm="ortho"))
        want = np.fft.fft(x, norm="ortho")
        assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 2e-5

    @pytest.mark.parametrize(
        "chunks", [2, pytest.param(4, marks=pytest.mark.slow)]
    )
    def test_overlap_chunks_matches(self, rng, chunks):
        """Batch-chunked comm/compute overlap pipelines are numerically
        identical to the monolithic body (SURVEY §7 hard part (d))."""
        mesh = _mesh_seq()
        x = _rand_complex(rng, (4, 4096))
        got = np.asarray(fft_four_step(x, mesh, overlap_chunks=chunks))
        want = np.fft.fft(x, axis=-1)
        assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 2e-5

    def test_overlap_chunks_requires_batch(self, rng):
        mesh = _mesh_seq()
        with pytest.raises(ValueError, match="batch"):
            fft_four_step(_rand_complex(rng, (1024,)), mesh, overlap_chunks=2)

    def test_output_sharding_contiguous(self, rng):
        mesh = _mesh_seq()
        x = _rand_complex(rng, (1024,))
        y = fft_four_step(x, mesh)
        assert y.shape == (1024,)
        # output is sharded along the transform axis, not replicated
        assert not y.sharding.is_fully_replicated


class TestBatchSharded:
    def test_matches_numpy(self, rng):
        mesh = make_mesh((8, 1))
        x = _rand_complex(rng, (16, 360))
        got = np.asarray(fft_batch_sharded(x, mesh))
        want = np.fft.fft(x, axis=-1)
        assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 2e-5

    def test_sharding_preserved(self, rng):
        mesh = make_mesh((8, 1))
        x = shard_batch(_rand_complex(rng, (16, 256)), mesh)
        y = fft_batch_sharded(x, mesh)
        assert not y.sharding.is_fully_replicated


class TestScrambledOrder:
    def test_scrambled_matches_natural_reordered(self, rng):
        mesh = _mesh_seq()
        x = _rand_complex(rng, (1024,))
        y = np.asarray(
            __import__(
                "mixed_radix_fast_fourier_transform_tpu.parallel", fromlist=["x"]
            ).fft_four_step_scrambled(x, mesh)
        )
        assert y.shape == (32, 32)
        want = np.fft.fft(x).reshape(32, 32).T  # Y[k1,k2] = X[k2*n1+k1]
        assert np.max(np.abs(y - want)) / np.max(np.abs(want)) < 2e-5

    @pytest.mark.slow
    def test_scrambled_roundtrip(self, rng):
        from mixed_radix_fast_fourier_transform_tpu.parallel import (
            fft_four_step_scrambled,
            ifft_four_step_scrambled,
        )

        mesh = _mesh_seq()
        x = _rand_complex(rng, (2, 4096))
        y = fft_four_step_scrambled(x, mesh)
        z = np.asarray(ifft_four_step_scrambled(y, mesh))
        assert np.max(np.abs(z - x)) < 1e-4


class TestConvolveSharded:
    @pytest.mark.slow
    def test_circular_matches_numpy(self, rng):
        from mixed_radix_fast_fourier_transform_tpu.parallel import fft_convolve_sharded

        mesh = _mesh_seq()
        n = 1024
        x = rng.standard_normal((2, n)).astype(np.float32)
        k = rng.standard_normal(31).astype(np.float32)
        got = np.asarray(fft_convolve_sharded(x, k, mesh, mode="circular"))
        kpad = np.zeros(n)
        kpad[:31] = k
        want = np.fft.ifft(np.fft.fft(x, axis=-1) * np.fft.fft(kpad), axis=-1)
        assert np.max(np.abs(got - want)) < 1e-3

    @pytest.mark.slow
    def test_same_mode_matches_scipy_semantics(self, rng):
        from mixed_radix_fast_fourier_transform_tpu.parallel import fft_convolve_sharded

        mesh = _mesh_seq()
        n = 1000
        x = rng.standard_normal(n).astype(np.float32)
        k = rng.standard_normal(17).astype(np.float32)
        got = np.asarray(fft_convolve_sharded(x, k, mesh, mode="same")).real
        want = np.convolve(x, k, mode="same")
        assert np.max(np.abs(got - want)) < 1e-3

    def test_2d_mesh(self, rng):
        from mixed_radix_fast_fourier_transform_tpu.parallel import fft_convolve_sharded

        mesh = _mesh_2d()
        x = rng.standard_normal((4, 1024)).astype(np.float32)
        k = rng.standard_normal(8).astype(np.float32)
        got = np.asarray(fft_convolve_sharded(x, k, mesh, data_axis="data"))
        kpad = np.zeros(1024)
        kpad[:8] = k
        want = np.fft.ifft(np.fft.fft(x, axis=-1) * np.fft.fft(kpad), axis=-1)
        assert np.max(np.abs(got - want)) < 1e-3

    @pytest.mark.slow
    def test_config5_shape_65536(self, rng):
        # BASELINE config 5's class of shape on the 8-virtual-device mesh:
        # 65536-point FFT convolution, large batch sharded over 'data', the
        # transform sharded over 'seq'.  Batch scaled from 4096 to 64 to keep
        # the CPU-mesh test tractable; the sharding pattern is identical.
        from mixed_radix_fast_fourier_transform_tpu.parallel import fft_convolve_sharded

        mesh = _mesh_2d()
        n, batch = 65536, 64
        x = rng.standard_normal((batch, n)).astype(np.float32)
        k = rng.standard_normal(129).astype(np.float32)
        got = np.asarray(
            fft_convolve_sharded(x, k, mesh, mode="circular", data_axis="data")
        ).real
        kpad = np.zeros(n)
        kpad[:129] = k
        want = np.fft.ifft(
            np.fft.fft(x[:2].astype(np.float64), axis=-1) * np.fft.fft(kpad), axis=-1
        ).real
        assert np.max(np.abs(got[:2] - want)) / np.max(np.abs(want)) < 1e-4


class TestPencil2D:
    def test_fft2_matches_numpy(self, rng):
        from mixed_radix_fast_fourier_transform_tpu.parallel import fft2_pencil

        mesh = _mesh_seq()
        x = _rand_complex(rng, (64, 128))
        got = np.asarray(fft2_pencil(x, mesh))
        want = np.fft.fft2(x)
        assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 2e-5

    @pytest.mark.slow
    def test_roundtrip_batched(self, rng):
        from mixed_radix_fast_fourier_transform_tpu.parallel import (
            fft2_pencil,
            ifft2_pencil,
        )

        mesh = _mesh_2d()
        x = _rand_complex(rng, (2, 32, 64))
        y = fft2_pencil(x, mesh, data_axis="data")
        z = np.asarray(ifft2_pencil(y, mesh, data_axis="data"))
        assert np.max(np.abs(z - x)) < 1e-4

    def test_indivisible_raises(self, rng):
        from mixed_radix_fast_fourier_transform_tpu.parallel import fft2_pencil

        mesh = _mesh_seq()
        with pytest.raises(ValueError):
            fft2_pencil(_rand_complex(rng, (12, 16)), mesh)


class TestDistributedRfft:
    def test_rfft_matches_numpy(self, rng):
        from mixed_radix_fast_fourier_transform_tpu.parallel import rfft_four_step

        mesh = _mesh_seq()
        x = rng.standard_normal(2048).astype(np.float32)
        got = np.asarray(rfft_four_step(x, mesh))
        want = np.fft.rfft(x.astype(np.float64))
        assert got.shape == (1025,)
        assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 2e-5

    @pytest.mark.slow
    def test_roundtrip_batched(self, rng):
        from mixed_radix_fast_fourier_transform_tpu.parallel import (
            irfft_four_step,
            rfft_four_step,
        )

        mesh = _mesh_2d()
        x = rng.standard_normal((4, 4096)).astype(np.float32)
        spec = rfft_four_step(x, mesh, data_axis="data")
        back = np.asarray(irfft_four_step(spec, mesh, n=4096, data_axis="data"))
        assert np.max(np.abs(back - x)) < 1e-4

    def test_complex_input_raises(self, rng):
        from mixed_radix_fast_fourier_transform_tpu.parallel import rfft_four_step

        mesh = _mesh_seq()
        with pytest.raises(ValueError):
            rfft_four_step(np.zeros(64, np.complex64), mesh)

    def test_odd_length_raises(self, rng):
        from mixed_radix_fast_fourier_transform_tpu.parallel import rfft_four_step

        mesh = _mesh_seq()
        with pytest.raises(ValueError):
            rfft_four_step(np.zeros(63, np.float32), mesh)


class TestPencilND:
    def test_3d_matches_numpy(self, rng):
        from mixed_radix_fast_fourier_transform_tpu.parallel import fftn_pencil

        mesh = _mesh_seq()
        x = _rand_complex(rng, (16, 24, 32))
        got = np.asarray(fftn_pencil(x, mesh, shard_dim=-2))
        want = np.fft.fftn(x)
        assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 3e-5

    @pytest.mark.slow
    def test_3d_roundtrip(self, rng):
        from mixed_radix_fast_fourier_transform_tpu.parallel import (
            fftn_pencil,
            ifftn_pencil,
        )

        mesh = _mesh_seq()
        x = _rand_complex(rng, (8, 16, 64))
        y = fftn_pencil(x, mesh, shard_dim=-2)
        z = np.asarray(ifftn_pencil(y, mesh, shard_dim=-2))
        assert np.max(np.abs(z - x)) < 1e-4

    def test_partial_axes(self, rng):
        # transform only the last two axes of a 3-D array, shard the middle one
        from mixed_radix_fast_fourier_transform_tpu.parallel import fftn_pencil

        mesh = _mesh_seq()
        x = _rand_complex(rng, (4, 16, 32))
        got = np.asarray(fftn_pencil(x, mesh, axes=(1, 2), shard_dim=1))
        want = np.fft.fftn(x, axes=(1, 2))
        assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 3e-5

    def test_shard_last_axis_raises(self, rng):
        from mixed_radix_fast_fourier_transform_tpu.parallel import fftn_pencil

        mesh = _mesh_seq()
        with pytest.raises(ValueError):
            fftn_pencil(_rand_complex(rng, (8, 16)), mesh, shard_dim=-1)

    def test_indivisible_raises(self, rng):
        from mixed_radix_fast_fourier_transform_tpu.parallel import fftn_pencil

        mesh = _mesh_seq()
        with pytest.raises(ValueError):
            fftn_pencil(_rand_complex(rng, (12, 32)), mesh, shard_dim=0)

    def test_data_axis_with_axis0_transform_raises(self, rng):
        # data_axis shards array axis 0 as batch; axes including 0 (the
        # default) must raise a clear error instead of an opaque trace error.
        from mixed_radix_fast_fourier_transform_tpu.parallel import fftn_pencil
        from mixed_radix_fast_fourier_transform_tpu.parallel.mesh import make_mesh

        mesh = make_mesh((2, 4))
        x = _rand_complex(rng, (4, 16, 32))
        with pytest.raises(ValueError, match="axis 0"):
            fftn_pencil(x, mesh, shard_dim=1, data_axis="data")

    def test_data_axis_batched_matches_numpy(self, rng):
        from mixed_radix_fast_fourier_transform_tpu.parallel import fftn_pencil
        from mixed_radix_fast_fourier_transform_tpu.parallel.mesh import make_mesh

        mesh = make_mesh((2, 4))
        x = _rand_complex(rng, (4, 16, 32))
        got = np.asarray(fftn_pencil(x, mesh, axes=(1, 2), shard_dim=1, data_axis="data"))
        want = np.fft.fftn(x, axes=(1, 2))
        assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 3e-5


class TestPencil2D2DMesh:
    """True 2-D pencil decomposition: BOTH mesh axes shard the 3-D volume."""

    def test_matches_numpy(self, rng):
        from mixed_radix_fast_fourier_transform_tpu.parallel import fftn_pencil2

        mesh = _mesh_2d()  # (2, 4)
        x = _rand_complex(rng, (8, 16, 24))
        got = np.asarray(fftn_pencil2(x, mesh))
        want = np.fft.fftn(x)
        assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 3e-5

    def test_roundtrip_and_norm(self, rng):
        from mixed_radix_fast_fourier_transform_tpu.parallel import (
            fftn_pencil2,
            ifftn_pencil2,
        )

        mesh = _mesh_2d()
        x = _rand_complex(rng, (4, 8, 16))
        back = np.asarray(ifftn_pencil2(fftn_pencil2(x, mesh), mesh))
        assert np.max(np.abs(back - x)) < 1e-4
        got = np.asarray(fftn_pencil2(x, mesh, norm="ortho"))
        want = np.fft.fftn(x, norm="ortho")
        assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 3e-5

    def test_indivisible_raises(self, rng):
        from mixed_radix_fast_fourier_transform_tpu.parallel import fftn_pencil2

        mesh = _mesh_2d()
        with pytest.raises(ValueError):
            fftn_pencil2(_rand_complex(rng, (8, 16, 23)), mesh)
        with pytest.raises(ValueError):
            fftn_pencil2(_rand_complex(rng, (8, 16)), mesh)

    @pytest.mark.slow
    def test_distributed_poisson(self):
        from mixed_radix_fast_fourier_transform_tpu.parallel import (
            poisson_solve_pencil2,
        )

        mesh = _mesh_2d()
        n = 32
        x = np.linspace(0, 2 * np.pi, n, endpoint=False)
        X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
        u_true = np.sin(2 * X) * np.cos(3 * Y) * np.sin(Z)
        f = -(4 + 9 + 1) * u_true
        u = np.asarray(poisson_solve_pencil2(f.astype(np.float32), mesh))
        assert np.max(np.abs(u - u_true)) < 2e-5

    @pytest.mark.slow
    def test_real_3d_matches_numpy(self, rng):
        from mixed_radix_fast_fourier_transform_tpu.parallel import (
            irfftn_pencil2,
            rfftn_pencil2,
        )

        mesh = _mesh_2d()
        # h = 13 bins does NOT divide the 8-device mesh: exercises the pad
        x = rng.standard_normal((4, 8, 24)).astype(np.float32)
        got = np.asarray(rfftn_pencil2(x, mesh))
        want = np.fft.rfftn(x.astype(np.float64))
        assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 3e-5
        back = np.asarray(irfftn_pencil2(rfftn_pencil2(x, mesh), mesh, n2=24))
        assert np.max(np.abs(back - x)) < 1e-4


class TestConvolve2Sharded:
    def test_circular_matches_numpy(self, rng):
        from mixed_radix_fast_fourier_transform_tpu.parallel import (
            fft_convolve2_sharded,
        )

        mesh = _mesh_seq()
        img = rng.standard_normal((32, 64)).astype(np.float32)
        k = rng.standard_normal((3, 5)).astype(np.float32)
        got = np.asarray(fft_convolve2_sharded(img, k, mesh, mode="circular"))
        kpad = np.zeros((32, 64)); kpad[:3, :5] = k
        want = np.fft.ifft2(np.fft.fft2(img) * np.fft.fft2(kpad))
        assert np.max(np.abs(got - want)) < 1e-3

    @pytest.mark.slow
    def test_same_matches_direct(self, rng):
        from mixed_radix_fast_fourier_transform_tpu.parallel import (
            fft_convolve2_sharded,
        )

        mesh = _mesh_seq()
        img = rng.standard_normal((30, 50)).astype(np.float32)
        k = rng.standard_normal((5, 5)).astype(np.float32)
        got = np.real(np.asarray(fft_convolve2_sharded(img, k, mesh, mode="same")))
        full = np.zeros((34, 54))
        for i in range(5):
            for j in range(5):
                full[i : i + 30, j : j + 50] += k[i, j] * img
        want = full[2:32, 2:52]
        assert got.shape == want.shape
        assert np.max(np.abs(got - want)) < 1e-3

    @pytest.mark.slow
    def test_batched_data_axis(self, rng):
        from mixed_radix_fast_fourier_transform_tpu.parallel import (
            fft_convolve2_sharded,
        )

        mesh = _mesh_2d()
        img = rng.standard_normal((2, 16, 32)).astype(np.float32)
        k = np.ones((2, 2), np.float32)
        got = np.asarray(
            fft_convolve2_sharded(img, k, mesh, mode="circular", data_axis="data")
        )
        assert got.shape == (2, 16, 32)


class TestNufftSharded:
    def test_nufft1_sharded_matches_single_chip(self):
        mesh8 = _mesh_seq()
        rng = np.random.default_rng(0)
        m, n = 100, 48  # 100 does not divide 8: exercises zero-padding
        x = rng.uniform(0, 2 * np.pi, m).astype(np.float32)
        c = (rng.standard_normal((2, m)) + 1j * rng.standard_normal((2, m))).astype(
            np.complex64
        )
        from mixed_radix_fast_fourier_transform_tpu.parallel import nufft1_sharded
        import mixed_radix_fast_fourier_transform_tpu as sp

        got = np.asarray(nufft1_sharded(x, c, n, mesh8, "seq"))
        want = np.asarray(sp.nufft1(x, c, n, method="grid"))
        assert got.shape == (2, n)
        assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 1e-6

    def test_nufft2_sharded_matches_single_chip(self):
        mesh8 = _mesh_seq()
        rng = np.random.default_rng(1)
        m, n = 90, 32
        x = rng.uniform(0, 2 * np.pi, m).astype(np.float32)
        f = (rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))).astype(
            np.complex64
        )
        from mixed_radix_fast_fourier_transform_tpu.parallel import nufft2_sharded
        import mixed_radix_fast_fourier_transform_tpu as sp

        got = np.asarray(nufft2_sharded(x, f, mesh8, "seq"))
        want = np.asarray(sp.nufft2(x, f, method="grid"))
        assert got.shape == (3, m)
        assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 1e-6


class TestShtSharded:
    def test_sht_sharded_matches_single_chip(self):
        mesh = _mesh_seq()
        import mixed_radix_fast_fourier_transform_tpu as sp
        from mixed_radix_fast_fourier_transform_tpu.parallel import (
            isht_sharded,
            sht_sharded,
        )

        rng = np.random.default_rng(2)
        L = 16  # divides 8
        f = rng.standard_normal((3, L, 2 * L)).astype(np.float32)
        got = np.asarray(sht_sharded(f, mesh, "seq"))
        want = np.asarray(sp.sht(f))
        assert np.max(np.abs(got - want)) < 1e-5 * max(1.0, np.abs(want).max())
        back = np.asarray(isht_sharded(got.astype(np.complex64), mesh, "seq"))
        ref = np.asarray(sp.isht(got.astype(np.complex64)))
        assert np.max(np.abs(back - ref)) < 1e-5 * max(1.0, np.abs(ref).max())

    def test_sht_sharded_bad_division(self):
        mesh = _mesh_seq()
        from mixed_radix_fast_fourier_transform_tpu.parallel import sht_sharded

        with pytest.raises(ValueError):
            sht_sharded(np.zeros((12, 24), np.float32), mesh, "seq")


@pytest.mark.slow  # lane budget: five separately-traced sharded programs;
# the 1-D point-sharded NUFFT pair covers the machinery in the default lane
def test_nufft_2d_sharded_matches_local():
    """Point-sharded 2-D NUFFT == the local op (types 1 and 2)."""
    from mixed_radix_fast_fourier_transform_tpu.ops.nufft import (
        nufft1_2d, nufft2_2d,
    )
    from mixed_radix_fast_fourier_transform_tpu.parallel import (
        nufft1_2d_sharded, nufft2_2d_sharded,
    )

    mesh8 = _mesh_seq()
    rng = np.random.default_rng(5)
    m = 101  # deliberately not divisible by the mesh size
    x = rng.uniform(0, 2 * np.pi, m).astype(np.float32)
    y = rng.uniform(0, 2 * np.pi, m).astype(np.float32)
    c = (rng.standard_normal(m) + 1j * rng.standard_normal(m)).astype(
        np.complex64
    )
    nm = (32, 16)
    want = np.asarray(nufft1_2d(x, y, c, nm, method="grid"))
    got = np.asarray(nufft1_2d_sharded(x, y, c, nm, mesh8, "seq"))
    scale = max(np.abs(want).max(), 1e-9)
    assert np.max(np.abs(got - want)) / scale < 1e-5
    f = (rng.standard_normal(nm) + 1j * rng.standard_normal(nm)).astype(
        np.complex64
    )
    want2 = np.asarray(nufft2_2d(x, y, f, method="grid"))
    got2 = np.asarray(nufft2_2d_sharded(x, y, f, mesh8, "seq"))
    assert got2.shape == want2.shape
    s2 = max(np.abs(want2).max(), 1e-9)
    assert np.max(np.abs(got2 - want2)) / s2 < 1e-5


def test_sht_sharded_complex_field_matches():
    """Complex fields take the full (non-Hermitian) sharded path."""
    import mixed_radix_fast_fourier_transform_tpu as sp
    from mixed_radix_fast_fourier_transform_tpu.parallel import sht_sharded

    mesh = _mesh_seq()
    rng = np.random.default_rng(9)
    L = 16
    f = (rng.standard_normal((2, L, 2 * L))
         + 1j * rng.standard_normal((2, L, 2 * L))).astype(np.complex64)
    got = np.asarray(sht_sharded(f, mesh, "seq"))
    want = np.asarray(sp.sht(f))
    assert np.max(np.abs(got - want)) < 1e-5 * max(1.0, np.abs(want).max())


@pytest.mark.slow  # lane budget: the table-path sht_sharded test keeps the
# latitude-sharded machinery in the default lane; recurrence scans trace slowly
def test_sht_recurrence_sharded_matches_local():
    """Latitude-sharded recurrence SHT == the local recurrence/table paths
    (real and complex fields; synthesis both variants)."""
    import mixed_radix_fast_fourier_transform_tpu as sp
    from mixed_radix_fast_fourier_transform_tpu.parallel import (
        isht_recurrence_sharded, sht_recurrence_sharded,
    )

    mesh = _mesh_seq()
    rng = np.random.default_rng(11)
    L = 16
    f = rng.standard_normal((2, L, 2 * L)).astype(np.float32)
    got = np.asarray(sht_recurrence_sharded(f, mesh, "seq"))
    want = np.asarray(sp.sht(f))
    assert np.max(np.abs(got - want)) < 1e-5 * max(1.0, np.abs(want).max())
    back = np.asarray(isht_recurrence_sharded(got, mesh, "seq"))
    ref = np.asarray(sp.isht(got))
    assert np.max(np.abs(back - ref)) < 1e-5 * max(1.0, np.abs(ref).max())
    br = np.asarray(
        isht_recurrence_sharded(got, mesh, "seq", real_output=True)
    )
    assert np.max(np.abs(br - np.real(ref))) < 1e-5 * max(1.0, np.abs(ref).max())
    fc = (f + 1j * rng.standard_normal(f.shape)).astype(np.complex64)
    gotc = np.asarray(sht_recurrence_sharded(fc, mesh, "seq"))
    wantc = np.asarray(sp.sht(fc))
    assert np.max(np.abs(gotc - wantc)) < 1e-5 * max(1.0, np.abs(wantc).max())


@pytest.mark.slow  # see test_sht_recurrence_sharded_matches_local
def test_sht_recurrence_sharded_compensated():
    """compensated=True plumbs through the latitude-sharded recurrence
    pair: matches the local compensated path to psum-reorder tolerance."""
    import mixed_radix_fast_fourier_transform_tpu as sp
    from mixed_radix_fast_fourier_transform_tpu.parallel import (
        isht_recurrence_sharded, sht_recurrence_sharded,
    )

    mesh = _mesh_seq()
    rng = np.random.default_rng(12)
    L = 16
    f = rng.standard_normal((2, L, 2 * L)).astype(np.float32)
    got = np.asarray(sht_recurrence_sharded(f, mesh, "seq", compensated=True))
    want = np.asarray(sp.sht_recurrence(f, compensated=True))
    assert np.max(np.abs(got - want)) < 1e-6 * max(1.0, np.abs(want).max())
    back = np.asarray(
        isht_recurrence_sharded(got, mesh, "seq", compensated=True)
    )
    ref = np.asarray(sp.isht_recurrence(got, compensated=True))
    assert np.max(np.abs(back - ref)) < 1e-6 * max(1.0, np.abs(ref).max())


@pytest.mark.slow  # lane budget: Gauss-grid sht_sharded stays default; the
# equiangular variant differs only in quadrature constants
def test_sht_sharded_equiangular():
    """Latitude-sharded analysis/synthesis on the equiangular grid."""
    import mixed_radix_fast_fourier_transform_tpu as sp
    from mixed_radix_fast_fourier_transform_tpu.parallel import (
        isht_sharded, sht_sharded,
    )

    mesh = _mesh_seq()
    rng = np.random.default_rng(17)
    L = 8  # nlat = 16, divisible by the 8-way mesh
    f = rng.standard_normal((2, 2 * L, 2 * L)).astype(np.float32)
    got = np.asarray(sht_sharded(f, mesh, "seq", grid="equiangular"))
    want = np.asarray(sp.sht(f, grid="equiangular"))
    assert np.max(np.abs(got - want)) < 1e-5 * max(1.0, np.abs(want).max())
    back = np.asarray(isht_sharded(got, mesh, "seq", grid="equiangular"))
    ref = np.asarray(sp.isht(got, grid="equiangular"))
    assert back.shape == ref.shape == (2, 2 * L, 2 * L)
    assert np.max(np.abs(back - ref)) < 1e-5 * max(1.0, np.abs(ref).max())


class TestBatchShardedAudioOps:
    """Late-round-3 ops under data sharding: purely batched computations
    (melspectrogram, cqt, multitaper, AFNO train step) run unchanged on a
    batch-sharded mesh — sharding in, sharding out, values equal to the
    single-device result."""

    def test_melspectrogram_batch_sharded(self, rng):
        import mixed_radix_fast_fourier_transform_tpu as sp

        mesh = make_mesh((8, 1))
        x = rng.standard_normal((8, 8192)).astype(np.float32)
        xd = shard_batch(jnp.asarray(x), mesh)
        got = jax.jit(lambda v: sp.melspectrogram(v, 22050.0, n_mels=32))(xd)
        want = np.asarray(sp.melspectrogram(x, 22050.0, n_mels=32))
        assert np.abs(np.asarray(got) - want).max() / want.max() < 1e-5
        assert not got.sharding.is_fully_replicated

    def test_afno_dp_train_step(self, rng):
        from mixed_radix_fast_fourier_transform_tpu.models import afno

        mesh = make_mesh((8, 1))
        params = afno.init_afno(
            jax.random.PRNGKey(0), 2, 16, 1, patch=4, n_layers=1, n_blocks=4
        )
        x = jax.random.normal(jax.random.PRNGKey(1), (8, 8, 8, 2))
        tgt = jax.random.normal(jax.random.PRNGKey(2), (8, 8, 8, 1))
        p1, l1 = jax.jit(
            lambda p, a, b: afno.train_step(p, a, b, patch=4, n_blocks=4)
        )(params, shard_batch(x, mesh), shard_batch(tgt, mesh))
        p2, l2 = jax.jit(
            lambda p, a, b: afno.train_step(p, a, b, patch=4, n_blocks=4)
        )(params, x, tgt)
        assert abs(float(l1) - float(l2)) < 1e-5
        d = jax.tree_util.tree_map(
            lambda a, b: float(jnp.abs(a - b).max()), p1, p2
        )
        assert max(jax.tree_util.tree_leaves(d)) < 1e-5


@pytest.mark.slow  # vmap-of-associative-scan over the 8-dev mesh: ~30 s compile
def test_kalman_filter_sharded_matches_single(rng):
    from mixed_radix_fast_fourier_transform_tpu.parallel import (
        kalman_filter_sharded,
    )
    import mixed_radix_fast_fourier_transform_tpu as sp

    mesh8 = make_mesh((8, 1))  # all devices on the data (batch) axis
    d, d_obs, B, T = 2, 1, 8, 64
    F = np.array([[1.0, 1.0], [0.0, 0.95]])
    F *= 0.95 / max(np.abs(np.linalg.eigvals(F)))
    Q = 0.01 * np.eye(d)
    H = rng.standard_normal((d_obs, d))
    R = 0.1 * np.eye(d_obs)
    m0, P0 = np.zeros(d), np.eye(d)
    ys = rng.standard_normal((B, T, d_obs)).astype(np.float32)
    ms, Ps = kalman_filter_sharded(F, Q, H, R, m0, P0, ys, mesh8)
    assert ms.shape == (B, T, d) and Ps.shape == (B, T, d, d)
    # per-track equality with the single-sequence path
    for b in (0, 3, 7):
        want_m, want_P = sp.kalman_filter(F, Q, H, R, m0, P0, ys[b])
        np.testing.assert_allclose(np.asarray(ms)[b], np.asarray(want_m),
                                   atol=5e-5)
        np.testing.assert_allclose(np.asarray(Ps)[b], np.asarray(want_P),
                                   atol=5e-5)
    # smoother path runs under the same sharding
    sm, sP = kalman_filter_sharded(F, Q, H, R, m0, P0, ys, mesh8,
                                   smooth=True)
    assert sm.shape == (B, T, d)


def test_pfb_analysis_sharded_matches_single(rng):
    from mixed_radix_fast_fourier_transform_tpu.parallel import (
        pfb_analysis_sharded,
    )
    import mixed_radix_fast_fourier_transform_tpu as sp

    mesh8 = make_mesh((8, 1))
    K, P_, B = 16, 4, 8
    x = (rng.standard_normal((B, K * 32))
         + 1j * rng.standard_normal((B, K * 32))).astype(np.complex64)
    Y = pfb_analysis_sharded(x, K, mesh8, taps_per_branch=P_)
    want = sp.pfb_analysis(x, K, P_)
    assert Y.shape == want.shape
    np.testing.assert_allclose(np.asarray(Y), np.asarray(want), atol=1e-5)
    # oversampled + full-mode variants run under the same sharding
    Yo = pfb_analysis_sharded(x, K, mesh8, taps_per_branch=P_,
                              hop=3 * K // 4)
    np.testing.assert_allclose(
        np.asarray(Yo),
        np.asarray(sp.pfb_analysis(x, K, P_, hop=3 * K // 4)), atol=1e-5)
    Yf = pfb_analysis_sharded(x, K, mesh8, taps_per_branch=P_, mode="full")
    np.testing.assert_allclose(
        np.asarray(Yf),
        np.asarray(sp.pfb_analysis(x, K, P_, mode="full")), atol=1e-5)
    with pytest.raises(ValueError):
        pfb_analysis_sharded(x[:5], K, mesh8)  # 5 % 8 != 0
    with pytest.raises(ValueError):
        pfb_analysis_sharded(x[0], K, mesh8)  # not (batch, T)


def test_range_doppler_cfar_sharded_matches_single(rng):
    from mixed_radix_fast_fourier_transform_tpu.parallel import (
        range_doppler_cfar_sharded,
    )
    import mixed_radix_fast_fourier_transform_tpu as sp

    mesh8 = make_mesh((8, 1))
    B, n_pulses, n, nt = 8, 32, 256, 32
    t = np.arange(nt)
    tx = np.exp(1j * np.pi * 0.5 / nt * (t - nt / 2) ** 2)
    rx = 0.3 * (rng.standard_normal((B, n_pulses, n))
                + 1j * rng.standard_normal((B, n_pulses, n)))
    d0, fd = n // 2, 3
    m = np.arange(n_pulses)[:, None]
    rx[:, :, d0: d0 + nt] += tx * np.exp(2j * np.pi * fd * m / n_pulses)
    rx = rx.astype(np.complex64)
    txd = tx.astype(np.complex64)
    Y, det, th = range_doppler_cfar_sharded(
        rx, txd, mesh8, window="hamming", num_train=6, num_guard=2,
        pfa=1e-4)
    assert Y.shape == det.shape == th.shape == (B, n_pulses, n - nt + 1)
    # per-CPI equality with the single-chip chain
    for b in (0, 7):
        want = sp.range_doppler(rx[b], txd, window="hamming")
        np.testing.assert_allclose(np.asarray(Y)[b], np.asarray(want),
                                   atol=1e-4)
        p = np.abs(np.asarray(want)) ** 2
        want_det, want_th = sp.cfar(p, num_train=6, num_guard=2, pfa=1e-4,
                                    axes=(-2, -1))
        np.testing.assert_allclose(np.asarray(th)[b], np.asarray(want_th),
                                   rtol=1e-3)
    # every CPI detects its target at (center_row + fd, d0)
    det = np.asarray(det)
    for b in range(B):
        assert det[b, n_pulses // 2 + fd, d0]
    with pytest.raises(ValueError):
        range_doppler_cfar_sharded(rx[0], txd, mesh8)
