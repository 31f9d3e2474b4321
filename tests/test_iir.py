"""IIR design + associative-scan filtering — scipy fp64 oracle comparisons.

Design functions are host fp64 and compared tightly; the device recurrence
runs in fp32, so application tolerances are the fp32 recurrence class
(sos cascades stay ~1e-6; high-order direct forms drift toward 1e-4, which
is why the docstrings steer users to sos).
"""

import numpy as np
import pytest

scipy_signal = pytest.importorskip("scipy.signal")

import jax
import jax.numpy as jnp

import mixed_radix_fast_fourier_transform_tpu as sp
from mixed_radix_fast_fourier_transform_tpu.ops import iir


def _zpk_close(got, want, tol=1e-7):
    gz, gp, gk = got
    wz, wp, wk = want
    gz, gp = np.atleast_1d(gz), np.atleast_1d(gp)
    wz, wp = np.atleast_1d(wz), np.atleast_1d(wp)  # scipy ellipap(1) is 0-d
    assert len(gz) == len(wz) and len(gp) == len(wp)
    if len(wz):
        assert np.max(np.abs(np.sort_complex(gz) - np.sort_complex(wz))) < tol
    if len(wp):
        assert np.max(np.abs(np.sort_complex(gp) - np.sort_complex(wp))) < tol
    assert abs(gk - wk) <= tol * max(1.0, abs(wk))


class TestPrototypes:
    @pytest.mark.parametrize("N", [1, 2, 3, 5, 8])
    def test_buttap(self, N):
        _zpk_close(sp.buttap(N), scipy_signal.buttap(N), tol=1e-12)

    @pytest.mark.parametrize("N", [1, 2, 4, 7])
    def test_cheb1ap(self, N):
        _zpk_close(sp.cheb1ap(N, 1.0), scipy_signal.cheb1ap(N, 1.0), tol=1e-12)

    @pytest.mark.parametrize("N", [1, 3, 6])
    def test_cheb2ap(self, N):
        _zpk_close(sp.cheb2ap(N, 40.0), scipy_signal.cheb2ap(N, 40.0), tol=1e-12)

    @pytest.mark.parametrize("N", [1, 2, 3, 5, 8, 9])
    def test_ellipap(self, N):
        # Landen-recursion Jacobi functions vs scipy's (both fp64)
        _zpk_close(sp.ellipap(N, 1.0, 40.0), scipy_signal.ellipap(N, 1.0, 40.0))

    @pytest.mark.parametrize("rp,rs", [(0.5, 60.0), (3.0, 80.0)])
    def test_ellipap_specs(self, rp, rs):
        _zpk_close(sp.ellipap(7, rp, rs), scipy_signal.ellipap(7, rp, rs))

    @pytest.mark.parametrize("norm", ["phase", "delay", "mag"])
    def test_besselap(self, norm):
        _zpk_close(sp.besselap(5, norm), scipy_signal.besselap(5, norm), tol=1e-6)

    def test_bad_args(self):
        with pytest.raises(ValueError):
            sp.cheb1ap(4, -1.0)
        with pytest.raises(ValueError):
            sp.ellipap(4, 2.0, 1.0)  # rs <= rp
        with pytest.raises(ValueError):
            sp.buttap(-1)


DESIGNS = [
    ("butter lp", lambda o: sp.butter(4, 0.3, output=o),
     lambda o: scipy_signal.butter(4, 0.3, output=o)),
    ("butter bs", lambda o: sp.butter(3, [0.2, 0.5], "bandstop", output=o),
     lambda o: scipy_signal.butter(3, [0.2, 0.5], "bandstop", output=o)),
    ("cheby1 bp", lambda o: sp.cheby1(4, 1.0, [0.25, 0.6], "bandpass", output=o),
     lambda o: scipy_signal.cheby1(4, 1.0, [0.25, 0.6], "bandpass", output=o)),
    ("cheby2 hp", lambda o: sp.cheby2(6, 50.0, 0.35, "highpass", output=o),
     lambda o: scipy_signal.cheby2(6, 50.0, 0.35, "highpass", output=o)),
    ("ellip lp", lambda o: sp.ellip(5, 0.5, 60.0, 0.3, output=o),
     lambda o: scipy_signal.ellip(5, 0.5, 60.0, 0.3, output=o)),
    ("bessel lp", lambda o: sp.bessel(4, 0.3, output=o),
     lambda o: scipy_signal.bessel(4, 0.3, output=o)),
]


class TestDesign:
    @pytest.mark.parametrize("name,mine,ref", DESIGNS, ids=[d[0] for d in DESIGNS])
    def test_ba_parity(self, name, mine, ref):
        b, a = mine("ba")
        wb, wa = ref("ba")
        assert np.max(np.abs(b - wb)) < 1e-8 * max(1.0, np.abs(wb).max())
        assert np.max(np.abs(a - wa)) < 1e-8 * max(1.0, np.abs(wa).max())

    @pytest.mark.parametrize("name,mine,ref", DESIGNS, ids=[d[0] for d in DESIGNS])
    def test_sos_response_parity(self, name, mine, ref):
        # section pairing may legitimately differ from scipy's; equivalence
        # is by frequency response and pole/zero multiset
        sos = mine("sos")
        wz, wp, wk = ref("zpk")
        w = np.linspace(0.01, 0.99 * np.pi, 201)
        _, h_mine = scipy_signal.sosfreqz(np.asarray(sos), worN=w)
        _, h_ref = scipy_signal.freqz_zpk(wz, wp, wk, worN=w)
        assert np.max(np.abs(h_mine - h_ref)) < 1e-7 * max(1.0, np.abs(h_ref).max())
        gz, gp, gk = iir.sos2zpk(sos)
        assert len(gp) == len(wp) + (len(wp) % 2)

    def test_fs_and_analog(self):
        b, a = sp.butter(4, 100.0, fs=1000.0)
        wb, wa = scipy_signal.butter(4, 100.0, fs=1000.0)
        assert np.max(np.abs(b - wb)) < 1e-10
        b, a = sp.butter(4, 15.0, analog=True)
        wb, wa = scipy_signal.butter(4, 15.0, analog=True)
        assert np.max(np.abs(a - wa)) < 1e-8 * np.abs(wa).max()

    def test_invalid(self):
        with pytest.raises(ValueError):
            sp.butter(4, 1.5)  # digital Wn out of range
        with pytest.raises(ValueError):
            sp.butter(4, [0.5, 0.2], "bandpass")  # unordered band
        with pytest.raises(ValueError):
            sp.iirfilter(4, 0.3, ftype="nope")
        with pytest.raises(ValueError):
            sp.cheby1(4, None, 0.3)  # missing ripple

    @pytest.mark.parametrize("kind", ["notch", "peak"])
    def test_notch_peak(self, kind):
        fn = sp.iirnotch if kind == "notch" else sp.iirpeak
        sfn = scipy_signal.iirnotch if kind == "notch" else scipy_signal.iirpeak
        b, a = fn(0.3, 30.0)
        wb, wa = sfn(0.3, 30.0)
        assert np.max(np.abs(b - wb)) < 1e-12
        assert np.max(np.abs(a - wa)) < 1e-12

    @pytest.mark.parametrize("ftype", ["notch", "peak"])
    @pytest.mark.parametrize("pass_zero", [False, True])
    def test_iircomb(self, ftype, pass_zero):
        b, a = sp.iircomb(0.1, 30.0, ftype=ftype, pass_zero=pass_zero)
        wb, wa = scipy_signal.iircomb(0.1, 30.0, ftype=ftype, pass_zero=pass_zero)
        assert np.max(np.abs(b - wb)) < 1e-12
        assert np.max(np.abs(a - wa)) < 1e-12


class TestOrderSelection:
    @pytest.mark.parametrize("args", [
        (0.2, 0.3, 1, 40), (0.3, 0.2, 1, 40), ([0.2, 0.5], [0.1, 0.6], 2, 30),
    ])
    def test_buttord(self, args):
        gN, gW = sp.buttord(*args)
        wN, wW = scipy_signal.buttord(*args)
        assert gN == wN
        assert np.max(np.abs(np.atleast_1d(gW) - np.atleast_1d(wW))) < 1e-8

    @pytest.mark.parametrize("fn,sfn", [
        (sp.cheb1ord, scipy_signal.cheb1ord),
        (sp.cheb2ord, scipy_signal.cheb2ord),
        (sp.ellipord, scipy_signal.ellipord),
    ], ids=["cheb1", "cheb2", "ellip"])
    def test_cheb_ellip_ord(self, fn, sfn):
        for args in [(0.2, 0.3, 1, 40), (0.3, 0.2, 1, 40),
                     ([0.2, 0.5], [0.1, 0.6], 2, 30)]:
            gN, gW = fn(*args)
            wN, wW = sfn(*args)
            assert gN == wN
            assert np.max(np.abs(np.atleast_1d(gW) - np.atleast_1d(wW))) < 1e-8

    def test_bandstop_meets_spec(self):
        # bandstop uses the conservative un-nudged selectivity: order may
        # exceed scipy's by one, but the designed filter must meet the spec
        N, Wn = sp.buttord([0.2, 0.5], [0.3, 0.4], 2, 30)
        b, a = sp.butter(N, Wn, "bandstop")
        w, h = scipy_signal.freqz(b, a, worN=4096)
        f = w / np.pi
        stop = (f >= 0.3) & (f <= 0.4)
        pass_lo = f <= 0.2
        pass_hi = f >= 0.5
        h_db = 20 * np.log10(np.abs(h) + 1e-300)
        assert h_db[stop].max() <= -30.0 + 1e-6
        assert h_db[pass_lo].min() >= -2.0 - 1e-6
        assert h_db[pass_hi].min() >= -2.0 - 1e-6


class TestConversions:
    def test_zpk_tf_roundtrip(self):
        # cheby2 has DISTINCT zeros, so np.roots can recover them tightly
        # (butter's multiplicity-N zero at −1 is only recoverable to eps^{1/N})
        z, p, k = scipy_signal.cheby2(5, 40.0, 0.4, output="zpk")
        b, a = iir.zpk2tf(z, p, k)
        z2, p2, k2 = iir.tf2zpk(b, a)
        assert np.max(np.abs(np.sort_complex(z2) - np.sort_complex(z))) < 1e-8
        assert np.max(np.abs(np.sort_complex(p2) - np.sort_complex(p))) < 1e-8
        assert abs(k2 - k) < 1e-10 * abs(k)

    @pytest.mark.parametrize("zpk", [
        lambda: scipy_signal.butter(6, 0.3, output="zpk"),
        lambda: scipy_signal.ellip(5, 0.5, 50, [0.2, 0.6], "bandpass", output="zpk"),
        lambda: scipy_signal.butter(5, [0.25, 0.5], "bandstop", output="zpk"),
    ], ids=["butter6", "ellip-bp", "butter-bs"])
    def test_zpk2sos_response(self, zpk):
        z, p, k = zpk()
        sos = iir.zpk2sos(z, p, k)
        w = np.linspace(0.01, 0.99 * np.pi, 201)
        _, h1 = scipy_signal.freqz_zpk(z, p, k, worN=w)
        _, h2 = scipy_signal.sosfreqz(np.asarray(sos), worN=w)
        assert np.max(np.abs(h1 - h2)) < 1e-8 * max(1.0, np.abs(h1).max())

    def test_sos2tf(self):
        sos = scipy_signal.butter(4, 0.3, output="sos")
        b, a = iir.sos2tf(sos)
        wb, wa = scipy_signal.sos2tf(sos)
        assert np.max(np.abs(b - wb)) < 1e-12
        assert np.max(np.abs(a - wa)) < 1e-12

    def test_zpk2sos_improper_raises(self):
        with pytest.raises(ValueError):
            iir.zpk2sos(np.ones(3, complex), np.ones(2, complex) * 0.5, 1.0)


class TestApply:
    def test_sosfilt_parity(self, rng):
        x = rng.standard_normal((3, 1024)).astype(np.float32)
        sos = scipy_signal.butter(6, 0.2, output="sos")
        want = scipy_signal.sosfilt(sos, x.astype(np.float64), axis=-1)
        got = np.asarray(jax.jit(lambda v: sp.sosfilt(sos, v))(x))
        assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 1e-5

    def test_sosfilt_zi_zf(self, rng):
        x = rng.standard_normal((2, 512)).astype(np.float32)
        sos = scipy_signal.butter(4, 0.25, output="sos")
        zi = sp.sosfilt_zi(sos)
        assert np.max(np.abs(zi - scipy_signal.sosfilt_zi(sos))) < 1e-12
        zi_b = np.broadcast_to(zi[:, None, :], (zi.shape[0], 2, 2)).copy()
        want, wzf = scipy_signal.sosfilt(sos, x.astype(np.float64), zi=zi_b)
        got, gzf = jax.jit(
            lambda v: sp.sosfilt(sos, v, zi=jnp.asarray(zi_b, jnp.float32))
        )(x)
        assert np.max(np.abs(np.asarray(got) - want)) / np.max(np.abs(want)) < 1e-5
        assert np.max(np.abs(np.asarray(gzf) - wzf)) < 1e-4

    def test_sosfilt_streaming_chunks(self, rng):
        # zi/zf chaining: filtering in two chunks == filtering in one
        x = rng.standard_normal(512).astype(np.float32)
        sos = scipy_signal.cheby1(4, 1, 0.3, output="sos")
        full = np.asarray(sp.sosfilt(sos, x))
        zi0 = jnp.zeros((sos.shape[0], 2), jnp.float32)
        y1, zf = sp.sosfilt(sos, x[:256], zi=zi0)
        y2, _ = sp.sosfilt(sos, x[256:], zi=zf)
        chunked = np.concatenate([np.asarray(y1), np.asarray(y2)])
        assert np.max(np.abs(chunked - full)) < 1e-5 * max(1.0, np.abs(full).max())

    def test_lfilter_iir_and_fir(self, rng):
        x = rng.standard_normal((2, 1024)).astype(np.float32)
        b, a = scipy_signal.cheby1(4, 1, 0.25)
        want = scipy_signal.lfilter(b, a, x.astype(np.float64), axis=-1)
        got = np.asarray(jax.jit(lambda v: sp.lfilter(b, a, v))(x))
        assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 2e-4
        bf = scipy_signal.firwin(33, 0.3)
        want = scipy_signal.lfilter(bf, [1.0], x.astype(np.float64), axis=-1)
        got = np.asarray(jax.jit(lambda v: sp.lfilter(bf, [1.0], v))(x))
        assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 1e-5

    def test_lfilter_zi(self):
        b, a = scipy_signal.cheby1(4, 1, 0.25)
        assert np.max(np.abs(sp.lfilter_zi(b, a) - scipy_signal.lfilter_zi(b, a))) < 1e-10

    def test_filtfilt(self, rng):
        x = rng.standard_normal((2, 1024)).astype(np.float32)
        b, a = scipy_signal.butter(4, 0.2)
        want = scipy_signal.filtfilt(b, a, x.astype(np.float64), axis=-1)
        got = np.asarray(jax.jit(lambda v: sp.filtfilt(b, a, v))(x))
        assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 5e-4

    def test_sosfiltfilt(self, rng):
        x = rng.standard_normal((2, 1024)).astype(np.float32)
        sos = scipy_signal.ellip(8, 0.5, 60, [0.2, 0.6], "bandpass", output="sos")
        want = scipy_signal.sosfiltfilt(sos, x.astype(np.float64), axis=-1)
        got = np.asarray(jax.jit(lambda v: sp.sosfiltfilt(sos, v))(x))
        assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 1e-4

    def test_axis(self, rng):
        x = rng.standard_normal((512, 3)).astype(np.float32)
        sos = scipy_signal.butter(4, 0.3, output="sos")
        want = scipy_signal.sosfilt(sos, x.astype(np.float64), axis=0)
        got = np.asarray(sp.sosfilt(sos, x, axis=0))
        assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 1e-5

    def test_grad_flows(self, rng):
        # the scan is differentiable end to end (design constants are static)
        x = rng.standard_normal(256).astype(np.float32)
        sos = scipy_signal.butter(2, 0.3, output="sos")
        g = jax.grad(lambda v: jnp.sum(sp.sosfilt(sos, v) ** 2))(jnp.asarray(x))
        assert np.all(np.isfinite(np.asarray(g)))

    def test_errors(self):
        with pytest.raises(ValueError):
            sp.lfilter([1.0], [0.0, 1.0], np.zeros(8))  # a[0] == 0
        with pytest.raises(ValueError):
            sp.lfilter(np.ones(40), np.ones(40), np.zeros(128))  # order > 32
        with pytest.raises(ValueError):
            sp.filtfilt([1.0, 0.5], [1.0, -0.5], np.zeros(4))  # padlen >= n
        with pytest.raises(ValueError):
            sp.sosfilt(np.zeros((2, 5)), np.zeros(16))  # bad sos shape

    def test_sosfreqz(self):
        sos = scipy_signal.butter(6, 0.2, output="sos")
        w1, h1 = sp.sosfreqz(sos, worN=129)
        w2, h2 = scipy_signal.sosfreqz(sos, worN=129)
        assert np.max(np.abs(w1 - w2)) < 1e-12
        assert np.max(np.abs(np.asarray(h1) - h2)) < 1e-4

    def test_freqs(self):
        b, a = scipy_signal.butter(4, 10.0, analog=True)
        w = np.logspace(0, 2, 64)
        _, h1 = sp.freqs(b, a, worN=w)
        _, h2 = scipy_signal.freqs(b, a, worN=w)
        assert np.max(np.abs(h1 - h2)) < 1e-10

    def test_decimate_iir(self, rng):
        x = rng.standard_normal((2, 512)).astype(np.float32)
        got = np.asarray(sp.decimate(x, 4, ftype="iir"))
        want = scipy_signal.decimate(x.astype(np.float64), 4, ftype="iir", axis=-1)
        assert got.shape == want.shape
        assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 1e-3


def test_recurrence_scan_matmuls_are_highest_precision():
    """Regression: default-precision matmuls in the associative-scan
    combine may take reduced-precision operand passes (bf16, or TF32 on
    GPU tensor cores) whose error COMPOUNDS over the log2(n) levels —
    butter6 sosfilt at n=65536 reached 8.9e-3 rel err vs scipy with bf16
    operands, 3.1e-7 with HIGHEST.  CPU can't reproduce the drift, so guard
    the lowering instead: every dot_general in the jitted program must
    carry HIGHEST."""
    import re

    import jax

    sos = sp.butter(6, 0.2, output="sos")
    x = np.zeros((2, 256), np.float32)
    txt = jax.jit(lambda a: sp.sosfilt(sos, a)).lower(x).as_text()
    dots = re.findall(r"dot_general.*", txt)
    assert dots, "expected dot_general ops in the scan lowering"
    bad = [d for d in dots if "HIGHEST" not in d]
    assert not bad, f"{len(bad)} dot ops without HIGHEST: {bad[0][:200]}"
