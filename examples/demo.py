"""End-to-end demo harness.

The working version of the reference's commented-out `main`
(/root/reference/src/real.c:269-482): generate sine signals, run complex and
real transforms forward and back, check MSE < 1e-10 — except this one runs,
covers the lengths the reference crashes or is silently wrong on
(SURVEY.md §2.9), and demos the capabilities the reference lacks (batching, autodiff,
mesh sharding) on whatever devices are present.

Run: python examples/demo.py
"""

import os
import sys

import numpy as np
import jax

# runnable without installation: `python examples/demo.py` puts examples/ on
# sys.path, not the repo root
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import mixed_radix_fast_fourier_transform_tpu as sp  # noqa: E402
from mixed_radix_fast_fourier_transform_tpu import compat  # noqa: E402


def demo_complex(sizes=(4, 8, 15, 20, 64, 13, 257, 360, 1024, 5040)):
    """Complex round trips (reference demo part 1, src/real.c:286-344 —
    its size list {4,8,15,20,64} plus the sizes that break the reference)."""
    print("== complex FFT round trips ==")
    for n in sizes:
        x = compat.generate_signal(n)
        spec = sp.fft(x)
        back = sp.ifft(spec)
        mse = compat.compute_mse(np.asarray(back), x)
        status = "ok" if mse < 1e-10 else "FAIL"
        print(f"  N={n:5d}: round-trip MSE {mse:.3e}  [{status}]")


def demo_real(sizes=(4, 8, 16, 32, 64, 4096)):
    """Real transform round trips (reference demo part 2, src/real.c:360-470)."""
    print("== real FFT round trips ==")
    for n in sizes:
        x = compat.generate_real_signal(n)
        spec = sp.rfft(x)
        back = sp.irfft(spec, n=n)
        mse = compat.compute_mse_real(np.asarray(back), x)
        status = "ok" if mse < 1e-10 else "FAIL"
        print(f"  N={n:5d}: round-trip MSE {mse:.3e}  [{status}]")


def demo_convolution():
    print("== FFT convolution vs direct ==")
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal(100), rng.standard_normal(31)
    for mode in ("full", "same", "valid"):
        got = np.asarray(sp.fft_convolve(a, b, mode=mode))
        want = np.convolve(a, b, mode=mode)
        print(f"  mode={mode:7s}: max err {np.max(np.abs(got - want)):.3e}")


def demo_batched_and_grad():
    print("== extensions beyond the reference ==")
    x = np.random.default_rng(1).standard_normal((32, 1024)).astype(np.float32)
    spec = sp.rfft(x)  # one batched matmul pipeline
    print(f"  batched rfft: {x.shape} -> {spec.shape}")
    g = jax.grad(lambda v: float(1.0) * jax.numpy.abs(sp.fft(v)).sum())(
        jax.numpy.asarray(x[0], dtype=jax.numpy.float32)
    )
    print(f"  grad through fft: shape {g.shape}, finite={bool(np.all(np.isfinite(g)))}")


def demo_sharded():
    devs = jax.devices()
    if len(devs) < 2:
        print(f"== sharded transform: skipped ({len(devs)} device) ==")
        return
    from mixed_radix_fast_fourier_transform_tpu.parallel import fft_four_step, make_mesh

    mesh = make_mesh((1, len(devs)))
    x = np.random.default_rng(2).standard_normal(4096).astype(np.float32)
    got = np.asarray(fft_four_step(x, mesh))
    err = np.max(np.abs(got - np.fft.fft(x))) / np.max(np.abs(np.fft.fft(x)))
    print(f"== sharded four-step over {len(devs)} devices: rel err {err:.3e} ==")
    from mixed_radix_fast_fourier_transform_tpu.parallel import sht_sharded

    L = 16 * ((len(devs) + 15) // 16) if len(devs) > 16 else 16
    f = np.random.default_rng(3).standard_normal((L, 2 * L)).astype(np.float32)
    a = np.asarray(sht_sharded(f, mesh, "seq"))
    want = np.asarray(sp.sht(f))
    serr = np.max(np.abs(a - want)) / max(1.0, np.abs(want).max())
    print(f"   latitude-sharded SHT (one psum): rel err {serr:.3e}")


def demo_lapped_and_wavelets():
    print("== MDCT (TDAC) and CWT ==")
    rng = np.random.default_rng(3)
    x = rng.standard_normal(1000).astype(np.float32)
    back = np.asarray(sp.imdct(sp.mdct(x, 128), length=1000))
    print(f"  mdct/imdct perfect reconstruction: max err {np.max(np.abs(back - x)):.3e}")
    w = np.asarray(sp.cwt(x[:256], sp.ricker, [2, 8, 32]))
    print(f"  cwt scalogram: {w.shape} (3 scales, one batched FFT convolution)")


def demo_nufft():
    print("== non-uniform FFT ==")
    rng = np.random.default_rng(4)
    m, n = 200, 64
    x = rng.uniform(0, 2 * np.pi, m).astype(np.float32)
    c = (rng.standard_normal(m) + 1j * rng.standard_normal(m)).astype(np.complex64)
    f = np.asarray(sp.nufft1(x, c, n))
    k = np.arange(-(n // 2), (n + 1) // 2)
    want = np.exp(-1j * np.outer(k, x.astype(np.float64))) @ c.astype(np.complex128)
    rel = np.max(np.abs(f - want)) / np.max(np.abs(want))
    print(f"  type 1, {m} points -> {n} modes: rel err {rel:.3e}")
    back = np.asarray(sp.nufft2(x, f.astype(np.complex64)))
    print(f"  type 2 back to points: shape {back.shape}")


def demo_sphere():
    print("== spherical harmonics ==")
    rng = np.random.default_rng(5)
    L = 16
    f = rng.standard_normal((L, 2 * L)).astype(np.float32)
    a = sp.sht(f)
    back = np.real(np.asarray(sp.isht(np.asarray(a))))
    # analysis->synthesis projects onto the band-limited subspace; verify the
    # projection is idempotent (the fixed point of the transform pair)
    twice = np.real(np.asarray(sp.isht(np.asarray(sp.sht(back)))))
    print(f"  sht/isht projection idempotent: max err {np.max(np.abs(twice - back)):.3e}")
    ut, up = sp.sphere_grad(back)
    div = np.asarray(sp.sphere_div(ut, up))
    lap = np.asarray(sp.sphere_laplacian(back))
    print(f"  div(grad f) == laplacian f: max err {np.max(np.abs(div - lap)):.3e}")


def demo_chebyshev():
    print("== Chebyshev spectral derivative (non-periodic) ==")
    n = 64
    pts = sp.cheb_points(n, dtype=np.float64)
    v = np.exp(pts).astype(np.float32)
    d = np.asarray(sp.cheb_diff(v))
    rel = np.max(np.abs(d - np.exp(pts))) / np.e
    print(f"  d/dx exp(x) on {n} Gauss-Lobatto points: rel err {rel:.3e}")


def demo_dwt_denoise():
    """Biorthogonal DWT + stationary-transform soft-threshold denoising."""
    print("== wavelet denoising (bior4.4 swt, symmetric dwt) ==")
    rng = np.random.default_rng(0)
    t = np.linspace(0, 1, 256, endpoint=False)
    clean = np.sin(2 * np.pi * 5 * t) + 0.5 * np.sign(np.sin(2 * np.pi * 2 * t))
    noisy = (clean + 0.3 * rng.standard_normal(256)).astype(np.float32)
    coeffs = sp.swt(noisy, "bior4.4", level=3)
    thr = 3 * 0.3 / np.sqrt(2)
    den = [(a, np.sign(d) * np.maximum(np.abs(np.asarray(d)) - thr, 0))
           for a, d in coeffs]
    rec = np.asarray(sp.iswt(den, "bior4.4"))
    snr_in = 10 * np.log10(np.mean(clean**2) / np.mean((noisy - clean) ** 2))
    snr_out = 10 * np.log10(np.mean(clean**2) / np.mean((rec - clean) ** 2))
    print(f"  swt soft-threshold: SNR {snr_in:.1f} dB -> {snr_out:.1f} dB")
    a, d = sp.dwt(noisy, "db4", "symmetric")
    back = np.asarray(sp.idwt(a, d, "db4", "symmetric"))[:256]
    print(f"  symmetric-mode dwt round trip: max err "
          f"{np.max(np.abs(back - noisy)):.3e}")


def demo_dtcwt_frft():
    """Dual-tree complex wavelets (shift-invariant magnitudes) and the
    fractional Fourier transform (chirp compression at its matched order)."""
    print("== dual-tree complex wavelets and fractional Fourier ==")
    x = np.zeros(256, np.float32)
    x[100] = 1.0
    _, y1 = sp.dtcwt(x, levels=3)
    _, y2 = sp.dtcwt(np.roll(x, 1), levels=3)
    e1 = float(np.sum(np.abs(np.asarray(y1[0])) ** 2))
    e2 = float(np.sum(np.abs(np.asarray(y2[0])) ** 2))
    print(f"  dtcwt level-1 energy under 1-sample shift: ratio "
          f"{min(e1, e2) / max(e1, e2):.6f} (plain DWT scrambles)")
    # a linear chirp concentrates under the FrFT order matching its sweep:
    # phase pi*r*u^2 rotates to a spike at alpha = arccot(-r)
    n = 256
    u = (np.arange(n) - n // 2) / np.sqrt(n)
    r = 1.0
    sig = (np.exp(-np.pi * (u / 3) ** 2) * np.cos(np.pi * r * u * u)).astype(
        np.float32
    )
    conc = []
    for a in (1.0, 1.5):
        y = np.abs(np.asarray(sp.frft(sig, a)))
        conc.append(float(y.max() / np.linalg.norm(y)))
    print(f"  chirp peak concentration |F_a x|: a=1.0 {conc[0]:.3f} vs "
          f"matched a=1.5 {conc[1]:.3f}")


def demo_estimation_rotation():
    """Round-3 additions: constant-Q analysis, multitaper PSD of a noisy
    tone, Lomb-Scargle on irregular samples, and Wigner-D rotation moving a
    spherical bump to a prescribed center."""
    print("== spectral estimation + rotation ==")
    rng = np.random.default_rng(7)
    fs = 8000.0
    freqs = sp.cqt_frequencies(48, 55.0, 12)
    tone = np.cos(2 * np.pi * freqs[30] * np.arange(8192) / fs).astype(np.float32)
    C = np.abs(np.asarray(sp.cqt(tone, fs=fs, fmin=55.0, n_bins=48, hop=512)))
    print(f"  cqt: {freqs[30]:.1f} Hz tone peaks at band "
          f"{int(C[C.shape[0] // 2].argmax())} (expect 30)")
    n = 2048
    x = np.sin(2 * np.pi * 12.5 * np.arange(n) / 100.0) + rng.standard_normal(n)
    f, P = sp.multitaper(x.astype(np.float32), fs=100.0, nw=4.0)
    f, P = np.asarray(f), np.asarray(P)
    print(f"  multitaper: noisy 12.5 Hz tone -> PSD peak at {f[P.argmax()]:.2f} Hz")
    t = np.sort(rng.uniform(0, 20, 300))
    y = np.sin(3.3 * t) + 0.3 * rng.standard_normal(t.size)
    w = np.linspace(0.5, 10, 256)
    pg = np.asarray(sp.lombscargle(t.astype(np.float32), y.astype(np.float32),
                                   w.astype(np.float32)))
    print(f"  lombscargle: irregular 3.3 rad/s tone -> peak at "
          f"{w[pg.argmax()]:.2f} rad/s")
    L = 24
    zon = np.zeros((2 * L - 1, L), np.complex64)
    zon[0, :] = np.exp(-0.05 * np.arange(L) * (np.arange(L) + 1))  # smooth bump at the pole
    beta, alpha = 1.1, 0.7
    fgrid = np.real(np.asarray(sp.isht(np.asarray(
        sp.rotate_sht(zon, alpha, beta, 0.0)).astype(np.complex64))))
    theta, phi, _ = sp.sht_grid(L - 1)
    i, j = np.unravel_index(np.argmax(fgrid), fgrid.shape)
    print(f"  rotate_sht: polar bump moved to (theta, phi) = "
          f"({theta[i]:.2f}, {phi[j]:.2f}) — prescribed ({beta:.2f}, {alpha:.2f})")


def demo_audio_toolbox():
    """Late-round-3 audio/TFR suite: generators, vocoder, separation,
    pitch, features, S-transform, equiripple design."""
    print("audio toolbox:")
    rng = np.random.default_rng(9)
    fs = 8000.0
    t = np.arange(16384) / fs
    x = np.asarray(sp.chirp(t, 200.0, t[-1], 1200.0))  # swept tone
    S, freqs = sp.stockwell(np.asarray(x)[:1024].astype(np.float32))
    xrec = np.asarray(sp.istockwell(S))
    print(f"  stockwell: lossless inverse err "
          f"{np.max(np.abs(xrec - np.asarray(x)[:1024])):.2e}")
    y = np.asarray(sp.pitch_shift(np.asarray(x).astype(np.float32), fs, 12.0,
                                  nperseg=1024))
    f_in = np.asarray(sp.yin(np.asarray(x).astype(np.float32), 100, 3000, fs,
                             frame_length=1024))
    f_out = np.asarray(sp.yin(y, 100, 3500, fs, frame_length=1024))
    mid = slice(len(f_in) // 3, 2 * len(f_in) // 3)
    print(f"  pitch_shift +12 semitones: yin ratio "
          f"{np.median(f_out[mid] / f_in[mid]):.3f} (expect 2.0)")
    mix = (np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    mix[1000::2000] += 2.5
    Sm = sp.stft(mix, nperseg=512, noverlap=384)
    H, P = sp.hpss(Sm, kernel_size=17)
    eh = float(np.sum(np.abs(np.asarray(H))**2))
    ep = float(np.sum(np.abs(np.asarray(P))**2))
    print(f"  hpss: tone+clicks split, harmonic/percussive energy "
          f"{eh / (eh + ep):.2f}/{ep / (eh + ep):.2f}")
    cen = np.asarray(sp.spectral_centroid(mix, fs, nperseg=1024))
    flat = np.asarray(sp.spectral_flatness(mix, nperseg=1024))
    print(f"  features: centroid {np.median(cen):.0f} Hz, "
          f"flatness {np.median(flat):.1e} (tone-dominated)")
    b = sp.remez(73, [0, 0.18, 0.24, 0.5], [1, 0])
    w, h = sp.freqz(b.astype(np.float32), worN=512)
    h = np.asarray(h)
    print(f"  remez 73-tap lowpass: stopband "
          f"{20 * np.log10(np.max(np.abs(h[w >= 0.49 * np.pi]))):.0f} dB")
    E, fg = sp.reassigned_spectrogram(mix[:4096], nperseg=256)
    m = np.asarray(E).shape[0] // 2
    print(f"  reassigned spectrogram: tone ridge at "
          f"{fg[int(np.argmax(np.asarray(E)[m]))] * fs:.0f} Hz (expect 440)")


def demo_mir_tomo():
    """MIR layer + tomography showcase."""
    print("MIR + tomography:")
    sr, hop = 22050.0, 512
    t = np.arange(22050 * 4) / sr
    x = np.zeros(t.size, np.float32)
    x[:: int(0.5 * sr)] = 1.0  # 120 BPM clicks
    x += 0.3 * np.asarray(sp.chirp(t, 200.0, t[-1], 400.0)).astype(np.float32)
    bpm, beats = sp.beat_track(x, sr, hop=hop)
    print(f"  beat_track: {float(np.asarray(bpm)):.1f} BPM, "
          f"{int(np.asarray(beats).sum())} beats on a 120 BPM click bed")
    tri = sum(np.sin(2 * np.pi * f * t) for f in (261.63, 329.63, 392.0))
    C = np.asarray(sp.chroma_stft(tri.astype(np.float32), sr, nperseg=4096))
    names = np.array(list("C.D.EF.G.A.B"))
    top = sorted(np.argsort(C[4:-4].mean(0))[-3:])
    print(f"  chroma: C-major triad lights {'/'.join(names[top])} "
          f"(bins {top})")
    melody = np.sin(2 * np.pi * 220.0 * t[:44100]).astype(np.float32)
    f0, voiced, _ = sp.pyin(melody, 110.0, 880.0, sr)
    f0m = float(np.nanmedian(np.asarray(f0)))
    print(f"  pyin: 220 Hz tone tracked at {f0m:.1f} Hz, "
          f"{float(np.asarray(voiced).mean()):.0%} voiced")
    n = 96
    yy, xx = np.mgrid[:n, :n].astype(np.float64) - n // 2
    phantom = (((xx - 8) ** 2 + (yy + 5) ** 2) <= 15 ** 2).astype(np.float32)
    theta = np.linspace(0, np.pi, 90, endpoint=False)
    rec = np.asarray(sp.iradon(sp.radon(phantom, theta), theta,
                               filter_name="hann"))
    corr = np.corrcoef(rec.ravel(), phantom.ravel())[0, 1]
    print(f"  radon/iradon: 90-view FBP of a disk phantom, corr {corr:.3f}")


if __name__ == "__main__":
    demo_complex()
    demo_real()
    demo_convolution()
    demo_batched_and_grad()
    demo_lapped_and_wavelets()
    demo_nufft()
    demo_sphere()
    demo_chebyshev()
    demo_dwt_denoise()
    demo_dtcwt_frft()
    demo_estimation_rotation()
    demo_audio_toolbox()
    demo_mir_tomo()
    demo_sharded()
