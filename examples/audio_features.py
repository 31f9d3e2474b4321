"""Audio feature pipeline on the engine: CQT, mel/MFCC, multitaper PSD,
and Griffin-Lim resynthesis from a mel-free magnitude.

Run: python examples/audio_features.py   (default JAX backend)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import mixed_radix_fast_fourier_transform_tpu as sp  # noqa: E402


def main():
    fs = 22050.0
    t = np.arange(int(2 * fs)) / fs
    # two-note "melody" with vibrato + noise floor
    sig = (
        np.sin(2 * np.pi * 440 * t + 3 * np.sin(2 * np.pi * 5 * t))
        * (t < 1.0)
        + 0.7 * np.sin(2 * np.pi * 660 * t) * (t >= 1.0)
        + 0.02 * np.random.default_rng(0).standard_normal(t.size)
    ).astype(np.float32)

    C = np.abs(np.asarray(sp.cqt(sig, fs=fs, fmin=55.0, n_bins=60, hop=1024)))
    freqs = sp.cqt_frequencies(60, 55.0, 12)
    first, second = C[: C.shape[0] // 2], C[C.shape[0] // 2 :]
    print(f"cqt: first half peaks at {freqs[first.mean(0).argmax()]:.1f} Hz "
          f"(A4=440), second at {freqs[second.mean(0).argmax()]:.1f} Hz (E5=660)")

    M = np.asarray(sp.melspectrogram(sig, fs, n_mels=64))
    F = np.asarray(sp.mfcc(sig, fs, n_mfcc=13))
    print(f"melspectrogram {M.shape}, mfcc {F.shape}")

    f, P = sp.multitaper(sig, fs=fs, nw=4.0)
    f, P = np.asarray(f), np.asarray(P)
    print(f"multitaper PSD peak at {f[P.argmax()]:.1f} Hz")

    S = np.abs(np.asarray(sp.stft(sig, nperseg=512)))
    y = np.asarray(sp.griffinlim(S, n_iter=32, nperseg=512, length=sig.size))
    Sy = np.abs(np.asarray(sp.stft(y, nperseg=512)))
    sc = float(np.linalg.norm(Sy - S) / np.linalg.norm(S))
    print(f"griffinlim resynthesis spectral convergence: {sc:.3f}")

    # synchrosqueezing pins each note to a single log-frequency ridge
    dec = sig[::4][:8192]  # fs/4 working rate
    Sq, freqs = sp.ssq_cwt(dec, n_scales=96, fmin=0.002, fmax=0.45)
    mag = np.abs(np.asarray(Sq))
    half = mag.shape[-1] // 2
    k1 = int(mag[:, 400:half - 400].mean(-1).argmax())
    k2 = int(mag[:, half + 400:-400].mean(-1).argmax())
    print(f"ssq_cwt note ridges: {freqs[k1] * fs / 4:.1f} Hz then "
          f"{freqs[k2] * fs / 4:.1f} Hz (440 / 660 expected)")


if __name__ == "__main__":
    main()
