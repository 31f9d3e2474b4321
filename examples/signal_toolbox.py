"""Signal-processing toolbox walkthrough: the scipy.signal-class workflow.

A realistic chain a DSP user would run end-to-end, exercising the round-4
subsystems: spec-driven IIR design → zero-phase filtering → ShortTimeFFT
spectrogram → wavelet denoising → empirical mode decomposition →
quadratic-phase-coupling detection via the bicoherence → LTI system
simulation and pole placement.

Run: python examples/signal_toolbox.py      (default JAX backend; small shapes)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import mixed_radix_fast_fourier_transform_tpu as sp

rng = np.random.default_rng(0)
fs = 8000.0
t = np.arange(int(2.0 * fs)) / fs

# --- a messy measurement: speech-band tone + mains hum + wideband noise ----
signal = (np.sin(2 * np.pi * 440.0 * t)
          + 0.8 * np.sin(2 * np.pi * 50.0 * t)          # mains hum
          + 0.3 * rng.standard_normal(len(t))).astype(np.float32)

# --- 1. design a hum notch + band-stop from a spec, apply zero-phase ------
n, wn = sp.buttord([30 / (fs / 2), 80 / (fs / 2)],
                   [45 / (fs / 2), 60 / (fs / 2)], 3, 30)
sos = sp.butter(n, wn, btype="bandstop", output="sos")
clean = np.asarray(sp.sosfiltfilt(sos, signal))
hum_power = lambda x: float(np.abs(sp.goertzel(x, 50.0, fs=fs)))
print(f"[filter] band-stop order {n}; 50 Hz power "
      f"{hum_power(signal):.1f} -> {hum_power(clean):.1f}")

# --- 2. ShortTimeFFT spectrogram of the cleaned signal --------------------
import scipy.signal as ss  # window construction only

SFT = sp.ShortTimeFFT(ss.windows.hann(256, sym=False), hop=64, fs=fs,
                      scale_to="magnitude")
S = SFT.spectrogram(clean)
peak_bin = int(np.asarray(S).mean(axis=-1).argmax())
print(f"[stft] spectrogram {S.shape}, dominant ridge at "
      f"{SFT.f[peak_bin]:.0f} Hz (expect 440)")

# --- 3. wavelet denoising takes out the wideband noise --------------------
denoised = np.asarray(sp.wavelet_denoise(clean, "db4", method="bayes"))
tone = np.sin(2 * np.pi * 440.0 * t)
snr = lambda y: 10 * np.log10(float(np.sum(tone**2)
                                    / np.sum((y - tone) ** 2)))
print(f"[wavelet] SNR vs the 440 Hz tone: {snr(clean):.1f} -> "
      f"{snr(denoised):.1f} dB")

# --- 4. EMD splits residual trends from oscillations ----------------------
imfs, amp, freq = sp.hilbert_huang(denoised[: 4096], fs=fs)
f_med = float(np.median(np.asarray(freq)[0][256:-256]))
print(f"[emd] {imfs.shape[0] - 1} IMFs + residue; IMF-1 instantaneous "
      f"frequency ~{f_med:.0f} Hz")

# --- 5. nonlinearity check: bicoherence of a quadratically coupled triad --
k = np.arange(256 * 32)
coupled = np.zeros(len(k), np.float32)
for s in range(0, len(k), 256):
    p1, p2 = rng.uniform(0, 2 * np.pi, 2)
    kk = np.arange(256)
    coupled[s:s + 256] = (np.cos(2 * np.pi * 24 / 128 * kk + p1)
                          + np.cos(2 * np.pi * 8 / 128 * kk + p2)
                          + np.cos(2 * np.pi * 32 / 128 * kk + p1 + p2))
b2 = float(np.asarray(sp.bicoherence(coupled, nperseg=128))[24, 8])
print(f"[hos] bicoherence at the coupled pair: {b2:.2f} (≈1 = quadratic "
      "phase coupling)")

# --- 6. LTI: place poles on a double integrator, verify the step ----------
A = np.array([[0.0, 1.0], [0.0, 0.0]])
B = np.array([[0.0], [1.0]])
res = sp.place_poles(A, B, [-2.0, -3.0])
K = res.gain_matrix
cl = sp.StateSpace(A - B @ K, B, np.array([[1.0, 0.0]]), np.array([[0.0]]))
t_out, y = cl.step(T=np.linspace(0, 4, 120))
print(f"[lti] closed-loop poles {np.round(res.computed_poles.real, 2)}, "
      f"step settles to {float(np.asarray(y)[-1]):.3f} (expect 1/6)")

# --- 7. super-resolution: two tones one FFT bin apart ---------------------
kk = np.arange(512)
two = (np.cos(2 * np.pi * 0.102 * kk) + 0.8 * np.cos(2 * np.pi * 0.118 * kk)
       + 0.05 * rng.standard_normal(512))
f_est = sp.root_music(two, p=4, m=32)
print(f"[subspace] root-MUSIC resolves {np.sort(f_est[f_est > 0])} "
      "(0.016 apart — under the 32-tap window's FFT limit)")

# --- 8. parallel-in-time Kalman smoothing of a noisy track ----------------
F = np.array([[1.0, 1.0], [0.0, 1.0]])
Qk, Hk, Rk = 0.01 * np.eye(2), np.array([[1.0, 0.0]]), np.array([[0.25]])
truth = np.cumsum(0.05 * rng.standard_normal(256))
meas = (truth + 0.5 * rng.standard_normal(256))[:, None].astype(np.float32)
sm, _ = sp.kalman_smoother(F, Qk, Hk, Rk, np.zeros(2), np.eye(2), meas)
mse = lambda y: float(np.mean((np.asarray(y) - truth) ** 2))
print(f"[kalman] track MSE: raw {mse(meas[:, 0]):.3f} -> smoothed "
      f"{mse(np.asarray(sm)[:, 0]):.3f} (log-depth associative scans)")

# --- 9. adaptive decompositions: EMD vs VMD vs EWT on the same mixture ---
kk2 = np.arange(2048)
mix = (np.cos(2 * np.pi * 0.04 * kk2)
       + 0.7 * np.cos(2 * np.pi * 0.17 * kk2)).astype(np.float32)
imfs = sp.emd(mix, max_imf=3)
vm, vfreq = sp.vmd(mix, K=2)
ew, ebound = sp.ewt(mix, n_bands=2)
print(f"[adaptive] EMD {imfs.shape[0] - 1} IMFs; VMD centers "
      f"{np.round(np.asarray(vfreq), 3)}; EWT boundary {ebound[0]:.3f} "
      "(truth: tones at 0.040/0.170)")

print("signal_toolbox demo complete.")
