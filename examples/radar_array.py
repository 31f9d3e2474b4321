"""Sensor-array radar walkthrough: channelize → beamform → detect.

The round-4 RF/array subsystems end-to-end, each stage printing a checked
invariant:

1. an 8-element half-wavelength ULA receives two pulse-Doppler targets
   plus a strong off-axis jammer;
2. PFB channelizer isolates the radar subband (and the exact inverse
   channelizer round-trips the data to fp32 round-off);
3. MVDR beamforming nulls the jammer while keeping unit gain on the look
   direction;
4. pulse compression + Doppler FFT form the range-Doppler map;
5. 2-D CA-CFAR pulls both targets out of the noise.

Run: python examples/radar_array.py      (default JAX backend; small shapes)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import mixed_radix_fast_fourier_transform_tpu as sp

rng = np.random.default_rng(7)

# --- scene: 8-element ULA, 32-pulse CPI, two targets + one jammer --------
n_el, n_pulses, n_rng, n_tx = 8, 32, 512, 64
t = np.arange(n_tx)
tx = np.exp(1j * np.pi * 0.6 / n_tx * (t - n_tx / 2) ** 2)  # LFM pulse
targets = [  # (angle°, range bin, Doppler bin, amplitude)
    (-25.0, 140, 6, 1.0),
    (10.0, 330, -4, 0.6),
]
jam_angle = 40.0

m = np.arange(n_pulses)[:, None]
rx = 0.25 * (rng.standard_normal((n_el, n_pulses, n_rng))
             + 1j * rng.standard_normal((n_el, n_pulses, n_rng)))
for ang, d0, fd, amp in targets:
    a = sp.steering_vector(n_el, ang)[:, 0]
    echo = amp * tx * np.exp(2j * np.pi * fd * m / n_pulses)
    rx[:, :, d0:d0 + n_tx] += a[:, None, None] * echo
aj = sp.steering_vector(n_el, jam_angle)[:, 0]
jam = 5.0 * (rng.standard_normal((n_pulses, n_rng))
             + 1j * rng.standard_normal((n_pulses, n_rng)))
rx += aj[:, None, None] * jam
rx = rx.astype(np.complex64)

# --- 1. PFB channelizer round trip (transport-layer integrity) -----------
K, P = 16, 8
flat = rx.reshape(n_el, -1)
Y = sp.pfb_analysis(flat, K, P, mode="full")
back = np.asarray(sp.pfb_synthesis(Y, P))
pfb_err = np.max(np.abs(back - flat))
print(f"1. PFB channelize+invert: {Y.shape[-2]} frames x {K} channels, "
      f"round-trip err {pfb_err:.2e}")
assert pfb_err < 1e-3

# --- 2. MVDR beamforming: null the jammer, keep the look direction -------
snap = rx.reshape(n_el, -1)  # element x (pulse*range) snapshots
R = sp.spatial_covariance(snap, forward_backward=True)
for ang, d0, fd, amp in targets[:1]:
    w = np.asarray(sp.mvdr_weights(R, n_el, ang, diagonal_loading=1e-4))
    g_look = abs(np.vdot(w, sp.steering_vector(n_el, ang)[:, 0]))
    g_jam = abs(np.vdot(w, aj))
    print(f"2. MVDR @ {ang:+.0f}°: look gain {g_look:.4f}, "
          f"jammer gain {g_jam:.2e} ({20*np.log10(g_jam):.0f} dB)")
    assert abs(g_look - 1.0) < 1e-3 and g_jam < 0.02

# --- 3+4. beamform the CPI and form the range-Doppler map ----------------
w0 = np.asarray(sp.mvdr_weights(R, n_el, targets[0][0],
                                diagonal_loading=1e-4))
beam = np.einsum("i,ipr->pr", w0.conj(), rx)
RD = np.asarray(sp.range_doppler(beam.astype(np.complex64),
                                 tx.astype(np.complex64),
                                 window="hamming"))
P_map = np.abs(RD) ** 2
pk = np.unravel_index(np.argmax(P_map), P_map.shape)
want = (n_pulses // 2 + targets[0][2], targets[0][1])
print(f"3. range-Doppler peak at (doppler,range)={pk}, expected {want}")
assert pk == want

# --- 5. CFAR detection ----------------------------------------------------
det, _ = sp.cfar(P_map.astype(np.float32), num_train=6, num_guard=2,
                 pfa=1e-4, axes=(-2, -1))
det = np.asarray(det)
print(f"4. CA-CFAR: {det.sum()} detections, "
      f"target cell detected = {bool(det[want])}")
assert det[want]

# the second target sits off the beam's look direction but survives the
# beamformer's distortionless response enough to detect too
w1 = np.asarray(sp.mvdr_weights(R, n_el, targets[1][0],
                                diagonal_loading=1e-4))
beam1 = np.einsum("i,ipr->pr", w1.conj(), rx)
RD1 = np.asarray(sp.range_doppler(beam1.astype(np.complex64),
                                  tx.astype(np.complex64),
                                  window="hamming"))
P1 = np.abs(RD1) ** 2
det1, _ = sp.cfar(P1.astype(np.float32), num_train=6, num_guard=2,
                  pfa=1e-4, axes=(-2, -1))
want1 = (n_pulses // 2 + targets[1][2], targets[1][1])
print(f"5. second beam: target 2 detected = "
      f"{bool(np.asarray(det1)[want1])}")
assert np.asarray(det1)[want1]

print("radar_array: all stages verified")
